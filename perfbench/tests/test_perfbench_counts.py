"""The frozen counts equal the port's own: each kernel's ``cost`` at the
shapes of the kernel table (PERF.md, Findings), and the model's products
with weights as ``launch.hlostats`` counts a prefill."""
import pytest
import torch

from conftest import MODELS, tiny_cell
from perfbench import harness, weights
from perfbench.counts import kernels, model, peaks

META = dict(device="meta")
BF16 = dict(dtype=torch.bfloat16, **META)
F32 = dict(dtype=torch.float32, **META)

# (B, S, H, Hkv, hd, window): qwen3 GQA, qwen2-moe MHA, hymba, gemma3,
# nemotron, and a reduced config's padded head dim
FLASH = [(2, 1024, 64, 8, 128, 0), (2, 1024, 16, 16, 128, 0),
         (2, 2048, 25, 5, 64, 1024), (2, 2048, 16, 8, 256, 1024),
         (2, 1024, 96, 8, 192, 0), (2, 64, 4, 1, 16, 16)]


@pytest.mark.parametrize("shape", FLASH, ids=str)
def test_flash_count(shape):
    from repro_torch.kernels.flash_attention import ops
    B, S, H, Hkv, hd, window = shape
    q = torch.empty(B, S, H, hd, **BF16)
    k = v = torch.empty(B, S, Hkv, hd, **BF16)
    o = torch.empty(B, S, H, ops.padded_head_dim(hd), **BF16)
    assert kernels.flash(B, S, S, H, Hkv, hd, True, window) == \
        ops.cost(q, k, v, True, window, 0.0, o)
    assert kernels.visible_pairs(S, S, True, window) == \
        ops.visible_pairs(S, S, True, window)


@pytest.mark.parametrize("shape", [(2048, 5120), (2048, 2048), (4096, 1600),
                                   (2048, 8192), (4, 1600)], ids=str)
def test_rmsnorm_count(shape):
    from repro_torch.kernels.rmsnorm import ops
    x = torch.empty(*shape, **BF16)
    scale = torch.empty(shape[1], **F32)
    assert kernels.rmsnorm(*shape) == ops.cost(x, scale, 1e-6,
                                               torch.empty_like(x))


@pytest.mark.parametrize("B,T,H,hd,rkv,w", [
    (2, 1024, 32, 64, torch.bfloat16, torch.float32),
    (2, 1024, 32, 64, torch.bfloat16, torch.bfloat16),
    (4, 8192, 32, 64, torch.bfloat16, torch.float32),
    (2, 1, 32, 64, torch.float32, torch.float32)], ids=str)
def test_wkv6_count(B, T, H, hd, rkv, w):
    from repro_torch.kernels.rwkv6 import ops
    r = torch.empty(B, T, H, hd, dtype=rkv, **META)
    wt = torch.empty(B, T, H, hd, dtype=w, **META)
    u = torch.empty(H, hd, **F32)
    s0 = torch.empty(B, H, hd, hd, **F32)
    size = torch.empty((), dtype=rkv).element_size()
    assert kernels.wkv6(B, T, H, hd, size,
                        torch.empty((), dtype=w).element_size()) == \
        ops.cost(r, r, r, wt, u, s0, (torch.empty_like(r),
                                      torch.empty_like(s0)))


def test_kernel_table_bounds():
    """The bounds the kernel table states: WKV6's prefill 0.0200 ms
    (operations), hymba's flash 0.0204 ms (operations), its RMSNorm 0.0078
    ms (bytes)."""
    ms = 1e3 * peaks.bound_s(*kernels.wkv6(2, 1024, 32, 64, 2, 2),
                             kernels.PEAK_FLOPS["wkv6"])
    assert ms == pytest.approx(0.0200, abs=5e-5)
    ms = 1e3 * peaks.bound_s(*kernels.flash(2, 2048, 2048, 25, 5, 64, True,
                                            1024), kernels.PEAK_FLOPS["flash"])
    assert ms == pytest.approx(0.0204, abs=5e-5)
    ms = 1e3 * peaks.bound_s(*kernels.rmsnorm(4096, 1600),
                             kernels.PEAK_FLOPS["rmsnorm"])
    assert ms == pytest.approx(0.0078, abs=5e-5)


@pytest.mark.parametrize("name", [w["name"] for w in MODELS["workloads"]])
def test_model_count_matches_the_ports_counter(name):
    """``hlostats.count_step`` of the port's prefill on the CPU counts
    every product with a weight, the head at the last position, and the
    plain versions' own products: attention over every (query, key) pair
    the plain path scores, WKV6's r·S and the scan's C·h a step.  With
    those taken out, what is left is the frozen count's weights and
    head."""
    from repro_torch.launch.hlostats import count_step
    from repro_torch.models import LM, forward_prefill, init_cache
    cell = tiny_cell(name)
    m = cell.config["model"]
    ref = harness.reference(cell.config["reference"])
    cfg = harness.arch_config(m)
    lm = LM(cfg, torch.device("meta"))
    lm.load_state_dict(weights.make(ref.param_specs(m), 0, "cpu"),
                       strict=True, assign=True)
    B, L = 2, 48
    toks = torch.zeros(B, L, dtype=torch.int32)
    stats = count_step(forward_prefill, cfg, lm, {"tokens": toks},
                       init_cache(cfg, B, L, "cpu"))
    if m["family"] == "ssm":
        hd = m["ssm"]["head_dim"]
        plain = 2 * hd * hd * (m["d_model"] // hd) * B * L * m["n_layers"]
    else:
        hd = m["head_dim"]
        inner = m["ssm"]["expand"] * m["d_model"]
        plain = m["n_layers"] * B * (4 * hd * m["n_heads"] * L * L
                                     + 2 * L * inner * m["ssm"]["state_dim"])
    assert stats.flops - plain == B * (L * model.weight_flops_per_token(m)
                                       + model.head_flops(m))
    assert model.batch_flops(m, L, B) == B * (
        L * (model.weight_flops_per_token(m)
             + model.recurrence_flops_per_token(m))
        + model.attention_flops(m, L) + model.head_flops(m))
