"""Each plain reference agrees with ``repro_torch`` on the CPU: its parts
in float32 against the port's own plain versions, and the whole model at a
tiny width against the port's bfloat16 forward passes."""
import pytest
import torch

from conftest import MODELS, tiny_cell
from perfbench import harness, weights
from perfbench.reference import hymba as ref_hymba
from perfbench.reference import rwkv6 as ref_rwkv6
from perfbench.reference.common import f32_mm

CELLS = [w["name"] for w in MODELS["workloads"]]


def test_wkv_matches_the_ports_plain_recurrence():
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    g = torch.Generator().manual_seed(0)
    n, T, H, hd = 2, 300, 3, 8          # T over one block of steps
    r, k, v = (torch.randn(n, T, H * hd, generator=g) for _ in range(3))
    w = torch.rand(n, T, H * hd, generator=g) * 0.5 + 0.45
    u = torch.randn(H, hd, generator=g)
    ours = ref_rwkv6.wkv(r, k, v, w, u, H)

    def bh(t):
        return t.reshape(n, T, H, hd).transpose(1, 2).reshape(n * H, T, hd)
    y, _ = wkv6_ref(bh(r), bh(k), bh(v), bh(w), u.repeat(n, 1),
                    torch.zeros(n * H, hd, hd))
    theirs = y.reshape(n, H, T, hd).transpose(1, 2).reshape(n, T, H * hd)
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [0, 7, 40])
def test_window_attention_matches_the_ports_plain_attention(window):
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 1100, 6, 16, generator=g)
    k, v = (torch.randn(2, 1100, 2, 16, generator=g) for _ in range(2))
    ours = ref_hymba.window_attention(q, k, v, window or 10**9)
    theirs = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(ours, theirs.reshape(ours.shape),
                               rtol=1e-4, atol=1e-5)


def test_mamba_matches_the_ports_scan_in_float32():
    from repro_torch.models import mamba as M
    cell = tiny_cell("hymba.score_long")
    m = cell.config["model"]
    cfg = harness.arch_config(m)
    w = weights.make(ref_hymba.param_specs(m), 3, "cpu")
    blk = M.Mamba(cfg, None, "cpu")
    blk.load_state_dict({k[len("blocks.0.mamba."):]: v for k, v in w.items()
                         if k.startswith("blocks.0.mamba.")}, assign=True)
    x = torch.randn(2, 600, m["d_model"],
                    generator=torch.Generator().manual_seed(4))
    theirs, _ = M.apply_mamba_seq(cfg, blk, x,
                                  M.init_mamba_state(cfg, 2, "cpu"))
    ours = ref_hymba.mamba(lambda n: w["blocks.0.mamba." + n], x, f32_mm,
                           m["ssm"]["conv_dim"])
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 2**31 + 1])
@pytest.mark.parametrize("name", CELLS)
def test_reference_logits_agree_with_the_port(name, seed):
    """The port computes in bfloat16 with float32 masters; the reference in
    float32.  Their logits differ by bfloat16's rounding, about 2% of the
    logits' spread at this width; 6% leaves room and stays under the
    float8 control's 12%."""
    from repro_torch.models import (LM, forward_prefill, forward_train,
                                    init_cache)
    cell = tiny_cell(name)
    m = cell.config["model"]
    ref = harness.reference(cell.config["reference"])
    cfg = harness.arch_config(m)
    w = weights.make(ref.param_specs(m), seed, "cpu")
    lm = LM(cfg, torch.device("meta"))
    lm.load_state_dict(w, strict=True, assign=True)
    toks = torch.randint(0, m["vocab"], (3, 40),
                         generator=torch.Generator().manual_seed(seed % 97))
    with torch.no_grad():
        last, _ = forward_prefill(cfg, lm, {"tokens": toks},
                                  init_cache(cfg, 3, 40, "cpu"))
        every, _ = forward_train(cfg, lm, {"tokens": toks})
        h = ref.hidden(w, m, toks, f32_mm)
    ours = h @ ref.head(w, m)
    scale = ours.std()
    assert (every - ours).abs().max() / scale < 0.06
    assert (last - ours[:, -1]).abs().max() / scale < 0.06


def test_weights_repeat_for_a_seed_and_differ_between_seeds():
    specs = ref_rwkv6.param_specs(tiny_cell("rwkv6.score_long")
                                  .config["model"])
    a, b = weights.make(specs, 5, "cpu"), weights.make(specs, 5, "cpu")
    c = weights.make(specs, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.05)
    assert torch.equal(a["blocks.0.rwkv.mix_r"],
                       torch.full_like(a["blocks.0.rwkv.mix_r"], 0.5))
