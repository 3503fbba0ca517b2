"""The hybrid, encoder-decoder and vision families on the card: the flash
kernel at hymba's attention shape, RMSNorm with a bf16 scale (the serving
launcher's bf16 weights) and ``launch.serve`` at reduced size.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package:

    python -m pytest -q --noconftest -m cuda tests/test_torch_families_cuda.py

Tolerances: bf16 kernel outputs against their plain versions at 2e-2 (as
``test_torch_kernels_cuda.py``); the launcher's logits on the card against
the same weights on the CPU at 2e-2 of the logit scale (bf16 activations,
the RMSNorm kernel against its plain version, cuBLAS against the CPU's
GEMMs).
"""
import copy

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.launch import serve

TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2048, 1500, 700])
def test_flash_at_hymba_attention_shape(card, S):
    """H 25, Hkv 5 (groups of 5), hd 64, bf16, causal, window 1024: the
    window binds past 1024 tokens; 1500 and 700 are ragged."""
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((2, S, n, 64), generator=g, device=card).to(
        torch.bfloat16) for n in (25, 5, 5))
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, window=1024)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    want = attention_ref(q.float(), k.float(), v.float(), window=1024)
    torch.testing.assert_close(got.float(), want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 1600), (2, 1600), (2048, 8192)],
                         ids=str)
def test_rmsnorm_takes_a_bf16_scale(card, shape):
    """A bf16 scale gives exactly what its float32 cast gives, one counted
    launch, and agrees with the plain version."""
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
    scale = (torch.randn(shape[-1], generator=g, device=card) * 0.1
             + 1).to(torch.bfloat16)
    before = rms_ops.launches
    got = rms_ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rms_ops.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, rms_ops.rmsnorm(x, scale.float()))
    torch.testing.assert_close(got.float(), rmsnorm_ref(x.float(), scale),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba_1_5b", "seamless_m4t_medium",
                                  "internvl2_76b"])
def test_launcher_on_card_matches_cpu(card, arch):
    cfg = get_config(arch, reduced=True)
    B, S, new = 2, 32, 4
    before = rms_ops.launches
    out = serve.generate(cfg, batch=B, prompt_len=S, new_tokens=new,
                         device=card)
    torch.cuda.synchronize()
    launched = rms_ops.launches - before
    norms = 2 * cfg.n_layers + 1 if cfg.norm == "rmsnorm" else 0
    assert launched == norms * new
    assert out["tokens"].shape == (B, new)
    assert all(p.dtype == torch.bfloat16 for p in out["model"].parameters())
    host = serve.generate(cfg, batch=B, prompt_len=S, new_tokens=1,
                          device="cpu",
                          model=copy.deepcopy(out["model"]).cpu())
    got, want = out["logits"][0].cpu(), host["logits"][0]
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 2e-2 * float(want.abs().max()), err
