"""The training slice's autograd functions on the card: RMSNorm's (the
kernel's forward, the closed-form backward) and the chunked attention's
custom backward, against autograd through their plain versions at the
shapes the full-width qwen3_32b gives them in training.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package:

    python -m pytest -q --noconftest -m cuda tests/test_torch_train_cuda.py

Tolerances: bf16 RMSNorm outputs and dx rounded to bf16 (2e-2, as the
kernel tests); dscale sums its rows in another order (1e-4 of its scale);
the chunked attention in float32 to 2e-5 of each output's scale.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import attention as TA
from repro_torch.models import forward_train
from repro_torch.runtime import make_loss_fn


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 5120), (512 * 64, 128),
                                   (512 * 8, 128)], ids=str)
def test_rmsnorm_autograd_function_matches_plain_autograd(card, shape):
    g = torch.Generator(device=card).manual_seed(0)
    x0 = torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
    s0 = torch.randn(shape[-1], generator=g, device=card) * 0.1 + 1
    gy = torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
    x, s = x0.clone().requires_grad_(True), s0.clone().requires_grad_(True)
    before = rms_ops.launches
    y = rms_ops.rmsnorm(x, s)
    assert rms_ops.launches == before + 1
    y.backward(gy)
    xr, sr = x0.clone().requires_grad_(True), s0.clone().requires_grad_(True)
    yr = rmsnorm_ref(xr, sr)
    yr.backward(gy)
    torch.testing.assert_close(y, yr, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(x.grad, xr.grad, rtol=2e-2, atol=2e-2)
    _close(s.grad, sr.grad, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (1024, 0.0),
                                            (0, 30.0)])
def test_chunked_attention_backward_matches_autograd_on_card(card, window,
                                                             softcap):
    cfg = dataclasses.replace(get_config("qwen3_32b"), logit_softcap=softcap)
    g = torch.Generator(device=card).manual_seed(1)
    B, S, H, Hkv, hd = 1, 2048, 8, 2, 128
    q = torch.randn(B, S, H, hd, generator=g, device=card)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=card)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=card)
    dout = torch.randn(B, S, H * hd, generator=g, device=card)
    res = []
    for chunked in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if chunked:
            o = TA._sdpa_chunked(cfg, *leaves, causal=True, window=window)
        else:
            o = TA._sdpa(cfg, *leaves,
                         TA.causal_mask(S, S, window, device=card))
        o.backward(dout)
        res.append([o.detach()] + [t.grad for t in leaves])
    for got, want in zip(*res):
        _close(got, want, 2e-5)


@pytest.mark.cuda
def test_flash_under_grad_raises_on_card(card):
    from repro_torch.models import init_lm
    cfg = get_config("qwen3_32b", reduced=True)
    cfg = dataclasses.replace(cfg, head_dim=64)   # a head dim flash takes
    model = init_lm(cfg, torch.Generator(device=card).manual_seed(0),
                    device=card)
    model.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=card)
    with pytest.raises(RuntimeError, match="ROADMAP.md"):
        forward_train(cfg, model, {"tokens": toks}, use_flash=True)
    total, _ = make_loss_fn(cfg)(model, {"tokens": toks, "labels": toks})
    total.backward()
    assert all(p.grad is not None for p in model.parameters())
