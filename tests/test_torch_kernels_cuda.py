"""The port's flash-attention, WKV6 and RMSNorm CUDA kernels against their
plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode), carries
the ``cuda`` marker and skips without one.  The file imports neither JAX nor
the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops

# bf16: outputs rounded to bf16 (2^-8 relative), as tests/test_kernels.py.
# float32: the kernels sum in another order than the plain versions; WKV6
# sums 64-term products over a 1024-step recurrence (1e-4 absolute).
RMS_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
           torch.float32: dict(rtol=2e-5, atol=2e-5)}
WKV_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
           torch.float32: dict(rtol=2e-5, atol=1e-4)}
# flash attention: bf16 as tests/test_kernels.py (the tensor-core kernel
# also rounds P to bf16, about 2^-9 relative); float32 sums in another order.
FLASH_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
             torch.float32: dict(rtol=2e-5, atol=2e-5)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,softcap", [
    (2, 1024, 64, 8, 128, True, 0, 0.0),    # the serving shape of qwen3_32b
    (2, 77, 4, 2, 128, True, 0, 0.0),       # S under one 128-row q tile
    (1, 1000, 8, 8, 64, True, 17, 0.0),     # window under one k tile
    (1, 200, 8, 1, 256, True, 0, 0.0),      # hd 256, MQA, ragged S
    (1, 333, 8, 1, 64, True, 0, 30.0),      # softcap, MQA
    (2, 300, 4, 2, 128, False, 100, 20.0),  # non-causal window, softcap
    (1, 130, 2, 2, 256, False, 0, 0.0),     # non-causal, ragged past Sk
])
def test_flash_kernel_matches_plain(card, B, S, H, Hkv, hd, causal, window,
                                    softcap, dtype):
    g = torch.Generator(device="cpu").manual_seed(2)
    q, k, v = (torch.randn((B, S, n, hd), generator=g).to(card, dtype)
               for n in (H, Hkv, Hkv))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got.float(), want, **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_refuses_unaligned_bf16(card):
    q, k, v = (torch.randn((1, 64, n, 64), device=card).bfloat16()
               for n in (4, 2, 2))
    padded = torch.zeros((1, 64, 4, 68), dtype=q.dtype, device=card)
    with pytest.raises(ValueError, match="16-byte"):   # H stride 136 bytes
        flash_ops.flash_attention(padded[..., :64], k, v)
    flat = torch.zeros(k.numel() + 1, dtype=k.dtype, device=card)
    with pytest.raises(ValueError, match="16-byte"):   # base 2 bytes off
        flash_ops.flash_attention(q, k, flat[1:].view(k.shape))
    # float32 takes the SIMT kernel, which has no such rule
    flash_ops.flash_attention(padded[..., :64].float(), k.float(), v.float())


def _wkv_inputs(B, T, H, hd, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, hd), generator=g) * 0.5
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, T, H, hd), generator=g) * 0.5))
    u = torch.randn((H, hd), generator=g) * 0.3
    s0 = torch.randn((B, H, hd, hd), generator=g) * 0.1
    return ([t.to(device, dtype) for t in (r, k, v)]
            + [t.to(device) for t in (w, u, s0)])


def _wkv_check(args, dtype):
    """Launches the kernel once on ``args`` and holds y and the state
    against the plain version on the same (float32) inputs."""
    before = wkv_ops.launches
    y, sT = wkv_ops.wkv6(*args)
    torch.cuda.synchronize()
    assert wkv_ops.launches == before + 1
    assert y.dtype == dtype and sT.dtype == torch.float32
    want_y, want_s = wkv_ops.wkv6_plain(*(t.float() for t in args[:3]),
                                        *args[3:])
    torch.testing.assert_close(y.float(), want_y, **WKV_TOL[dtype])
    torch.testing.assert_close(sT, want_s, **WKV_TOL[torch.float32])


# The kernel stages 16-step chunks through a ring of 4 chunk buffers (64
# steps): T around one chunk and around the ring's depth, and ragged.
WKV_CHUNK, WKV_RING = 16, 64


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,dtype", [
    (2, 1024, 32, 64, torch.bfloat16),   # the prefill of rwkv6_1_6b
    (1, 333, 4, 64, torch.float32),      # ragged T
    (2, 1, 32, 64, torch.bfloat16),      # T = 1
    (2, 37, 4, 16, torch.float32),       # the reduced config's head dim
    (1, 50, 2, 128, torch.float32),
    (2, 1, 32, 64, torch.float32),       # the decode step of rwkv6_1_6b
    (2, 37, 4, 16, torch.bfloat16),
    (1, 50, 2, 128, torch.bfloat16),
    (2, 70, 3, 64, torch.float32),
])
def test_wkv6_kernel_matches_plain(card, B, T, H, hd, dtype):
    args = _wkv_inputs(B, T, H, hd, dtype, card)
    assert wkv_ops.uses_ring(*args) == (T > 1)   # contiguous: aligned
    _wkv_check(args, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2, WKV_CHUNK - 1, WKV_CHUNK, WKV_CHUNK + 1,
                               WKV_RING - 1, WKV_RING, WKV_RING + 1, 333])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv6_kernel_around_the_ring(card, T, dtype):
    _wkv_check(_wkv_inputs(2, T, 4, 64, dtype, card, seed=T), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pad,ring", [(0, True), (2, False)])
def test_wkv6_kernel_takes_strided_r(card, dtype, pad, ring):
    """r as a slice of a wider tensor: of a larger head count (strides stay
    16-byte aligned: asynchronous copies) or of a padded head dim (they do
    not: the same kernel with plain copies)."""
    B, T, H, hd = 2, 77, 4, 64
    r, k, v, w, u, s0 = _wkv_inputs(B, T, H, hd, dtype, card)
    wide = torch.zeros((B, T, H + 1, hd + pad), dtype=dtype, device=card)
    wide[:, :, :H, :hd] = r
    view = wide[:, :, :H, :hd]
    assert not view.is_contiguous()
    args = [view, k, v, w, u, s0]
    assert wkv_ops.uses_ring(*args) == ring
    _wkv_check(args, dtype)
    y_view, s_view = wkv_ops.wkv6(*args)
    y, sT = wkv_ops.wkv6(r, k, v, w, u, s0)
    # The two paths run the same arithmetic: bitwise equal.
    assert torch.equal(y_view, y) and torch.equal(s_view, sT)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [128, 77])
def test_wkv6_kernel_state_carry_composes(card, split):
    """Two calls with the state carried equal one call bitwise, at a chunk
    multiple and at a split that is not one."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 256, 4, 64, torch.bfloat16, card)
    y_full, s_full = wkv_ops.wkv6(r, k, v, w, u, s0)
    y1, s_mid = wkv_ops.wkv6(r[:, :split], k[:, :split], v[:, :split],
                             w[:, :split], u, s0)
    y2, s_end = wkv_ops.wkv6(r[:, split:], k[:, split:], v[:, split:],
                             w[:, split:], u, s_mid)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0,
                               atol=0)
    torch.testing.assert_close(s_end, s_full, rtol=0, atol=0)


@pytest.mark.cuda
def test_wkv6_kernel_is_deterministic(card):
    args = _wkv_inputs(2, 1024, 32, 64, torch.bfloat16, card, seed=3)
    y1, s1 = wkv_ops.wkv6(*args)
    y2, s2 = wkv_ops.wkv6(*args)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
def test_wkv6_kernel_decode_step_matches_the_plain_step(card):
    """The T = 1 float32 launch that rwkv6_1_6b's decode makes, against the
    reference's plain step written out, and counted as a T = 1 launch."""
    B, H, hd = 2, 32, 64
    r, k, v, w, u, s0 = _wkv_inputs(B, 1, H, hd, torch.float32, card)
    before = wkv_ops.launches_t1
    y, sT = wkv_ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv_ops.launches_t1 == before + 1
    kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]
    want_y = torch.einsum("bhi,bhij->bhj", r[:, 0], s0 + u[None, :, :, None]
                          * kv).reshape(B, 1, H * hd)
    want_s = w[:, 0, :, :, None] * s0 + kv
    torch.testing.assert_close(y, want_y, **WKV_TOL[torch.float32])
    torch.testing.assert_close(sT, want_s, **WKV_TOL[torch.float32])


@pytest.mark.cuda
def test_wkv6_kernel_refuses_what_it_does_not_take(card):
    r, k, v, w, u, s0 = _wkv_inputs(1, 8, 2, 48, torch.float32, card)
    with pytest.raises(ValueError, match="hd"):
        wkv_ops.wkv6(r, k, v, w, u, s0)
    r, k, v, w, u, s0 = _wkv_inputs(1, 8, 2, 64, torch.float32, card)
    with pytest.raises(TypeError, match="float32"):
        wkv_ops.wkv6(r, k, v, w, u, s0.double())
    with pytest.raises(TypeError, match="float32"):
        wkv_ops.wkv6(r, k, v, w.bfloat16(), u, s0)   # w is never rounded
    with pytest.raises(TypeError):
        wkv_ops.wkv6(r.half(), k.half(), v.half(), w, u, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2048, 5120), torch.bfloat16),      # qwen3_32b prefill Norm
    ((131072, 128), torch.bfloat16),     # qwen3_32b prefill q-norm
    ((2, 5120), torch.bfloat16),         # decode
    ((37, 1001), torch.float32),         # d not a multiple of 8
    ((5, 3, 4096), torch.float32),
    # rows the wide path's packs do not divide evenly, and a long one
    ((64, 5000), torch.bfloat16),
    ((64, 5128), torch.bfloat16),
    ((64, 8192), torch.bfloat16),
])
def test_rmsnorm_kernel_matches_plain(card, shape, dtype):
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(shape, generator=g).to(card, dtype)
    scale = (torch.randn(shape[-1], generator=g) * 0.1 + 1).to(card)
    before = rms_ops.launches
    got = rms_ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rms_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = rmsnorm_ref(x.float(), scale)
    torch.testing.assert_close(got.float(), want, **RMS_TOL[dtype])
    # a strided view (the last token of each sequence) takes the same path
    if len(shape) == 3:
        view = x[:, -1:, :]
        torch.testing.assert_close(rms_ops.rmsnorm(view, scale).float(),
                                   rmsnorm_ref(view.float(), scale),
                                   **RMS_TOL[dtype])


@pytest.mark.cuda
def test_rmsnorm_kernel_is_deterministic_and_refuses_bad_input(card):
    x = torch.randn((64, 5120), device=card, dtype=torch.bfloat16)
    scale = torch.ones(5120, device=card)
    a, b = rms_ops.rmsnorm(x, scale), rms_ops.rmsnorm(x, scale)
    assert torch.equal(a, b)
    with pytest.raises(TypeError, match="scale"):
        rms_ops.rmsnorm(x, scale.bfloat16())
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x.half(), scale)
