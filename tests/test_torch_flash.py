"""Flash attention: the port's wrapper against the JAX kernel.

On CPU tensors the port's ``flash_attention`` is its plain PyTorch version;
it must agree with the Pallas kernel (interpret mode) and with the JAX
``attention_ref`` at the tolerances of ``tests/test_kernels.py``, and it
must not count a launch.  The bf16 CUDA kernel rounds at one point the TPU
kernel does not (P to bf16 before P V); a plain model of its rounding
points is held against the same references here.  The hand-written CUDA
kernel itself runs only on the card: its test is marked ``cuda`` and skips
here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref

CASES = [
    (2, 256, 4, 2, 64, 0, 0.0),        # GQA
    (1, 512, 8, 8, 32, 0, 0.0),        # MHA
    (2, 256, 4, 2, 64, 128, 0.0),      # sliding window
    (1, 256, 4, 1, 64, 0, 30.0),       # softcap (gemma-style), MQA
    (1, 128, 2, 2, 128, 64, 20.0),     # window + softcap
    (1, 128, 4, 2, 192, 0, 0.0),       # hd 192 (nemotron's), GQA
]


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(B, S, H, Hkv, hd, dtype, seed=0):
    rng = np.random.RandomState(seed)
    xs = [rng.standard_normal((B, S, n, hd)).astype(np.float32)
          for n in (H, Hkv, Hkv)]
    jx = [jnp.asarray(x, getattr(jnp, dtype)) for x in xs]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,window,softcap", CASES)
def test_flash_attention_matches_jax(B, S, H, Hkv, hd, window, softcap,
                                     dtype):
    (jq, jk, jv), (q, k, v) = _inputs(B, S, H, Hkv, hd, dtype)
    before = ops.launches
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    assert ops.launches == before           # the CPU path never counts
    assert got.dtype == q.dtype and got.shape == q.shape
    got = got.float().numpy()
    want_kernel = jflash(jq, jk, jv, window=window, softcap=softcap,
                         block_q=64, block_k=64)
    want_ref = jref(jq, jk, jv, window=window, softcap=softcap)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(dtype))


def _wgmma_rounding_attention(q, k, v, *, window=0, softcap=0.0):
    """Causal attention with the rounding points of the bf16 tensor-core
    kernel: S = q . k in f32, then times hd^-0.5 in f32, softcap and mask;
    the softmax statistics in f32; P rounded to bf16 before P V, which
    accumulates in f32; the output rounded to bf16."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(Sq)[:, None]
    k_pos = torch.arange(Sk)[None, :]
    mask = k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.bfloat16).float(),
                     v.float())
    o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, Sq, H, hd).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,H,Hkv,hd,window,softcap", CASES)
def test_flash_wgmma_rounding_matches_jax(B, S, H, Hkv, hd, window,
                                          softcap):
    (jq, jk, jv), (q, k, v) = _inputs(B, S, H, Hkv, hd, "bfloat16")
    got = _wgmma_rounding_attention(q, k, v, window=window, softcap=softcap)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want_kernel = jflash(jq, jk, jv, window=window, softcap=softcap,
                         block_q=64, block_k=64)
    want_ref = jref(jq, jk, jv, window=window, softcap=softcap)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **_tol("bfloat16"))


def test_flash_cuda_path_refuses_cpu_tensors():
    _, (q, k, v) = _inputs(1, 64, 2, 1, 64, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_cuda(q, k, v)
    # every hd up to 256 runs (padded where it is not native); past it, none
    _, (q, k, v) = _inputs(1, 64, 2, 1, 320, "float32")
    with pytest.raises(ValueError, match="hd"):
        ops.flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 96])
def test_flash_head_dim_padding_matches_plain(hd, dtype):
    """What the launch does with a head dim the kernels do not take: q, k
    and v zero-padded to the next native hd, attention there with the
    unpadded hd's scale, the output's first hd columns.  On the plain
    version this equals the plain version at hd (the zero columns add
    exactly nothing), and the JAX kernel's output."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 96, 4, 2, hd, dtype)
    hdp = ops.padded_head_dim(hd)
    assert hdp == {16: 64, 96: 128}[hd] and hdp in ops.SUPPORTED_HEAD_DIMS
    padded = [ops.pad_head_dim(x, hdp) for x in (q, k, v)]
    assert all(x.shape == (*y.shape[:3], hdp) and not x[..., hd:].any()
               for x, y in zip(padded, (q, k, v)))
    got = attention_ref(*padded, window=32, scale=hd ** -0.5)[..., :hd]
    torch.testing.assert_close(got, attention_ref(q, k, v, window=32),
                               rtol=0, atol=0)
    want = jflash(jq, jk, jv, window=32, block_q=32, block_k=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,window,softcap", [
    (2, 1024, 64, 8, 128, 0, 0.0),     # the serving shape of qwen3_32b
    (1, 1000, 16, 8, 256, 256, 0.0),   # hd 256, window, ragged S
    (1, 333, 8, 1, 64, 0, 30.0),       # softcap, MQA, ragged S
    # edges of the bf16 kernel's 128-row query and 64- or 128-key tiles
    (2, 77, 4, 2, 128, 0, 0.0),        # S under one tile
    (1, 1000, 8, 8, 64, 17, 0.0),      # window under one k tile
    (1, 200, 8, 1, 256, 0, 0.0),       # hd 256, MQA
    (2, 1024, 96, 8, 192, 0, 0.0),     # hd 192: nemotron_4_340b's prefill
    (1, 333, 8, 1, 192, 0, 0.0),       # hd 192, MQA, ragged S
    (2, 77, 4, 4, 16, 0, 0.0),         # hd 16 (a reduced config), padded
    (1, 300, 6, 2, 96, 100, 0.0),      # hd 96, padded, window, ragged S
])
def test_flash_cuda_kernel_matches_plain(B, S, H, Hkv, hd, window, softcap,
                                         dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, (q, k, v) = _inputs(B, S, H, Hkv, hd, dtype)
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    before = ops.launches
    got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = attention_ref(q.float(), k.float(), v.float(), window=window,
                         softcap=softcap)
    torch.testing.assert_close(got.float(), want, **_tol(dtype))

