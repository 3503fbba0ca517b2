"""Flash attention: the port's wrapper against the JAX kernel.

On CPU tensors the port's ``flash_attention`` is its plain PyTorch version;
it must agree with the Pallas kernel (interpret mode) and with the JAX
``attention_ref`` at the tolerances of ``tests/test_kernels.py``, and it
must not count a launch.  The hand-written CUDA kernel itself runs only on
the card: its test is marked ``cuda`` and skips here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

CASES = [
    (2, 256, 4, 2, 64, 0, 0.0),        # GQA
    (1, 512, 8, 8, 32, 0, 0.0),        # MHA
    (2, 256, 4, 2, 64, 128, 0.0),      # sliding window
    (1, 256, 4, 1, 64, 0, 30.0),       # softcap (gemma-style), MQA
    (1, 128, 2, 2, 128, 64, 20.0),     # window + softcap
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


def test_flash_cuda_path_refuses_cpu_tensors():
    _, (q, k, v) = _inputs(1, 64, 2, 1, 64, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="hd"):
        ops.flash_attention_cuda(q[..., :32], k[..., :32], v[..., :32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,window,softcap", [
    (2, 1024, 64, 8, 128, 0, 0.0),     # the serving shape of qwen3_32b
    (1, 1000, 16, 8, 256, 256, 0.0),   # hd 256, window, ragged S
    (1, 333, 8, 1, 64, 0, 30.0),       # softcap, MQA, ragged S
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
