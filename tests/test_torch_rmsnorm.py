"""RMSNorm parity: the port's wrapper and the layers that call it against
``repro``, with inputs made by numpy from a seed.

On CPU tensors the port's ``rmsnorm`` is its plain float32 version; it must
agree with the Pallas kernel (interpret mode, as ``tests/test_kernels.py``
runs it) and with the JAX ``rmsnorm_ref`` to 1e-5 in float32, and it must
not count a launch.  The hand-written CUDA kernel runs only on the card:
``tests/test_torch_kernels_cuda.py`` holds it against the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_fallback import given, settings, st

from repro.configs import get_config as jget_config
from repro.kernels.rmsnorm.ops import rmsnorm as jrmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jrmsnorm_ref
from repro.models.layers import apply_norm, rms_norm_heads as jheads
from repro_torch.configs import get_config
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models.layers import Norm, rms_norm_heads

# float32: one mean and rsqrt in another summation order (1e-5).  bf16: the
# output is rounded to bf16, one step of which is 2^-8 relative.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(shape, dtype, seed=0):
    """x ~ N(0, 1) in ``dtype``; scale ~ N(1, 0.01) in float32, as the
    model's parameters are."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    return ((jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(scale)),
            (torch.from_numpy(x).to(getattr(torch, dtype)),
             torch.from_numpy(scale)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 16, 4, 128),    # qk-norm over hd = 128 (qwen3_32b)
    (3, 5120),          # qwen3_32b's Norm, d_model = 5120
    (7, 3, 100),        # d not a multiple of 8
])
def test_rmsnorm_matches_jax(shape, dtype):
    (jx, jscale), (x, scale) = _inputs(shape, dtype)
    before = ops.launches
    got = ops.rmsnorm(x, scale)
    assert ops.launches == before            # the CPU path never counts
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want in (jrmsnorm(jx, jscale), jrmsnorm_ref(jx, jscale)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 64), st.sampled_from([128, 100, 384, 5120]))
def test_rmsnorm_property(rows, d):
    (jx, _), (x, _) = _inputs((rows, d), "float32", seed=rows)
    scale = torch.ones(d)
    got = ops.rmsnorm(x, scale)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jrmsnorm_ref(jx, jnp.ones(d))),
                               rtol=2e-5, atol=2e-5)
    # invariant: output row RMS ~= 1 for unit scale
    rms = np.sqrt(np.mean(got.numpy() ** 2, axis=-1))
    np.testing.assert_allclose(rms, 1.0, atol=1e-2)


def test_rmsnorm_ref_is_the_jax_ref():
    (jx, jscale), (x, scale) = _inputs((4, 6, 96), "float32", seed=3)
    np.testing.assert_allclose(rmsnorm_ref(x, scale, eps=1e-3).numpy(),
                               np.asarray(jrmsnorm_ref(jx, jscale, eps=1e-3)),
                               **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_and_qk_norm_layers_match_jax(dtype):
    """``Norm``'s rmsnorm branch and ``rms_norm_heads`` take the wrapper;
    on the CPU they give the reference layers' values."""
    cfg = get_config("qwen3_32b", reduced=True)
    jcfg = jget_config("qwen3_32b", reduced=True)
    (jx, jscale), (x, scale) = _inputs((2, 9, cfg.d_model), dtype, seed=5)
    norm = Norm(cfg, cfg.d_model, "cpu")
    norm.scale.data.copy_(scale)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(
        norm(x).float().numpy(),
        np.asarray(apply_norm(jcfg, {"scale": jscale}, jx), np.float32), **tol)
    (jh, jhs), (h, hs) = _inputs((2, 9, 4, cfg.hd), dtype, seed=6)
    np.testing.assert_allclose(rms_norm_heads(h, hs).float().numpy(),
                               np.asarray(jheads(jh, jhs), np.float32), **tol)


def test_rmsnorm_cuda_path_refuses_what_it_does_not_take():
    _, (x, scale) = _inputs((4, 128), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm_cuda(x, scale)
