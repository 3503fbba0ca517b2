"""The port's Mamba heads (``repro_torch.models.mamba``) against
``repro.models.mamba`` on the reference's own weights (reduced hymba,
``ssm.state_dim`` 4, inner 128), carried over through numpy.

Tolerances, by what each compares:
* float32 activations: outputs and the state within 1e-5 of each one's
  scale (the two scans combine in another tree: Hillis–Steele here, the
  reference's odd-even ``associative_scan`` there);
* bf16 activations: outputs at 2e-2 of their scale, as
  ``test_torch_models.py`` holds bf16 logits; the float32 state, driven by
  bf16 values the two frameworks round apart, at 2e-2 of its scale;
* the sequence scan against T unrolled steps of the port: 1e-5 (f32);
* gradients through the scan against ``jax.grad``, per leaf in relative
  Frobenius norm: 1e-4 (f32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import mamba as JM
from repro_torch.configs import get_config
from repro_torch.models import mamba as TM

F32_TOL = 1e-5
BF16_TOL = 2e-2


@functools.lru_cache(maxsize=None)
def _ref():
    jcfg = jget_config("hymba_1_5b", reduced=True)
    p = JM.init_mamba(jax.random.PRNGKey(3), jcfg)
    return jcfg, jax.tree_util.tree_map(np.asarray, p)


def _pair():
    jcfg, p = _ref()
    cfg = get_config("hymba_1_5b", reduced=True)
    mod = TM.Mamba(cfg, None, "cpu")
    with torch.no_grad():
        for name, value in p.items():
            getattr(mod, name).copy_(torch.from_numpy(np.array(value)))
    return jcfg, p, cfg, mod


def _state(cfg, B, seed):
    """A nonzero incoming state (h and the conv window)."""
    rng = np.random.RandomState(seed)
    inner = cfg.ssm.expand * cfg.d_model
    return {"h": (rng.standard_normal((B, inner, cfg.ssm.state_dim))
                  * 0.5).astype(np.float32),
            "conv": rng.standard_normal(
                (B, cfg.ssm.conv_dim - 1, inner)).astype(np.float32)}


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


def _run_both(S, dtype, seed=0, B=2):
    jcfg, p, cfg, mod = _pair()
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    st = _state(cfg, B, seed + 1)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jy, jst = JM.apply_mamba_seq(
        jcfg, jax.tree_util.tree_map(jnp.asarray, p),
        jnp.asarray(x, jdt), {k: jnp.asarray(v) for k, v in st.items()})
    with torch.no_grad():
        ty, tst = TM.apply_mamba_seq(
            cfg, mod, torch.from_numpy(x).to(dtype),
            {k: torch.from_numpy(v) for k, v in st.items()})
    return (jy, jst), (ty, tst)


@pytest.mark.parametrize("S", [32, 256, 1000])
def test_seq_matches_reference_f32(S):
    """S 1000 takes the chunk rule down to chunks of 8 (125 of them)."""
    (jy, jst), (ty, tst) = _run_both(S, torch.float32)
    assert ty.dtype == torch.float32
    assert tst["h"].dtype == tst["conv"].dtype == torch.float32
    _close(ty.numpy(), jy, F32_TOL)
    _close(tst["h"].numpy(), jst["h"], F32_TOL)
    _close(tst["conv"].numpy(), jst["conv"], F32_TOL)


@pytest.mark.parametrize("S", [32, 256, 1000])
def test_seq_matches_reference_bf16(S):
    (jy, jst), (ty, tst) = _run_both(S, torch.bfloat16, seed=4)
    assert ty.dtype == torch.bfloat16
    # the returned conv window is float32 in both modes, as the reference's
    assert tst["h"].dtype == tst["conv"].dtype == torch.float32
    _close(ty.float().numpy(), np.asarray(jy, np.float32), BF16_TOL)
    _close(tst["h"].numpy(), jst["h"], BF16_TOL)
    _close(tst["conv"].numpy(), jst["conv"], BF16_TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_step_matches_reference(dtype, tol):
    jcfg, p, cfg, mod = _pair()
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    rng = np.random.RandomState(7)
    st = _state(cfg, 2, 8)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    for _ in range(4):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = JM.apply_mamba_step(jcfg, jp, jnp.asarray(x, jdt), jst)
        with torch.no_grad():
            ty, tst = TM.apply_mamba_step(cfg, mod,
                                          torch.from_numpy(x).to(dtype), tst)
        assert ty.shape == (2, 1, cfg.d_model) and ty.dtype == dtype
        _close(ty.float().numpy(), np.asarray(jy, np.float32), tol)
        _close(tst["h"].numpy(), jst["h"], tol)
        _close(tst["conv"].numpy(), jst["conv"], tol)


@pytest.mark.parametrize("S", [5, 37])
def test_seq_equals_unrolled_steps(S):
    """The sequence scan from a nonzero state against S decode steps."""
    _, _, cfg, mod = _pair()
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.standard_normal((2, S, cfg.d_model)).astype(
        np.float32))
    st0 = {k: torch.from_numpy(v) for k, v in _state(cfg, 2, 10).items()}
    with torch.no_grad():
        y, st = TM.apply_mamba_seq(cfg, mod, x, st0)
        ys, stt = [], st0
        for t in range(S):
            yt, stt = TM.apply_mamba_step(cfg, mod, x[:, t:t + 1], stt)
            ys.append(yt)
    _close(torch.cat(ys, 1).numpy(), y.numpy(), F32_TOL)
    _close(stt["h"].numpy(), st["h"].numpy(), F32_TOL)
    _close(stt["conv"].numpy(), st["conv"].numpy(), F32_TOL)


def test_init_matches_reference_shapes_and_fixed_leaves():
    """The port's own init: the reference's shapes, ``A_log`` exactly
    log(1..N) per channel, ``D`` ones, ``dt_bias`` zeros; the state f32."""
    jcfg, p, cfg, _ = _pair()
    mod = TM.Mamba(cfg, torch.Generator().manual_seed(0), "cpu")
    for name, value in p.items():
        assert tuple(getattr(mod, name).shape) == value.shape, name
    np.testing.assert_array_equal(mod.A_log.numpy(), p["A_log"])
    np.testing.assert_array_equal(mod.D.numpy(), p["D"])
    np.testing.assert_array_equal(mod.dt_bias.numpy(), p["dt_bias"])
    st = TM.init_mamba_state(cfg, 3, "cpu")
    want = JM.init_mamba_state(jcfg, 3)
    for k in ("h", "conv"):
        assert tuple(st[k].shape) == want[k].shape
        assert st[k].dtype == torch.float32 and not st[k].any()


@pytest.mark.parametrize("S", [32, 1000])
def test_gradients_through_scan_match_jax_grad(S):
    """The scan's gradient (each chunk recomputed in the backward pass)
    against ``jax.grad`` of the reference's sequence mode, for every
    weight, the input and the incoming state, in float32."""
    jcfg, p, cfg, mod = _pair()
    rng = np.random.RandomState(11)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    st = _state(cfg, 2, 12)
    gy = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    gh = rng.standard_normal(st["h"].shape).astype(np.float32)

    def jloss(params, x, h):
        y, new = JM.apply_mamba_seq(jcfg, params, x,
                                    {"h": h, "conv": jnp.asarray(st["conv"])})
        return jnp.sum(y * gy) + jnp.sum(new["h"] * gh)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(st["h"]))
    mod.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(st["h"]).requires_grad_(True)
    y, new = TM.apply_mamba_seq(cfg, mod, tx,
                                {"h": th, "conv": torch.from_numpy(
                                    st["conv"])})
    loss = (y * torch.from_numpy(gy)).sum() + (
        new["h"] * torch.from_numpy(gh)).sum()
    loss.backward()
    pairs = [(getattr(mod, n).grad, jg[0][n]) for n in p] + [
        (tx.grad, jg[1]), (th.grad, jg[2])]
    for got, want in pairs:
        want = np.asarray(want)
        err = np.linalg.norm(got.numpy() - want)
        assert err <= 1e-4 * np.linalg.norm(want), err
