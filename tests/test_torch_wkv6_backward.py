"""The WKV6 backward of the port against the JAX package: the plain
backward (``ref.wkv6_bwd_ref``, the arithmetic of the CUDA kernel
``csrc/wkv6_bwd.cu``, from the same kept chunk states) against ``jax.vjp``
of ``repro.kernels.rwkv6.ref.wkv6_ref`` and against autograd through the
port's plain loop; ``WKV6Fn`` on CPU tensors; and the gradients of
``apply_rwkv_seq`` against ``jax.vjp`` of the reference's, whose recurrence
is a checkpointed ``lax.scan``.  Inputs are made by numpy from a seed.

Tolerances: float32 throughout, the same products summed in another order
(a reverse-time walk against reverse-mode autodiff of a scan), held at
rtol 1e-5 with an absolute floor of 1e-5 of each gradient's largest
element, for the elements that cancel to near zero.  ``apply_rwkv_seq``
adds float32 products over d = 64 in two frameworks: 1e-4, as
``tests/test_torch_rwkv.py`` holds its forward.  The kernel itself runs
only on the card (``tests/test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.rwkv6.ref import wkv6_ref as jwkv6_ref
from repro.models import rwkv as JR
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import (CHUNK, n_chunks, wkv6_bwd_ref,
                                           wkv6_ref, wkv6_ref_saving)
from repro_torch.models import rwkv as TR

ARCH = "rwkv6_1_6b"
GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")

# (label, BH, T, hd, with dsT)
CASES = [
    ("s0 and dsT, T a multiple of the chunk", 3, 2 * CHUNK, 16, True),
    ("dsT absent", 2, 2 * CHUNK, 16, False),
    ("ragged T", 2, 37, 16, True),
    ("T within one chunk", 4, 5, 16, True),
    ("hd 64 ragged", 2, 21, 64, True),
]


def _inputs(BH, T, hd, seed=0):
    """r, k, v ~ N(0, 0.25); w = exp(-exp(N(0, 0.25))) as the model builds
    it; u ~ N(0, 0.09); s0 ~ N(0, 0.01), nonzero; dy ~ N(0, 1) and dsT ~
    N(0, 0.01).  Float32 numpy, in the (BH, T, hd) layout."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.standard_normal((BH, T, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((BH, T, hd)) * 0.5)).astype(
        np.float32)
    u = rng.standard_normal((BH, hd)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((BH, hd, hd)).astype(np.float32) * 0.1
    dy = rng.standard_normal((BH, T, hd)).astype(np.float32)
    dsT = rng.standard_normal((BH, hd, hd)).astype(np.float32) * 0.1
    return (r, k, v, w, u, s0), dy, dsT


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def _port_bwd(x, dy, dsT):
    t = [torch.from_numpy(a) for a in x]
    _, _, states = wkv6_ref_saving(*t)
    return wkv6_bwd_ref(*t[:5], states, torch.from_numpy(dy),
                        None if dsT is None else torch.from_numpy(dsT))


@pytest.mark.parametrize("label,BH,T,hd,with_dsT", CASES)
def test_bwd_ref_matches_jax_vjp(label, BH, T, hd, with_dsT):
    x, dy, dsT = _inputs(BH, T, hd)
    (jy, jsT), vjp = jax.vjp(jwkv6_ref, *map(jnp.asarray, x))
    want = vjp((jnp.asarray(dy), jnp.asarray(dsT) if with_dsT
                else jnp.zeros_like(jsT)))
    got = _port_bwd(x, dy, dsT if with_dsT else None)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w, f"{label}: {name}")


@pytest.mark.parametrize("label,BH,T,hd,with_dsT", CASES)
def test_bwd_ref_matches_autograd_through_the_plain_loop(label, BH, T, hd,
                                                         with_dsT):
    x, dy, dsT = _inputs(BH, T, hd, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in x]
    y, sT = wkv6_ref(*leaves)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_dsT:
        loss = loss + (sT * torch.from_numpy(dsT)).sum()
    want = torch.autograd.grad(loss, leaves)
    got = _port_bwd(x, dy, dsT if with_dsT else None)
    for name, g, w in zip(GRADS, got, want):
        _close(g.numpy(), w.numpy(), f"{label}: {name}")


@pytest.mark.parametrize("T", [1, CHUNK, 40])
def test_saving_forward_keeps_the_state_before_every_chunk(T):
    """The saving forward's y and final state equal the plain forward's
    bitwise, and its kept state c is the state the recurrence carries into
    step c * CHUNK (a split there)."""
    x, _, _ = _inputs(2, T, 16, seed=2)
    t = [torch.from_numpy(a) for a in x]
    y, sT = wkv6_ref(*t)
    ys, sTs, states = wkv6_ref_saving(*t)
    assert torch.equal(ys, y) and torch.equal(sTs, sT)
    assert states.shape == (2, n_chunks(T), 16, 16)
    for c in range(n_chunks(T)):
        cut = c * CHUNK
        _, s_mid = wkv6_ref(*(a[:, :cut] for a in t[:4]), *t[4:])
        assert torch.equal(states[:, c], s_mid)


def _bthd(BH, T, hd, B=2, seed=3):
    """(B, T, H, hd) inputs for the wrapper, H = BH / B, as float32
    torch tensors, with dy (B, T, H * hd) and dsT (B, H, hd, hd)."""
    x, dy, dsT = _inputs(BH, T, hd, seed)
    H = BH // B

    def split(a):
        return torch.from_numpy(a.reshape(B, H, T, hd).transpose(0, 2, 1, 3)
                                .copy())
    r, k, v, w = map(split, x[:4])
    u = torch.from_numpy(x[4][:H].copy())
    s0 = torch.from_numpy(x[5].reshape(B, H, hd, hd))
    return ((r, k, v, w, u, s0), split(dy).reshape(B, T, H * hd),
            torch.from_numpy(dsT.reshape(B, H, hd, hd)))


def test_wkv6fn_on_the_cpu_gives_only_the_requested_gradients():
    """Under grad a CPU call goes through ``WKV6Fn`` (the plain forward
    that keeps states, the plain backward): the leaves that ask for a
    gradient get autograd's through the plain loop, the rest get none, and
    nothing counts as a launch."""
    x, dy, dsT = _bthd(4, 37, 16)
    need = (True, False, False, True, True, False)
    leaves = [a.clone().requires_grad_(n) for a, n in zip(x, need)]
    before = (ops.launches, ops.launches_bwd)
    y, sT = ops.wkv6(*leaves)
    assert y.grad_fn is not None and "WKV6Fn" in type(y.grad_fn).__name__
    ((y * dy).sum() + (sT * dsT).sum()).backward()
    assert (ops.launches, ops.launches_bwd) == before
    ref = [a.clone().requires_grad_(True) for a in x]
    yr, sTr = ops.wkv6_plain(*ref)
    ((yr * dy).sum() + (sTr * dsT).sum()).backward()
    assert torch.equal(y.detach(), yr.detach())
    assert torch.equal(sT.detach(), sTr.detach())
    for leaf, r, n in zip(leaves, ref, need):
        if not n:
            assert leaf.grad is None
            continue
        _close(leaf.grad.numpy(), r.grad.numpy())


def test_wkv6fn_gives_bf16_inputs_bf16_gradients():
    """bf16 r, k and v get bf16 gradients, w, u and s0 float32 ones; the
    values are autograd's through the plain loop on the same inputs,
    rounded to bf16 (2^-8 relative: 2e-2 of each gradient's scale)."""
    x, dy, dsT = _bthd(4, 21, 16, seed=4)
    x = [a.bfloat16() if i < 3 else a for i, a in enumerate(x)]
    leaves = [a.clone().requires_grad_(True) for a in x]
    y, sT = ops.wkv6(*leaves)
    assert y.dtype == torch.bfloat16
    (y.float() * dy).sum().backward()
    ref = [a.float().clone().requires_grad_(True) for a in x]
    yr, _ = ops.wkv6_plain(*ref)
    (yr * dy).sum().backward()
    for i, (leaf, r) in enumerate(zip(leaves, ref)):
        assert leaf.grad.dtype == (torch.bfloat16 if i < 3
                                   else torch.float32)
        want = r.grad.numpy()
        np.testing.assert_allclose(
            leaf.grad.float().numpy(), want, rtol=2e-2,
            atol=2e-2 * float(np.abs(want).max()))


def _time_mix_pair(seed=0):
    jcfg = jget_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = JR.init_rwkv(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    for name in ("ln_x_scale", "decay_base", "mix_r", "mix_w"):
        jp[name] = jp[name] + jnp.asarray(
            rng.standard_normal(jp[name].shape).astype(np.float32) * 0.1)
    tm = TR.TimeMix(cfg, None, "cpu")
    for name, value in jp.items():
        getattr(tm, name).data.copy_(torch.from_numpy(np.array(value)))
    return jcfg, jp, cfg, tm


def test_apply_rwkv_seq_gradients_match_jax_vjp():
    """The time mix's gradients (every parameter, x and both parts of a
    nonzero incoming state) through ``WKV6Fn``, against ``jax.vjp`` of the
    reference's ``apply_rwkv_seq``, over S = 40 (not a multiple of the
    reference's 256-step chunk, nor of the port's 16), with cotangents on
    the output and on the final WKV state."""
    jcfg, jp, cfg, tm = _time_mix_pair()
    B, S, d, hd = 2, 40, cfg.d_model, cfg.ssm.head_dim
    rng = np.random.RandomState(5)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    shift = rng.standard_normal((B, d)).astype(np.float32)
    wkv = rng.standard_normal((B, d // hd, hd, hd)).astype(np.float32) * 0.1
    dout = rng.standard_normal((B, S, d)).astype(np.float32)
    dwkv = rng.standard_normal(wkv.shape).astype(np.float32) * 0.1

    def jfn(p, xx, st):
        out, new = JR.apply_rwkv_seq(jcfg, p, xx, st)
        return out, new["wkv"]
    _, vjp = jax.vjp(jfn, jp, jnp.asarray(x),
                     {"shift": jnp.asarray(shift), "wkv": jnp.asarray(wkv)})
    jgp, jgx, jgst = vjp((jnp.asarray(dout), jnp.asarray(dwkv)))

    tm.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tshift = torch.from_numpy(shift).requires_grad_(True)
    twkv = torch.from_numpy(wkv).requires_grad_(True)
    out, new = TR.apply_rwkv_seq(cfg, tm, tx, {"shift": tshift,
                                               "wkv": twkv})
    assert "WKV6Fn" in type(new["wkv"].grad_fn).__name__
    ((out * torch.from_numpy(dout)).sum()
     + (new["wkv"] * torch.from_numpy(dwkv)).sum()).backward()
    tol = dict(rtol=1e-4)
    pairs = [(f"param {n}", getattr(tm, n).grad, jgp[n]) for n in jp]
    pairs += [("x", tx.grad, jgx), ("shift", tshift.grad, jgst["shift"]),
              ("wkv", twkv.grad, jgst["wkv"])]
    for what, got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, err_msg=what,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   **tol)
