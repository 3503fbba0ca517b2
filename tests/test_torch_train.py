"""The training slice of the port against the JAX package: the data
stream, ``cross_entropy_loss``, ``forward_train`` and its gradients, the
chunked attention's backward and ``make_train_step``, on reduced configs
with the reference's own weights (``init_lm``, carried over through numpy
and ``from_jax_params``).

Tolerances, by what each compares:
* data stream: bit for bit;
* ``cross_entropy_loss`` on f32 logits: rtol 1e-6;
* ``forward_train`` logits: 2e-2 of the logit scale, as the serving parity
  tests hold them (bf16 activations in both frameworks); MoE aux losses
  rtol 1e-4 (f32 router arithmetic on bf16 inputs);
* gradients of the loss, per leaf in relative Frobenius norm: 3e-2 (bf16
  activations round differently in the two frameworks; the worst leaves,
  gemma3's qk-norm scales, sit at 2.3e-2), and 1.5e-2 over all leaves
  together;
* the chunked attention's forward and custom backward in f32: 1e-5 of
  each output's scale;
* three train steps with accum 2: losses rtol 1e-3, ``grad_norm`` rtol
  2e-2, parameters within 2·lr·steps absolute (AdamW's first steps move
  each element by about lr whatever the gradient's size, so a gradient
  whose sign differs between the frameworks moves it 2·lr apart).
"""
import dataclasses
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.data import SyntheticTokenStream as JStream
from repro.data import batch_specs as jbatch_specs
from repro.models import attention as JA
from repro.models import cross_entropy_loss as jce
from repro.models import forward_train as jforward_train
from repro.models import init_lm as jinit
from repro.optim import AdamW as JAdamW
from repro.runtime.steps import TrainState as JTrainState
from repro.runtime.steps import make_loss_fn as jmake_loss_fn
from repro.runtime.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenStream, batch_specs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models import attention as TA
from repro_torch.models import cross_entropy_loss, forward_train, \
    from_jax_params
from repro_torch.models.convert import reference_path, to_jax_layout
from repro_torch.optim import AdamW
from repro_torch.runtime.steps import TrainState, make_loss_fn, \
    make_train_step

ARCHS = ["qwen3_32b", "gemma3_12b", "qwen2_moe_a2_7b", "rwkv6_1_6b",
         "hymba_1_5b", "seamless_m4t_medium", "internvl2_76b"]
LOGIT_TOL = 2e-2


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    jcfg = jget_config(arch, reduced=True)
    return jcfg, jinit(jax.random.PRNGKey(0), jcfg)


def _pair(arch):
    jcfg, params = _ref_params(arch)
    cfg = get_config(arch, reduced=True)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu")
    return jcfg, params, cfg, model


def _batch(cfg, B=2, S=32, seed=1):
    """tokens and labels, plus the encoder's frames (S // 4) or the vision
    stub's patches where the config takes them."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_encoder_layers:
        batch["frames"] = rng.randn(B, S // 4, cfg.d_model).astype(
            np.float32)
    if cfg.frontend == "vision":
        batch["patches"] = rng.randn(B, cfg.n_frontend_tokens,
                                     cfg.d_model).astype(np.float32) * 0.02
    return batch


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def _flat_ref(tree):
    """The reference tree's leaves by checkpoint name."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                     for k in path)] = np.asarray(v)
    return out


def _leaf(cfg, flat, name):
    path, g = reference_path(cfg, name)
    return flat[path] if g is None else flat[path][g]


# ----------------------------------------------------------------------
# data stream
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3_32b", "seamless_m4t_medium",
                                  "internvl2_76b"])
def test_stream_batches_equal_reference_bit_for_bit(arch):
    """tokens and labels for every config, plus ``frames`` (seamless) and
    ``patches`` (internvl)."""
    js = JStream(jget_config(arch, reduced=True), 16, 4, accum=2, seed=3)
    ts = SyntheticTokenStream(get_config(arch, reduced=True), 16, 4,
                              accum=2, seed=3)
    for step in (0, 5):
        want, got = js.batch(step), ts.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert ts.nbytes() == js.nbytes()
    want = jbatch_specs(jget_config(arch, reduced=True), 16, 4, accum=2)
    got = batch_specs(get_config(arch, reduced=True), 16, 4, accum=2)
    assert {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in want.items()} \
        == {k: (s, np.dtype(d)) for k, (s, d) in got.items()}


# ----------------------------------------------------------------------
# loss and forward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_loss_matches_reference(z_loss):
    rng = np.random.RandomState(2)
    logits = (rng.standard_normal((2, 8, 50)) * 3).astype(np.float32)
    labels = rng.randint(0, 50, (2, 8)).astype(np.int32)
    want = jce(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss)
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels), z_loss=z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    jcfg, params, cfg, model = _pair(arch)
    batch = _batch(cfg)
    jl, ja = jax.jit(functools.partial(jforward_train, jcfg))(
        params, {k: jnp.asarray(v) for k, v in _inputs(batch).items()})
    with torch.no_grad():
        tl, ta = forward_train(cfg, model, {k: torch.from_numpy(v) for k, v
                                            in _inputs(batch).items()})
    assert tl.dtype == torch.float32 and tl.shape == (2, 32, cfg.vocab)
    want = np.asarray(jl)
    scale = float(np.abs(want).max())
    assert float(np.abs(tl.numpy() - want).max()) <= LOGIT_TOL * scale
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(ta[k]), float(ja[k]), rtol=1e-4,
                                   atol=1e-9)
    if cfg.moe is not None:
        assert float(ta["moe_aux"]) > 0 and float(ta["moe_z"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_reference(arch):
    """``make_loss_fn``'s gradient through autograd against ``jax.grad``
    of the reference's loss, per leaf (relative Frobenius norm).

    The MoE config routes every token to all its experts here (top-k = E,
    the same parameters): with top-2 of 8, a near-tie that the two
    frameworks' bf16 rounding breaks apart sends a token to another expert
    and moves that expert's gradients by 10 to 20%, a difference of the
    routing's discontinuity and not of the backward pass."""
    jcfg, params, cfg, model = _pair(arch)
    if cfg.moe is not None:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, top_k=c.moe.n_experts)) for c in (jcfg, cfg))
    batch = _batch(cfg, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = jmake_loss_fn(jcfg)
    (jtotal, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jb), has_aux=True))(params)
    model.requires_grad_(True)
    total, metrics = make_loss_fn(cfg)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-3)
    flat = _flat_ref(jg)
    num = den = 0.0
    for n, p in model.named_parameters():
        want = _leaf(cfg, flat, n)
        got = p.grad.numpy()
        err = np.linalg.norm(got - want)
        assert err <= 3e-2 * np.linalg.norm(want), (n, err)
        num += err ** 2
        den += np.linalg.norm(want) ** 2
    assert np.sqrt(num) <= 1.5e-2 * np.sqrt(den)


@pytest.mark.parametrize("arch", ["qwen3_32b", "qwen2_moe_a2_7b",
                                  "hymba_1_5b", "seamless_m4t_medium",
                                  "internvl2_76b"])
def test_remat_changes_no_value(arch):
    """Recomputing each block in the backward pass gives the same logits
    and the same gradients, bit for bit."""
    _, _, cfg, model = _pair(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    model.requires_grad_(True)
    grads = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        total, _ = make_loss_fn(cfg, remat=remat)(model, batch)
        total.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


# ----------------------------------------------------------------------
# chunked attention: forward and custom backward
# ----------------------------------------------------------------------
CHUNK_CASES = [
    # (H, Hkv, causal, window, softcap)
    (4, 2, True, 0, 0.0),
    (4, 2, True, 100, 0.0),
    (4, 2, True, 0, 30.0),
    (4, 1, True, 64, 20.0),
    (4, 4, False, 0, 0.0),
]


def _close_scaled(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("H,Hkv,causal,window,softcap", CHUNK_CASES)
def test_chunked_attention_backward_matches_reference_vjp(H, Hkv, causal,
                                                          window, softcap):
    rng = np.random.RandomState(5)
    B, S, hd, qc, kc = 2, 256, 16, 64, 128
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    dout = rng.standard_normal((B, S, H * hd)).astype(np.float32)
    fn = functools.partial(JA._chunked_attention, causal=causal,
                           window=window, softcap=softcap, q_chunk=qc,
                           kv_chunk=kc)
    jo, vjp = jax.vjp(lambda a, b, c: fn(a, b, c), jnp.asarray(q),
                      jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    to = TA.ChunkedAttention.apply(tq, tk, tv, causal, window, softcap, qc,
                                   kc)
    to.backward(torch.from_numpy(dout))
    _close_scaled(to.detach().numpy(), jo)
    for got, want in ((tq.grad, jdq), (tk.grad, jdk), (tv.grad, jdv)):
        _close_scaled(got.numpy(), want)


def test_chunked_attention_backward_matches_autograd_through_sdpa():
    """The custom backward against autograd through the materialized
    ``_sdpa`` on the same f32 inputs (what ``chip_smoke.py`` holds on the
    card at S 2048)."""
    cfg = dataclasses.replace(get_config("qwen3_32b", reduced=True),
                              logit_softcap=30.0)
    g = torch.Generator().manual_seed(6)
    q = torch.randn(1, 256, 4, 16, generator=g).requires_grad_(True)
    k = torch.randn(1, 256, 2, 16, generator=g).requires_grad_(True)
    v = torch.randn(1, 256, 2, 16, generator=g).requires_grad_(True)
    dout = torch.randn(1, 256, 64, generator=g)
    grads = []
    for chunked in (True, False):
        for t in (q, k, v):
            t.grad = None
        if chunked:
            o = TA._sdpa_chunked(cfg, q, k, v, causal=True, window=100,
                                 q_chunk=64, kv_chunk=64)
        else:
            o = TA._sdpa(cfg, q, k, v, TA.causal_mask(256, 256, 100))
        o.backward(dout)
        grads.append([o.detach()] + [t.grad.clone() for t in (q, k, v)])
    for got, want in zip(*grads):
        _close_scaled(got.numpy(), want.numpy())


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
def test_train_step_matches_reference_jitted_step():
    arch = "qwen3_32b"
    jcfg, params, cfg, model = _pair(arch)
    kw = dict(lr=1e-3, warmup=2, total_steps=10)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jstep = jax.jit(jmake_train_step(jcfg, jopt))
    tstep = make_train_step(cfg, topt)
    jstate = JTrainState(params, jopt.init(params))
    tstate = TrainState(model, topt.init(model))
    stream = SyntheticTokenStream(cfg, 16, 4, accum=2, seed=1)
    steps = 3
    for step in range(steps):
        b = stream.batch(step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-2)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    assert tstate.opt.step == int(jstate.opt.step) == steps
    flat = _flat_ref(jstate.params)
    for n, p in model.named_parameters():
        assert p.grad is None
        np.testing.assert_allclose(p.detach().numpy(), _leaf(cfg, flat, n),
                                   rtol=0, atol=2 * kw["lr"] * steps)


def test_seamless_checkpoint_crosses_to_the_reference_and_back(tmp_path):
    """An encoder-decoder train state after one port step (the encoder's
    ``encoder.N.*`` leaves stacked as ``params/encoder/*``[N], their
    moments too) saved by the port, restored by the reference's manager
    into its own state leaf for leaf, saved again by the reference and
    restored by the port: every leaf equal, bit for bit."""
    arch = "seamless_m4t_medium"
    jcfg, params, cfg, model = _pair(arch)
    opt = AdamW(lr=1e-3, warmup=2, total_steps=10)
    state = TrainState(model, opt.init(model))
    stream = SyntheticTokenStream(cfg, 16, 4, accum=1, seed=2)
    state, _ = make_train_step(cfg, opt)(
        state, {k: torch.from_numpy(v) for k, v in stream.batch(0).items()})
    want = to_jax_layout(state)
    assert any(n.startswith("params/encoder/") for n in want)
    assert want["params/encoder/attn/wq"].shape[0] == cfg.n_encoder_layers
    mgr = CheckpointManager(os.path.join(tmp_path, "port"), async_save=False)
    mgr.save(1, state)

    jopt = JAdamW(lr=1e-3, warmup=2, total_steps=10)
    jlike = JTrainState(params, jopt.init(params))
    step, jstate, _ = JCheckpointManager(
        os.path.join(tmp_path, "port")).restore_latest(like=jlike)
    assert step == 1
    flat = _flat_ref(jstate)
    assert sorted(flat) == sorted(want)
    for n, a in want.items():
        np.testing.assert_array_equal(flat[n], a, err_msg=n)

    JCheckpointManager(os.path.join(tmp_path, "ref"),
                       async_save=False).save(2, jstate)
    fresh = _pair(arch)[3]
    fresh_state = TrainState(fresh, opt.init(fresh))
    step, back, _ = CheckpointManager(
        os.path.join(tmp_path, "ref")).restore_latest(like=fresh_state)
    assert step == 2
    got = to_jax_layout(back)
    assert sorted(got) == sorted(want)
    for n, a in want.items():
        np.testing.assert_array_equal(got[n], a, err_msg=n)


# ----------------------------------------------------------------------
# no CUDA path is hidden (the card's check mocked on the CPU)
# ----------------------------------------------------------------------
def test_rmsnorm_on_card_goes_through_the_autograd_function():
    """With the card's path taken, the forward is the kernel's (mocked
    here by its plain version, counted) under grad and without it, never
    ``rmsnorm_ref`` directly, and the closed-form backward equals autograd
    through the plain version: f32 to 1e-5 of the scale, bf16 to one bf16
    step (8e-3 relative)."""
    calls = []

    def fake_kernel(x, scale, eps=1e-6):
        calls.append(torch.is_grad_enabled())
        with torch.no_grad():
            return rmsnorm_ref(x, scale, eps)

    def no_ref(*a, **k):
        raise AssertionError("rmsnorm_ref on the card's path")

    g = torch.Generator().manual_seed(7)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 8e-3)):
        x0 = torch.randn(6, 5, 96, generator=g).to(dtype)
        s0 = torch.randn(96, generator=g) * 0.1 + 1
        gy = torch.randn(6, 5, 96, generator=g).to(dtype)
        x, s = x0.clone().requires_grad_(True), s0.clone().requires_grad_(True)
        with mock.patch.object(rms_ops, "on_card", lambda t: True), \
                mock.patch.object(rms_ops, "rmsnorm_cuda", fake_kernel), \
                mock.patch.object(rms_ops, "rmsnorm_ref", no_ref):
            y = rms_ops.rmsnorm(x, s)
            y.backward(gy)
            with torch.no_grad():
                rms_ops.rmsnorm(x0, s0)
        xr, sr = x0.clone().requires_grad_(True), s0.clone().requires_grad_(
            True)
        yr = rmsnorm_ref(xr, sr)
        yr.backward(gy)
        assert torch.equal(y.detach(), yr.detach())
        _close_scaled(x.grad.float().numpy(), xr.grad.float().numpy(), tol)
        _close_scaled(s.grad.numpy(), sr.grad.numpy(), tol)
    assert calls == [False, False] * 2     # the forward ran outside autograd


@pytest.mark.parametrize("kernel", ["flash", "wkv6"])
def test_kernels_without_backward_raise_under_grad_on_card(kernel):
    """A CUDA flash call that autograd would need a gradient of raises and
    names ROADMAP.md; without grad it reaches the kernel.  WKV6 has its
    backward kernel: under grad a CUDA call goes through ``WKV6Fn``, which
    launches the forward that keeps states once and, in the backward pass,
    the backward once; no plain version runs, and the gradient is
    autograd's through the plain loop."""
    g = torch.Generator().manual_seed(8)
    if kernel == "flash":
        launched = []
        args = [torch.randn(1, 8, 2, 16, generator=g) for _ in range(3)]
        with mock.patch.object(flash_ops, "on_card", lambda t: True), \
                mock.patch.object(flash_ops, "flash_attention_cuda",
                                  lambda *a, **k: launched.append(1)):
            flash_ops.flash_attention(*args)
            assert launched == [1]
            args[0].requires_grad_(True)
            with pytest.raises(RuntimeError, match="ROADMAP.md"):
                flash_ops.flash_attention(*args)
            with torch.no_grad():
                flash_ops.flash_attention(*args)
        assert launched == [1, 1]
        return
    args = [torch.randn(1, 20, 2, 16, generator=g) for _ in range(3)] + [
        torch.rand(1, 20, 2, 16, generator=g) * 0.5 + 0.4,
        torch.randn(2, 16, generator=g), torch.randn(1, 2, 16, 16,
                                                     generator=g) * 0.1]
    gy = torch.randn(1, 20, 32, generator=g)
    plain, plain_saving, plain_bwd = (wkv_ops.wkv6_plain,
                                      wkv_ops.wkv6_plain_saving,
                                      wkv_ops.wkv6_bwd_plain)
    launched = []

    def kernel_of(name, fn):
        def run(*a):
            launched.append(name)
            with torch.no_grad():
                return fn(*a)
        return run

    def no_plain(*a):
        raise AssertionError("a plain WKV6 version on the card's path")
    with mock.patch.object(wkv_ops, "on_card", lambda t: True), \
            mock.patch.object(wkv_ops, "wkv6_cuda", kernel_of("fwd", plain)), \
            mock.patch.object(wkv_ops, "wkv6_cuda_saving",
                              kernel_of("fwd_save", plain_saving)), \
            mock.patch.object(wkv_ops, "wkv6_bwd_cuda",
                              kernel_of("bwd", plain_bwd)), \
            mock.patch.object(wkv_ops, "wkv6_plain", no_plain), \
            mock.patch.object(wkv_ops, "wkv6_plain_saving", no_plain), \
            mock.patch.object(wkv_ops, "wkv6_bwd_plain", no_plain):
        wkv_ops.wkv6(*args)
        assert launched == ["fwd"]
        leaves = [a.clone().requires_grad_(True) for a in args]
        y, _ = wkv_ops.wkv6(*leaves)
        assert launched == ["fwd", "fwd_save"]
        y.backward(gy)
        assert launched == ["fwd", "fwd_save", "bwd"]
        with torch.no_grad():
            wkv_ops.wkv6(*leaves)
    assert launched == ["fwd", "fwd_save", "bwd", "fwd"]
    ref = [a.clone().requires_grad_(True) for a in args]
    plain(*ref)[0].backward(gy)
    for leaf, r in zip(leaves, ref):
        _close_scaled(leaf.grad.numpy(), r.grad.numpy(), 1e-5)
