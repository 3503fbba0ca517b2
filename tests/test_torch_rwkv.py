"""RWKV6 parity: the port's WKV6 wrapper, its RWKV layers and the reduced
``rwkv6_1_6b`` against ``repro``, with inputs made by numpy from a seed and
the reference's weights carried over by ``from_jax_params``.

On CPU tensors the port's ``wkv6`` is its plain float32 loop; it must agree
with the Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs
it) and with the JAX ``wkv6_ref`` to 1e-5 in float32, and it must not
count a launch.  The hand-written CUDA kernel runs only on the card:
``tests/test_torch_kernels_cuda.py`` holds it against the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.rwkv6.ops import wkv6 as jwkv6
from repro.kernels.rwkv6.ref import wkv6_ref as jwkv6_ref
from repro.models import (forward_decode as jdecode,
                          forward_prefill as jprefill, init_cache as jcache,
                          init_lm as jinit)
from repro.models import rwkv as JR
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models import (forward_decode, forward_prefill,
                                from_jax_params, init_cache, init_lm,
                                layer_kinds)
from repro_torch.models import rwkv as TR
from repro_torch.runtime import (ServingEngine, make_decode_step,
                                 make_prefill_step)

ARCH = "rwkv6_1_6b"
# float32: the same products in another summation order; 1e-5 as the
# reference's own state-carry test.  bf16: y is rounded to bf16, one step
# of which is 2^-8 relative; the logit tolerance of test_torch_models.py.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _wkv_inputs(B, T, H, hd, seed=0):
    """r, k, v ~ N(0, 0.25); w = exp(-exp(N(0, 0.25))) as the model builds
    it; u ~ N(0, 0.09); a nonzero s0 ~ N(0, 0.01).  All float32 numpy."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, hd)) * 0.5)).astype(
        np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    return r, k, v, w, u, s0


def _to_pair(arrays, dtype):
    """r, k, v in ``dtype``; w, u, s0 in float32 (w is never rounded)."""
    r, k, v, w, u, s0 = arrays
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in (r, k, v)]
    jx += [jnp.asarray(a) for a in (w, u, s0)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (r, k, v)]
    tx += [torch.from_numpy(a) for a in (w, u, s0)]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,hd", [
    (2, 32, 2, 16),     # the reduced config's head dim
    (2, 37, 2, 16),     # ragged T
    (1, 24, 2, 64),     # rwkv6_1_6b's head dim
    (2, 1, 3, 32),      # T = 1
])
def test_wkv6_matches_jax(B, T, H, hd, dtype):
    jx, tx = _to_pair(_wkv_inputs(B, T, H, hd), dtype)
    before = ops.launches
    y, sT = ops.wkv6(*tx)
    assert ops.launches == before            # the CPU path never counts
    assert y.dtype == tx[0].dtype and y.shape == (B, T, H * hd)
    assert sT.dtype == torch.float32 and sT.shape == (B, H, hd, hd)
    jy, jsT = jwkv6(*jx, chunk=16)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               **tol)
    # The state is float32 from the same (rounded) inputs in both.
    np.testing.assert_allclose(sT.numpy(), np.asarray(jsT), **F32_TOL)

    def flat(a):
        return jnp.swapaxes(a, 1, 2).reshape(B * H, T, hd)
    ry, rsT = jwkv6_ref(*(flat(a) for a in jx[:4]),
                        jnp.tile(jx[4][None], (B, 1, 1)).reshape(B * H, hd),
                        jx[5].reshape(B * H, hd, hd))
    ry = jnp.swapaxes(ry.reshape(B, H, T, hd), 1, 2).reshape(B, T, H * hd)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ry, np.float32),
                               **tol)
    np.testing.assert_allclose(sT.numpy().reshape(B * H, hd, hd),
                               np.asarray(rsT), **F32_TOL)


def test_wkv6_ref_matches_jax_ref_in_bh_layout():
    B, T, H, hd = 2, 20, 2, 16
    r, k, v, w, u, s0 = _wkv_inputs(B, T, H, hd, seed=4)

    def flat(a):
        return np.ascontiguousarray(np.swapaxes(a, 1, 2)).reshape(B * H, T,
                                                                   hd)
    args = [flat(a) for a in (r, k, v, w)]
    args += [np.tile(u[None], (B, 1, 1)).reshape(B * H, hd),
             s0.reshape(B * H, hd, hd)]
    y, sT = wkv6_ref(*(torch.from_numpy(a) for a in args))
    jy, jsT = jwkv6_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(sT.numpy(), np.asarray(jsT), **F32_TOL)


def test_wkv6_state_carry_composes():
    """Two half-sequences with the state carried == one full run, as the
    reference's ``test_wkv6_state_carry_composes``."""
    _, (r, k, v, w, u, s0) = _to_pair(_wkv_inputs(1, 64, 2, 16, seed=2),
                                      "float32")
    y_full, s_full = ops.wkv6(r, k, v, w, u, s0)
    y1, s_mid = ops.wkv6(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u, s0)
    y2, s_end = ops.wkv6(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u,
                         s_mid)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, **F32_TOL)
    torch.testing.assert_close(s_end, s_full, **F32_TOL)


def test_wkv6_cuda_path_refuses_what_it_does_not_take():
    _, tx = _to_pair(_wkv_inputs(1, 8, 2, 16), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv6_cuda(*tx)
    with pytest.raises(ValueError, match="u must be"):
        ops.wkv6(*tx[:4], tx[4][:1], tx[5])
    with pytest.raises(ValueError, match="does not match"):
        ops.wkv6(tx[0], tx[1][:, :4], *tx[2:])


# ----------------------------------------------------------- the layers
def _time_mix_pair(seed=0):
    jcfg = jget_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = JR.init_rwkv(jax.random.PRNGKey(seed), jcfg)
    # ln_x_scale, decay_base and the mixes start as constants: perturb them
    # so that a wrong parameter name or a missed cast would show.
    rng = np.random.RandomState(seed)
    for name in ("ln_x_scale", "decay_base", "mix_r", "mix_w"):
        jp[name] = jp[name] + jnp.asarray(
            rng.standard_normal(jp[name].shape).astype(np.float32) * 0.1)
    tm = TR.TimeMix(cfg, None, "cpu")
    for name, value in jp.items():
        getattr(tm, name).data.copy_(torch.from_numpy(np.array(value)))
    return jcfg, jp, cfg, tm


def _state_pair(cfg, B, seed=1):
    rng = np.random.RandomState(seed)
    hd = cfg.ssm.head_dim
    shift = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    wkv = rng.standard_normal((B, cfg.d_model // hd, hd, hd)).astype(
        np.float32) * 0.1
    return ({"shift": jnp.asarray(shift), "wkv": jnp.asarray(wkv)},
            {"shift": torch.from_numpy(shift), "wkv": torch.from_numpy(wkv)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rwkv_seq_and_step_match_jax(dtype):
    jcfg, jp, cfg, tm = _time_mix_pair()
    B, S = 2, 19
    x = np.random.RandomState(3).standard_normal(
        (B, S + 1, cfg.d_model)).astype(np.float32)
    jst, tst = _state_pair(cfg, B)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # float32: f32 matmuls in two frameworks over d = 64; bf16: BF16_TOL.
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else BF16_TOL
    jy, jst = JR.apply_rwkv_seq(jcfg, jp, jx[:, :S], jst)
    ty, tst = TR.apply_rwkv_seq(cfg, tm, tx[:, :S], tst)
    assert ty.dtype == tx.dtype and ty.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               **tol)
    for name in ("shift", "wkv"):
        assert tst[name].dtype == torch.float32
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   **tol)
    jy, jst = JR.apply_rwkv_step(jcfg, jp, jx[:, S:], jst)
    ty, tst = TR.apply_rwkv_step(cfg, tm, tx[:, S:], tst)
    assert ty.shape == (B, 1, cfg.d_model)
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               **tol)
    for name in ("shift", "wkv"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   **tol)


def test_apply_channel_mix_matches_jax():
    jcfg = jget_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = JR.init_channel_mix(jax.random.PRNGKey(5), jcfg)
    cm = TR.ChannelMix(cfg, None, "cpu")
    for name, value in jp.items():
        getattr(cm, name).data.copy_(torch.from_numpy(np.array(value)))
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    shift = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    jy, jlast = JR.apply_channel_mix(jcfg, jp, jnp.asarray(x),
                                     jnp.asarray(shift))
    ty, tlast = TR.apply_channel_mix(cfg, cm, torch.from_numpy(x),
                                     torch.from_numpy(shift))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


# ------------------------------------------------------------- the model
def _pair(seed=0):
    jcfg = jget_config(ARCH, reduced=True)
    params = jinit(jax.random.PRNGKey(seed), jcfg)
    cfg = get_config(ARCH, reduced=True)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu")
    return jcfg, params, cfg, model


def _states_close(cfg, tcache, jc):
    """The port's per-layer states against the reference's stacked ones.

    ``wkv`` is float32 built from bf16 k and v: 2e-2.  ``shift`` and
    ``cmix_shift`` hold bf16 layernorm outputs of magnitude up to about 4,
    where one bf16 step is 0.0156: within three such steps (5e-2), and 1%
    in norm, as ``test_torch_models._cache_close``."""
    for layer, st in enumerate(tcache):
        for name in ("wkv", "shift", "cmix_shift"):
            got = st[name].numpy()
            want = np.asarray(jc[0][name][layer])
            assert st[name].dtype == torch.float32
            if name == "wkv":
                np.testing.assert_allclose(got, want, **BF16_TOL)
            else:
                np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
                assert np.linalg.norm(got - want) \
                    <= 1e-2 * np.linalg.norm(want)


def test_reduced_rwkv6_prefill_and_decode_match_jax():
    jcfg, params, cfg, model = _pair()
    B, S, steps = 2, 32, 3
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (B, S)).astype(
        np.int32)
    jl, jc = jprefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                      jcache(jcfg, B, S + steps))
    tc = init_cache(cfg, B, S + steps, "cpu")
    tl, tc = forward_prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                             tc)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)
    _states_close(cfg, tc, jc)
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = jdecode(jcfg, params, jnp.asarray(nxt), jc,
                         jnp.int32(S + i))
        tl, tc = forward_decode(cfg, model, torch.from_numpy(nxt), tc, S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)
        _states_close(cfg, tc, jc)


def test_rwkv6_prefill_equals_token_by_token_decode():
    """The recurrence through ``wkv6`` over a whole prompt and the plain
    decode step fed the same prompt one token at a time reach the same
    logits and states (they round the group norm's input differently)."""
    _, _, cfg, model = _pair(seed=2)
    B, S = 2, 12
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab, (B, S)).astype(np.int32))
    want, wc = forward_prefill(cfg, model, {"tokens": toks},
                               init_cache(cfg, B, S, "cpu"))
    got, gc = forward_prefill(cfg, model, {"tokens": toks[:, :1]},
                              init_cache(cfg, B, S, "cpu"))
    for t in range(1, S):
        got, gc = forward_decode(cfg, model, toks[:, t:t + 1], gc, t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **BF16_TOL)
    for a, b in zip(gc, wc):
        np.testing.assert_allclose(a["wkv"].numpy(), b["wkv"].numpy(),
                                   **BF16_TOL)


def test_from_jax_params_holds_exactly_the_reference_values():
    jcfg, params, cfg, model = _pair()
    assert layer_kinds(cfg) == ["rwkv"]
    assert model.lm_head is not None and model.final_norm.kind == "layernorm"
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["embed"]))
    np.testing.assert_array_equal(model.lm_head.numpy(),
                                  np.asarray(params["lm_head"]))
    for name in ("scale", "bias"):
        np.testing.assert_array_equal(
            getattr(model.final_norm, name).numpy(),
            np.asarray(params["final_norm"][name]))
    src = params["blocks"][0]
    assert set(src) == {"ln1", "rwkv", "ln2", "cmix"}
    for layer, blk in enumerate(model.blocks):
        assert blk.kind == "rwkv"
        for group in src:
            for name, value in src[group].items():
                np.testing.assert_array_equal(
                    getattr(getattr(blk, group), name).numpy(),
                    np.asarray(value[layer]))
    n_ref = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_init_lm_draws_the_reference_distributions():
    cfg = get_config(ARCH, reduced=True)
    a = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a.blocks[0].rwkv.wr, b.blocks[0].rwkv.wr)
    assert not torch.equal(a.blocks[0].rwkv.wr, c.blocks[0].rwkv.wr)
    # The reference's init_rwkv / init_channel_mix (rwkv.py:24-45, 160-167).
    jp = JR.init_rwkv(jax.random.PRNGKey(0), jget_config(ARCH, reduced=True))
    for blk in a.blocks:
        tm, cm = blk.rwkv, blk.cmix
        for name, value in jp.items():
            assert tuple(getattr(tm, name).shape) == value.shape, name
        for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w"):
            assert torch.all(getattr(tm, name) == 0.5)
        assert torch.all(tm.decay_base == 0) and torch.all(tm.ln_x_scale == 1)
        assert torch.all(cm.mix_k == 0.5) and torch.all(cm.mix_r == 0.5)
        assert tm.w_decay_a.shape == (cfg.d_model, 32)     # max(32, d // 16)
    for name in ("wr", "wk", "wv", "wg", "wo", "w_decay_a", "w_decay_b"):
        w = torch.cat([getattr(blk.rwkv, name).flatten() for blk in a.blocks])
        assert abs(float(w.std()) / 0.02 - 1) < 0.1, name
    u = torch.cat([blk.rwkv.bonus_u.flatten() for blk in a.blocks])
    assert abs(float(u.std()) / 0.1 - 1) < 0.15
    for name in ("wk", "wv", "wr"):
        w = torch.cat([getattr(blk.cmix, name).flatten() for blk in a.blocks])
        assert abs(float(w.std()) / 0.02 - 1) < 0.1, name
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in a.parameters())


def test_init_cache_builds_float32_rwkv_states():
    cfg = get_config(ARCH, reduced=True)
    cache = init_cache(cfg, 3, 100, "cpu")
    jc = jcache(jget_config(ARCH, reduced=True), 3, 100)
    assert len(cache) == cfg.n_layers
    for st in cache:
        assert set(st) == set(jc[0])
        for name, t in st.items():
            assert t.dtype == torch.float32 and not t.any()
            assert tuple(t.shape) == jc[0][name].shape[1:]


def test_serving_engine_serves_rwkv6_as_a_direct_call():
    _, _, cfg, model = _pair(seed=3)
    batch, new, plen = 2, 5, 12
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab, plen).astype(np.int32)
               for _ in range(5)]
    prompts.append(prompts[1].copy())             # same prompt, later batch
    eng = ServingEngine(cfg, model, batch_size=batch, max_new_tokens=new,
                        device="cpu")
    try:
        reqs = [eng.submit(p) for p in prompts]
        eng.flush()
        assert len(eng.collect()) == len(prompts)
        lanes = eng.stats()["lanes_created"]
    finally:
        eng.close()
    assert lanes >= 2
    np.testing.assert_array_equal(reqs[1].result, reqs[5].result)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    for b in range(0, len(prompts), batch):
        toks = torch.from_numpy(np.stack(prompts[b:b + batch]))
        logits, cache = prefill(model, {"tokens": toks},
                                init_cache(cfg, batch, plen + new, "cpu"))
        nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
        direct = [nxt]
        for i in range(new - 1):
            nxt, _, cache = decode(model, nxt, cache, plen + i)
            direct.append(nxt)
        direct = torch.cat(direct, 1).numpy()
        for j in range(batch):
            assert reqs[b + j].result.shape == (new,)
            np.testing.assert_array_equal(reqs[b + j].result, direct[j])
