"""MoE parity: the port's ``models.moe`` and the MoE LMs (reduced dbrx and
qwen2-moe) against ``repro.models`` on the same inputs, with the
reference's weights carried over by ``from_jax_params``.

Routing is compared for equality: expert ids, the kept mask and every
routed token's slot, including a config that drops tokens (capacity factor
1.25).  Outputs: float32 within rtol 1e-5 (float32 sums in another order
in the two frameworks' einsums); bf16 within 2e-2 of the output scale (the
two frameworks round the bf16 activations at different places, a few bf16
steps of 2**-8).  The aux losses within 1e-5.  Logits, caches and served
tokens at the tolerances of ``test_torch_models.py`` and
``test_torch_serving.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JMOE
from repro.configs import get_config as jget_config
from repro.models import (forward_decode as jdecode,
                          forward_prefill as jprefill, init_cache as jcache,
                          init_lm as jinit)
from repro.runtime.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.models import (forward_decode, forward_prefill,
                                from_jax_params, init_cache, init_lm,
                                layer_kinds)
from repro_torch.models import moe as TMOE
from repro_torch.runtime.serving import ServingEngine
from test_torch_serving import _greedy_steps

MOE_ARCHS = ["qwen2_moe_a2_7b", "dbrx_132b"]
TOL = dict(rtol=2e-2, atol=2e-2)     # test_torch_models.py's logit tolerance
LOGIT_TOL = 2e-2                     # test_torch_serving.py's
AUX_TOL = 1e-5


def _pair(arch, **moe_changes):
    """The reference's reduced model and the port's with its weights;
    ``moe_changes`` replace fields of the MoE config in both."""
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if moe_changes:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
    params = jinit(jax.random.PRNGKey(0), jcfg)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu")
    return jcfg, params, cfg, model


def _reference_moe(monkeypatch, jcfg, p, x):
    """``repro.models.moe.apply_moe`` run eagerly, with its top-k and its
    routed slots recorded on the way (the reference returns neither)."""
    seen = {}
    top_k = jax.lax.top_k

    def record_top_k(probs, k):
        seen["gates"], seen["expert_ids"] = top_k(probs, k)
        return seen["gates"], seen["expert_ids"]

    def record_shard(a, *args, **kw):
        if jnp.issubdtype(a.dtype, jnp.integer):
            seen["slot"] = a
        return a

    monkeypatch.setattr(jax.lax, "top_k", record_top_k)
    monkeypatch.setattr(JMOE, "shard_activations", record_shard)
    out, aux = JMOE.apply_moe(jcfg, p, x)
    return out, aux, seen


CASES = {
    # the reduced config: capacity factor = n_experts, no token dropped
    "reduced": dict(S=16, moe={}),
    # capacity factor 1.25 at S = 64: cap 20 slots for 16 tokens an
    # expert on average, so the busiest experts drop tokens
    "drops": dict(S=64, moe=dict(capacity_factor=1.25)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_jax(monkeypatch, case, dtype):
    S, changes = CASES[case]["S"], CASES[case]["moe"]
    jcfg, params, cfg, model = _pair("qwen2_moe_a2_7b", **changes)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"][0]["moe"])
    tp = model.blocks[0].moe
    x = np.random.RandomState(7).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, jaux, seen = _reference_moe(monkeypatch, jcfg, jp, jx)
    got, taux = TMOE.apply_moe(cfg, tp, tx)
    r = TMOE.route(cfg, tp.router, tx)

    # Routing: equal, not close.
    B, E, cap = 2, cfg.moe.n_experts, r["cap"]
    np.testing.assert_array_equal(r["expert_ids"].numpy(),
                                  np.asarray(seen["expert_ids"]))
    np.testing.assert_array_equal(r["slot"].numpy(), np.asarray(seen["slot"]))
    keep = np.asarray(seen["slot"]) < E * cap
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    np.testing.assert_array_equal(taux["moe_kept"].numpy(), keep.sum(1))
    top = np.asarray(seen["gates"])              # before renormalising
    np.testing.assert_allclose(r["gates"].numpy(),
                               top / (top.sum(-1, keepdims=True) + 1e-9),
                               rtol=1e-5)
    n_kept = int(keep.sum())
    if case == "drops":
        assert 0 < n_kept < B * S * cfg.moe.top_k, n_kept
    else:
        assert n_kept == B * S * cfg.moe.top_k

    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape == (B, S, cfg.d_model)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    for name in ("moe_aux", "moe_z"):
        assert abs(float(taux[name]) - float(jaux[name])) <= AUX_TOL, name


def _cache_close(cfg, tcache, jc):
    """Port cache (a list per layer) against the reference's stacked one,
    at ``test_torch_models._cache_close``'s tolerance: bf16 keys and values
    within three bf16 steps elementwise and 1% in norm."""
    nk = len(layer_kinds(cfg))
    for layer, c in enumerate(tcache):
        g, i = divmod(layer, nk)
        for name in ("k", "v"):
            got = c[name].float().numpy()
            want = np.asarray(jc[i][name][g], np.float32)
            np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
            assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(arch, use_flash):
    jcfg, params, cfg, model = _pair(arch)
    B, S, steps = 2, 32, 3
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (B, S)).astype(
        np.int32)
    jc = jcache(jcfg, B, S + 4)
    jl, jc = jprefill(jcfg, params, {"tokens": jnp.asarray(toks)}, jc,
                      use_flash=use_flash)
    tc = init_cache(cfg, B, S + 4, "cpu")
    tl, tc = forward_prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                             tc, use_flash=use_flash)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _cache_close(cfg, tc, jc)
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = jdecode(jcfg, params, jnp.asarray(nxt), jc,
                         jnp.int32(S + i))
        tl, tc = forward_decode(cfg, model, torch.from_numpy(nxt), tc, S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _cache_close(cfg, tc, jc)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serving_engine_matches_jax_engine(arch):
    """The port's engine against the reference's on 8 requests (the last
    repeats the first), as ``test_torch_serving.py`` holds qwen3."""
    batch, new = 2, 6
    jcfg, params, cfg, model = _pair(arch)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, 16) for _ in range(7)]
    prompts.append(prompts[0].copy())
    eng = ServingEngine(cfg, model, batch_size=batch, max_new_tokens=new,
                        device="cpu")
    try:
        got = [eng.submit(p) for p in prompts]
        eng.flush()
        assert len(eng.collect()) == len(prompts)
    finally:
        eng.close()
    jeng = JServingEngine(jcfg, params, batch_size=batch, max_new_tokens=new)
    try:
        want = [jeng.submit(p) for p in prompts]
        jeng.flush()
        jeng.collect()
    finally:
        jeng.close()
    np.testing.assert_array_equal(got[0].result, got[-1].result)
    compared = 0
    for b in range(0, len(prompts), batch):
        toks = np.stack([p.astype(np.int32) for p in prompts[b:b + batch]])
        margins, diffs = _greedy_steps(jcfg, params, cfg, model, toks, new)
        assert diffs.max() <= LOGIT_TOL
        # Tokens can only flip where the reference's top-2 margin is under
        # twice the largest logit difference: compare up to that step.
        tol = 2 * diffs.max()
        for j, row in zip(range(b, b + batch), margins):
            upto = next((i for i, m in enumerate(row) if m <= tol), new)
            np.testing.assert_array_equal(got[j].result[:upto],
                                          want[j].result[:upto])
            compared += upto
    assert compared >= len(prompts) * new // 2, compared


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_from_jax_params_carries_the_moe_weights_exactly(arch):
    jcfg, params, cfg, model = _pair(arch)
    for layer, blk in enumerate(model.blocks):
        src = params["blocks"][0]["moe"]
        assert not hasattr(blk, "ffn")
        for name in ("router", "w_in", "w_gate", "w_out"):
            np.testing.assert_array_equal(getattr(blk.moe, name).numpy(),
                                          np.asarray(src[name][layer]))
        assert blk.moe.router.dtype == torch.float32
        if cfg.moe.n_shared_experts:
            for name, value in src["shared"].items():
                np.testing.assert_array_equal(
                    getattr(blk.moe.shared, name).numpy(),
                    np.asarray(value[layer]))
        else:
            assert blk.moe.shared is None
    n_ref = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_lm_builds_the_moe_family(arch):
    cfg = get_config(arch, reduced=True)
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    e = cfg.moe
    moe = model.blocks[0].moe
    assert moe.w_in.shape == (e.n_experts, cfg.d_model, e.d_ff_expert)
    assert moe.w_out.shape == (e.n_experts, e.d_ff_expert, cfg.d_model)
    assert abs(float(moe.w_in.std()) - 0.02) < 2e-3
    assert moe.router.shape == (cfg.d_model, e.n_experts)
    if e.n_shared_experts:
        assert moe.shared.w_in.shape == (
            cfg.d_model, e.d_ff_expert * e.n_shared_experts)
    assert all(not hasattr(blk, "ffn") for blk in model.blocks)
