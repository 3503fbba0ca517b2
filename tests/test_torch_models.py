"""Model parity: the port's dense LM against ``repro.models`` on reduced
configs, with the reference's own weights carried over by
``from_jax_params``.

Both frameworks run bf16 activations, so logits are compared at
rtol = atol = 2e-2 (the logit scale of these random models is about 0.5),
and the bf16 caches as ``_cache_close`` states."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro.models import (forward_decode as jdecode,
                          forward_prefill as jprefill, init_cache as jcache,
                          init_lm as jinit)
from repro_torch.configs import get_config
from repro_torch.models import (attention as TA, forward_decode,
                                forward_prefill, from_jax_params, init_cache,
                                init_lm, layer_kinds)

TOL = dict(rtol=2e-2, atol=2e-2)
DENSE = ["qwen3_32b", "gemma3_12b", "starcoder2_15b", "nemotron_4_340b"]


def _pair(arch):
    jcfg = jget_config(arch, reduced=True)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(arch, reduced=True)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu")
    return jcfg, params, cfg, model


def _cache_close(cfg, tcache, jc):
    """Port cache (a list per layer) against the reference's stacked one:
    layer g * len(kinds) + i is group g of kind entry i.

    The caches hold bf16 keys and values of magnitude up to about 3.3, where
    one bf16 step is 0.0156, after up to six bf16 layers whose elementwise
    ops the two frameworks round differently: elementwise they agree within
    three such steps (5e-2), and to 1% in norm."""
    nk = len(layer_kinds(cfg))
    for layer, c in enumerate(tcache):
        g, i = divmod(layer, nk)
        for name in ("k", "v"):
            got = c[name].float().numpy()
            want = np.asarray(jc[i][name][g], np.float32)
            np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
            assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, use_flash):
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


def test_long_prefill_takes_the_chunked_path_and_matches_jax():
    """S >= CHUNKED_THRESHOLD without flash: blocked online softmax."""
    jcfg, params, cfg, model = _pair("qwen3_32b")
    S = TA.CHUNKED_THRESHOLD
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (1, S)).astype(
        np.int32)
    jl, _ = jprefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                     jcache(jcfg, 1, S))
    tl, _ = forward_prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                            init_cache(cfg, 1, S, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("window,softcap,causal", [
    (0, 0.0, True), (100, 0.0, True), (0, 30.0, True), (64, 0.0, False)])
def test_sdpa_chunked_matches_jax(window, softcap, causal):
    cfg = dataclasses.replace(get_config("qwen3_32b", reduced=True),
                              logit_softcap=softcap)
    jcfg = dataclasses.replace(jget_config("qwen3_32b", reduced=True),
                               logit_softcap=softcap)
    rng = np.random.RandomState(3)
    xs = [rng.standard_normal((2, 256, n, 16)).astype(np.float32)
          for n in (4, 2, 2)]
    kw = dict(causal=causal, window=window, q_chunk=64, kv_chunk=128)
    want = JA._sdpa_chunked(jcfg, *(jnp.asarray(x, jnp.bfloat16)
                                    for x in xs), **kw)
    got = TA._sdpa_chunked(cfg, *(torch.from_numpy(x).to(torch.bfloat16)
                                  for x in xs), **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_from_jax_params_holds_exactly_the_reference_values(arch):
    jcfg, params, cfg, model = _pair(arch)
    kinds = layer_kinds(cfg)
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["embed"]))
    for layer, blk in enumerate(model.blocks):
        g, i = divmod(layer, len(kinds))
        src = params["blocks"][i]
        assert blk.kind == kinds[i]
        for mod, group in ((blk.attn, "attn"), (blk.ffn, "ffn"),
                           (blk.ln1, "ln1"), (blk.ln2, "ln2")):
            for name, value in src[group].items():
                np.testing.assert_array_equal(
                    getattr(mod, name).numpy(), np.asarray(value[g]))
    n_ref = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_init_lm_draws_the_reference_distributions():
    cfg = get_config("qwen3_32b", reduced=True)
    a = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a.embed, b.embed) and not torch.equal(a.embed, c.embed)
    assert abs(float(a.embed.std()) - 0.02) < 2e-3
    w_out = torch.cat([blk.ffn.w_out.flatten() for blk in a.blocks])
    assert abs(float(w_out.std()) / (0.02 / np.sqrt(2 * cfg.n_layers))
               - 1) < 0.1
    assert all(torch.equal(blk.ln1.scale, torch.ones_like(blk.ln1.scale))
               for blk in a.blocks)
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in a.parameters())
