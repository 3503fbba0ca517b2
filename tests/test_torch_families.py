"""The hybrid (hymba), encoder-decoder (seamless) and vision-stub (internvl)
families of the port against ``repro.models`` on reduced configs, with the
reference's own weights carried over by ``from_jax_params``; and every
config of ``ARCH_IDS`` through the port's train, prefill and decode.

Tolerances: logits at rtol = atol = 2e-2 (bf16 activations in both
frameworks, logit scale about 0.5), as ``test_torch_models.py``; bf16 KV and
cross caches as its ``_cache_close`` (three bf16 steps elementwise, 1% in
norm); the float32 Mamba state, driven by bf16 activations that the two
frameworks round apart, within 3e-2 of its scale elementwise and 2% in
norm, as ``test_torch_mamba.py`` holds the bf16 state (there 0.8% to 1.3%
of the scale elementwise; here up to 1.3% in norm after the prefill); the
conv window holds bf16 values cast to float32, so it is held as the KV
caches are."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import (forward_decode as jdecode,
                          forward_prefill as jprefill, init_cache as jcache,
                          init_lm as jinit)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import (forward_decode, forward_prefill,
                                forward_train, from_jax_params, init_cache,
                                init_lm, layer_kinds)
from repro_torch.models.convert import reference_path

TOL = dict(rtol=2e-2, atol=2e-2)
FAMILIES = ["hymba_1_5b", "seamless_m4t_medium", "internvl2_76b"]
B = 2


def _pair(arch):
    jcfg = jget_config(arch, reduced=True)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    cfg = get_config(arch, reduced=True)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            "cpu")
    return jcfg, params, cfg, model


def _batch(cfg, S, seed=1):
    """tokens, plus frames (S // 4 of them) or patches (scaled 0.02) as
    the reference's launcher makes them."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_encoder_layers:
        batch["frames"] = rng.randn(B, S // 4, cfg.d_model).astype(
            np.float32)
    if cfg.frontend == "vision":
        batch["patches"] = rng.randn(B, cfg.n_frontend_tokens,
                                     cfg.d_model).astype(np.float32) * 0.02
    return batch


def _cross_len(cfg, batch):
    return batch["frames"].shape[1] if "frames" in batch else 0


def _close_bf16(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def _cache_close(cfg, tcache, jc):
    """Port cache (a list per layer) against the reference's stacked one:
    KV and cross caches, and hymba's Mamba state."""
    nk = len(layer_kinds(cfg))
    for layer, c in enumerate(tcache):
        g, i = divmod(layer, nk)
        for name in ("k", "v", "cross_k", "cross_v"):
            if name in c:
                _close_bf16(c[name], jc[i][name][g])
        if "mamba" in c:
            h = c["mamba"]["h"].numpy()
            want = np.asarray(jc[i]["mamba"]["h"][g])
            assert c["mamba"]["h"].dtype == torch.float32
            assert c["mamba"]["conv"].dtype == torch.float32
            assert float(np.abs(h - want).max()) <= 3e-2 * float(
                np.abs(want).max())
            assert np.linalg.norm(h - want) <= 2e-2 * np.linalg.norm(want)
            _close_bf16(c["mamba"]["conv"].numpy(),
                        jc[i]["mamba"]["conv"][g])


def _prefill_and_decode(arch, use_flash, S, steps=3):
    jcfg, params, cfg, model = _pair(arch)
    batch = _batch(cfg, S)
    cross = _cross_len(cfg, batch)
    jc = jcache(jcfg, B, S + steps + 1, cross_len=cross)
    jl, jc = jprefill(jcfg, params, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jc,
                      use_flash=use_flash)
    tc = init_cache(cfg, B, S + steps + 1, "cpu", cross_len=cross)
    tl, tc = forward_prefill(cfg, model, {k: torch.from_numpy(v)
                                          for k, v in batch.items()}, tc,
                             use_flash=use_flash)
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
    return cfg, tc


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_jax(arch, use_flash):
    cfg, tc = _prefill_and_decode(arch, use_flash, S=32)
    if arch == "hymba_1_5b":
        assert all(c["k"].shape[1] == cfg.sliding_window for c in tc)
    if arch == "seamless_m4t_medium":
        assert all(c["cross_k"].shape == (B, 8, cfg.n_kv_heads, cfg.hd)
                   for c in tc)


@pytest.mark.parametrize("S", [16, 37])
def test_hymba_ring_buffer_matches_jax(S):
    """A prompt as long as the window (16) and one that wraps the ring
    buffer past a whole turn (37 = 2 x 16 + 5: prefill's roll by S % W),
    then decode steps that overwrite slots."""
    cfg, tc = _prefill_and_decode("hymba_1_5b", False, S=S, steps=4)
    assert tc[0]["k"].shape[1] == cfg.sliding_window


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_full_forward(arch):
    """Prefill over S tokens then one decode step equal the full forward
    over S + 1 tokens at positions S - 1 and S: KV-cache indexing, RWKV and
    Mamba state carrying, sliding windows and the cross caches in one
    shot (the port against itself)."""
    cfg = get_config(arch, reduced=True)
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    S = 32
    full = {k: torch.from_numpy(v) for k, v in _batch(cfg, S + 1).items()}
    if "frames" in full:
        full["frames"] = full["frames"][:, :S // 4]
    with torch.no_grad():
        logits, _ = forward_train(cfg, model, full)
    assert logits.shape == (B, S + 1, cfg.vocab)
    assert torch.isfinite(logits).all()
    prefix = dict(full, tokens=full["tokens"][:, :S])
    cache = init_cache(cfg, B, S + 4, "cpu",
                       cross_len=_cross_len(cfg, prefix))
    lg, cache = forward_prefill(cfg, model, prefix, cache)
    np.testing.assert_allclose(lg.numpy(), logits[:, S - 1].numpy(), **TOL)
    lg, _ = forward_decode(cfg, model, full["tokens"][:, S:S + 1], cache, S)
    np.testing.assert_allclose(lg.numpy(), logits[:, S].numpy(), **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_from_jax_params_holds_exactly_the_reference_values(arch):
    """Every leaf of the reference's tree, found by ``reference_path`` of
    the port's parameter name (blocks, encoder layers, norms, the frontend
    projection), equal; the counts equal."""
    jcfg, params, cfg, model = _pair(arch)
    flat = {}
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)] = np.asarray(v)
    seen = set()
    for name, p in model.named_parameters():
        path, g = reference_path(cfg, name)
        want = flat[path] if g is None else flat[path][g]
        np.testing.assert_array_equal(p.numpy(), want, err_msg=name)
        seen.add(path)
    assert seen == set(flat)
    n_ref = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    groups = {"hymba_1_5b": "mamba", "seamless_m4t_medium": "cross",
              "internvl2_76b": "frontend_proj"}
    assert any(groups[arch] in n for n, _ in model.named_parameters())


def test_short_prompt_with_patches_raises():
    cfg = get_config("internvl2_76b", reduced=True)
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    P = cfg.n_frontend_tokens
    batch = {"tokens": torch.zeros((B, P - 1), dtype=torch.int32),
             "patches": torch.zeros((B, P, cfg.d_model))}
    with pytest.raises(ValueError, match="patch embeddings"):
        forward_prefill(cfg, model, batch,
                        init_cache(cfg, B, P + 4, "cpu"))
    # a prompt as long as the patches is taken
    batch["tokens"] = torch.zeros((B, P), dtype=torch.int32)
    lg, _ = forward_prefill(cfg, model, batch,
                            init_cache(cfg, B, P + 4, "cpu"))
    assert torch.isfinite(lg).all()


def test_patches_take_the_first_positions():
    """The patch embeddings replace the first positions: the logits differ
    from a tokens-only prefill, and a token after them still counts."""
    cfg = get_config("internvl2_76b", reduced=True)
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 16).items()}
    with torch.no_grad():
        with_p, _ = forward_train(cfg, model, batch)
        without, _ = forward_train(cfg, model, {"tokens": batch["tokens"]})
    assert not torch.allclose(with_p[:, -1], without[:, -1])
    # changing a token under a patch changes nothing
    toks = batch["tokens"].clone()
    toks[:, 0] = (toks[:, 0] + 1) % cfg.vocab
    with torch.no_grad():
        moved, _ = forward_train(cfg, model, dict(batch, tokens=toks))
    assert torch.equal(moved, with_p)


def test_init_cache_takes_cross_len_by_keyword_only():
    cfg = get_config("seamless_m4t_medium", reduced=True)
    with pytest.raises(TypeError):
        init_cache(cfg, B, 8, "cpu", torch.bfloat16, 4)
    c = init_cache(cfg, B, 8, "cpu", cross_len=4)
    assert c[0]["cross_k"].shape == (B, 4, cfg.n_kv_heads, cfg.hd)
    assert c[0]["cross_k"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", FAMILIES)
def test_reference_ndim_stacks_blocks_and_encoder(arch):
    """AdamW's rank rule: every block and encoder leaf has the reference's
    stacked rank (a norm scale is a matrix there)."""
    jcfg, params, cfg, model = _pair(arch)
    flat = {}
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)] = np.asarray(v)
    for name, _ in model.named_parameters():
        assert model.reference_ndim(name) == flat[
            reference_path(cfg, name)[0]].ndim, name


def _logits_by_depth(jcfg, params, cfg, model, toks, patches, depths):
    """Both packages' last-token logits read out (final norm and head)
    after each of ``depths`` blocks, with the residual stream in float32
    and in bf16: {(package, dtype, depth): (B, V) float32}."""
    from repro.models import transformer as JT
    from repro.models.layers import apply_norm
    from repro_torch.models import transformer as T
    S = toks.shape[1]
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        x = JT._embed(jcfg, params, jnp.asarray(toks),
                      jnp.asarray(patches)).astype(jdt)
        aux = (jnp.float32(0), jnp.float32(0))
        for i in range(jcfg.n_layers):
            p = jax.tree_util.tree_map(lambda a: a[i], params["blocks"][0])
            x, aux, _ = JT.apply_block_seq(jcfg, "attn_global", p, x,
                                           jnp.arange(S)[None], aux)
            if i + 1 in depths:
                h = apply_norm(jcfg, params["final_norm"], x[:, -1:])
                out["ref", name, i + 1] = np.asarray(
                    JT._logits(jcfg, params, h)[:, 0])
        with torch.no_grad():
            x = T._embed(cfg, model, torch.from_numpy(toks),
                         torch.from_numpy(patches)).to(tdt)
            for i, blk in enumerate(model.blocks):
                x = T.apply_block_seq(cfg, blk, x, torch.arange(S)[None])
                if i + 1 in depths:
                    out["port", name, i + 1] = T._logits(
                        cfg, model, model.final_norm(x[:, -1:]))[:, 0].numpy()
    return out


def test_bf16_drift_at_full_width_gain_matches_reference():
    """internvl's bf16 logits drift far from float32 ones with depth at
    full width: the random N(0, 0.02²) weights give each projection a gain
    of 0.02·sqrt(fan-in), 1.8 at d 8192.  At d 1024 with every matrix but
    the embedding scaled by sqrt(8192 / 1024), so that each has its
    full-width gain (hd 128 as there), bf16 weights, 1024 tokens of which
    256 are patches, the reference drifts as the port does: the port's
    bf16-vs-float32 drift lies within a factor of 1.5 of the reference's
    at each depth, and after 8 layers both exceed 10% of the logit scale
    (run with ``-s`` for the numbers), while the float32 paths agree within
    1e-3 of it."""
    import dataclasses
    d, P, S, depths = 1024, 256, 1024, (1, 2, 4, 8)
    kw = dict(n_layers=8, d_model=d, n_heads=8, n_kv_heads=1, d_ff=3584,
              vocab=2048, head_dim=128, n_frontend_tokens=P)
    jcfg = dataclasses.replace(jget_config("internvl2_76b", reduced=True),
                               **kw)
    cfg = dataclasses.replace(get_config("internvl2_76b", reduced=True), **kw)
    gain = (8192 / d) ** 0.5
    params = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)

    def full_width_gain(path, a):
        name = jax.tree_util.keystr(path)
        matrix = a.ndim == (3 if "blocks" in name else 2)
        if not matrix or "embed" in name:
            return a
        return (a.astype(jnp.float32) * gain).astype(jnp.bfloat16)
    params = jax.tree_util.tree_map_with_path(full_width_gain, params)
    model = from_jax_params(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params), cfg, "cpu")
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    patches = rng.randn(B, P, d).astype(np.float32) * 0.02
    out = _logits_by_depth(jcfg, params, cfg, model, toks, patches, depths)
    for n in depths:
        scale = np.abs(out["ref", "f32", n]).max()
        drift = {pkg: np.abs(out[pkg, "bf16", n]
                             - out[pkg, "f32", n]).max() / scale
                 for pkg in ("ref", "port")}
        f32_gap = np.abs(out["port", "f32", n] - out["ref", "f32", n]).max()
        print(f"{n} layers: bf16 drift from float32, reference "
              f"{drift['ref']:.3e}, port {drift['port']:.3e} of the logit "
              f"scale; float32 port vs reference {f32_gap / scale:.3e}")
        assert f32_gap <= 1e-3 * scale
        assert drift["ref"] / 1.5 <= drift["port"] <= 1.5 * drift["ref"]
    assert min(drift.values()) > 0.1
