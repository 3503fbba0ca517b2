"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding``): the cases of ``tests/test_sharding_rules.py``
on the port, then every config of ``ARCH_IDS`` at full size on the
production meshes and a toy one, parameter and cache specs compared leaf by
leaf.  Specs need only axis sizes: the reference's side runs on
``jax.sharding.AbstractMesh`` under ``jax.eval_shape``, the port's on a
mapping of axis sizes and a model built on the ``meta`` device, so nothing
is allocated."""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import LM, init_cache
from repro_torch.models.convert import reference_path
from repro_torch.sharding.context import shard_activations, use_weight
from repro_torch.sharding.rules import (_param_rule, batch_spec,
                                        cache_sharding, dp_axes, fit_spec,
                                        param_sharding)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def _axes(name):
    shape, names = MESHES[name]
    return dict(zip(names, shape))


def _abstract(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names)


def test_fit_spec_divisibility_and_param_rules():
    mesh = {"data": 2, "model": 4}
    # divisibility guard drops non-dividing axes
    assert fit_spec(("data", "model"), (8, 12), mesh) == ("data", "model")
    assert fit_spec(("data", "model"), (7, 12), mesh) == (None, "model")
    assert fit_spec(("data", "model"), (8, 13), mesh) == ("data", None)
    # tuple axes
    assert fit_spec((("data", "model"), None), (16, 3), mesh) == \
        (("data", "model"), None)
    assert fit_spec((("data", "model"), None), (12, 3), mesh) == \
        (None, None)
    # param rules: FSDP+TP on matrices, replicate vectors
    assert _param_rule("blocks.ffn.w_in", (64, 128), mesh, "data") == \
        ("data", "model")
    assert _param_rule("blocks.ffn.w_out", (128, 64), mesh, "data") == \
        ("model", "data")
    assert _param_rule("blocks.ln1.scale", (64,), mesh, "data") == (None,)
    # MoE expert weights: EP when expert count divides
    assert _param_rule("moe.w_in", (4, 64, 32), mesh, "data") == \
        ("model", "data", None)
    assert _param_rule("moe.w_in", (6, 64, 32), mesh, "data") == \
        (None, "data", "model")
    assert dp_axes(mesh) == "data"
    assert dp_axes({"pod": 2, "data": 16, "model": 16}) == ("pod", "data")


def test_use_weight_noop_outside_mesh():
    w = torch.ones((8, 8))
    assert use_weight(w, (None, "model")) is w
    assert shard_activations(w) is w


def test_cache_sharding_kv_head_fallback():
    mesh = {"data": 2, "model": 4}
    cache = [{"k": torch.zeros((8, 16, 4, 8)),     # Hkv=4 divides tp=4
              "v": torch.zeros((8, 16, 3, 8))}]    # Hkv=3 -> hd fallback
    sh = cache_sharding(cache, mesh)
    assert sh[0]["k"].spec[2] == "model"
    assert sh[0]["v"].spec[2] is None and sh[0]["v"].spec[3] == "model"


def _ref_specs(tree_sharding):
    """{"/"-joined reference path: spec tuple} of a NamedSharding tree."""
    out = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(tree_sharding):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join(keys)] = tuple(sh.spec)
    return out


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_and_cache_specs_match_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.models import init_cache as ref_init_cache
    from repro.models import init_lm as ref_init_lm
    from repro.sharding.rules import cache_sharding as ref_cache_sharding
    from repro.sharding.rules import param_sharding as ref_param_sharding

    cfg = get_config(arch)
    rcfg = ref_config(arch)
    ref_params = jax.eval_shape(lambda: ref_init_lm(jax.random.PRNGKey(0),
                                                    rcfg))
    B, S = 32, 64
    cross = 16 if cfg.n_encoder_layers else 0
    ref_cache = jax.eval_shape(lambda: ref_init_cache(rcfg, B, S, cross))
    model = LM(cfg, torch.device("meta"))
    cache = init_cache(cfg, B, S, "meta", cross_len=cross)
    n_kinds = len(ref_cache)
    checked = 0
    for mesh_name in MESHES:
        axes, amesh = _axes(mesh_name), _abstract(mesh_name)
        ref_p = _ref_specs(ref_param_sharding(ref_params, amesh))
        shapes = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path): leaf.shape
                  for path, leaf in jax.tree_util.tree_leaves_with_path(
                      ref_params)}
        for name, sh in param_sharding(model, axes).items():
            path, g = reference_path(cfg, name)
            want = _pad(ref_p[path], len(shapes[path]))
            if g is not None:            # stacked: the inner spec
                assert want[0] is None, (path, want)
                want = want[1:]
            assert _pad(sh.spec, len(want)) == want, (mesh_name, name)
            checked += 1
        ref_c = {}
        for path, sh in jax.tree_util.tree_leaves_with_path(
                ref_cache_sharding(ref_cache, amesh)):
            ref_c[(path[0].idx, str(path[-1].key))] = tuple(sh.spec)
        for layer, entry in enumerate(cache_sharding(cache, axes)):
            flat = dict(entry)
            flat.update(flat.pop("mamba", {}))
            for key, sh in flat.items():
                want = ref_c[(layer % n_kinds, key)]
                assert want[0] is None
                want = _pad(want[1:], len(sh.spec))
                assert _pad(sh.spec, len(want)) == want, \
                    (mesh_name, layer, key)
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_spec_matches_reference(mesh_name, seq_shard):
    from repro.sharding.rules import batch_spec as ref_batch_spec
    ref = ref_batch_spec(_abstract(mesh_name), seq_shard=seq_shard)
    got = batch_spec(_axes(mesh_name), seq_shard=seq_shard)
    assert got == {k: tuple(v) for k, v in ref.items()}
