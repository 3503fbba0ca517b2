"""Fake-tensor stand-ins and shardings for every (arch x shape) cell: the
port of ``repro.launch.specs``.

Nothing here allocates: the model, the optimizer state, the caches and the
batches are made under a ``FakeTensorMode`` by the port's own
constructors (``LM``, ``AdamW.init``, ``init_cache``) and placed as
``DTensor``s by the production shardings, so the dry run runs the exact
production step against the exact production state, where the reference
lowers it against ``jax.eval_shape``'s ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.pipeline import batch_specs
from ..launch.mesh import mesh_axes
from ..models import LM, init_cache
from ..models.config import ArchConfig, ShapeCell
from ..optim import AdamW, AdamWState, Q8State
from ..runtime.steps import (TrainState, make_decode_step, make_prefill_step,
                             make_train_step)
from ..sharding.context import sharding_rules
from ..sharding.rules import (NamedSharding, batch_spec, cache_sharding,
                              dp_axes, fit_spec, logical_to_physical,
                              param_sharding, place, q8_specs)


def _with_rules(fn, mesh):
    """Activate use-site sharding constraints while the step runs (none
    without a mesh)."""
    if mesh is None:
        return fn

    def wrapped(*args):
        with sharding_rules(mesh):
            return fn(*args)
    return wrapped


MICRO_TOKENS_BUDGET = 1 << 16     # ~64k tokens per microbatch (grad accum)


def plan_accum(cell: ShapeCell, mesh) -> Tuple[int, int]:
    """(accum, micro_batch): micro divisible by dp, tokens/micro bounded."""
    axes = mesh_axes(mesh)
    dp = 1
    for a in ("pod", "data"):
        if a in axes:
            dp *= axes[a]
    micro = min(cell.global_batch, max(dp, MICRO_TOKENS_BUDGET // cell.seq_len))
    micro -= micro % dp
    micro = max(micro, min(dp, cell.global_batch))
    while cell.global_batch % micro:
        micro -= dp
    accum = cell.global_batch // micro
    return accum, micro


# ----------------------------------------------------------------------
def state_shapes(cfg: ArchConfig, optimizer: AdamW, mesh=None,
                 device="cuda") -> TrainState:
    """The train state of ``cfg``, made under the active ``FakeTensorMode``
    (uninitialized float32 weights): with a ``mesh`` the parameters are
    placed by ``param_sharding`` first, so that the moments (q8 ones
    too) follow them."""
    params = LM(cfg, torch.device(device), None)
    if mesh is not None:
        logical_to_physical(mesh, params, param_sharding(params, mesh))
    return TrainState(params, optimizer.init(params))


def opt_leaf_sharding(mesh, param_shard):
    """m/v moments mirror the parameter sharding; Q8 blocks keep the
    parameter's leading-axis sharding and leave the (nb, BLOCK) trailing
    axes unsharded, but for the block axis ``nb``, which takes the
    parameter's last-axis sharding down a ladder (``q8_specs``: the full
    dp tuple, then each sub-axis, then unsharded), so a non-dividing nb
    (e.g. 144 vs pod*data=32) still gets the largest usable ZeRO degree
    instead of replication.  ``leaf`` is a moment or anything with its
    shape (a ``Q8State`` of objects with ``.shape``)."""
    def one(leaf, ps):
        if isinstance(leaf, Q8State):
            base = tuple(ps.spec) if ps is not None else ()
            cs, ss = q8_specs(base, tuple(leaf.codes.shape),
                              tuple(leaf.scales.shape), mesh)
            return Q8State(NamedSharding(mesh, cs), NamedSharding(mesh, ss))
        return ps

    return one


def train_state_sharding(mesh, cfg: ArchConfig, st_shapes: TrainState):
    ps = param_sharding(st_shapes.params, mesh)
    one = opt_leaf_sharding(mesh, None)
    m_sh = {n: one(leaf, ps[n]) for n, leaf in st_shapes.opt.m.items()}
    v_sh = {n: one(leaf, ps[n]) for n, leaf in st_shapes.opt.v.items()}
    return TrainState(ps, AdamWState(step=NamedSharding(mesh, ()), m=m_sh,
                                     v=v_sh))


def replicated(mesh, tree):
    """A replicated ``NamedSharding`` for every leaf of a dict tree."""
    if isinstance(tree, dict):
        return {k: replicated(mesh, v) for k, v in tree.items()}
    return NamedSharding(mesh, ())


# ----------------------------------------------------------------------
class CellLowering(NamedTuple):
    fn: Any                        # the step function
    arg_specs: tuple               # fake tensors (DTensors on a mesh)
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple          # arguments the step updates in place
    meta: dict
    fake_mode: Any = None          # the FakeTensorMode of ``arg_specs``


def make_optimizer(cfg: ArchConfig) -> AdamW:
    # 8-bit optimizer state for the very large dense configs (DESIGN.md §5):
    # fp32 moments for <=200B params fit the pod; 340B needs int8 moments.
    quantized = cfg.param_count() > 200e9
    return AdamW(lr=3e-4, quantized=quantized)


def _placed(mesh, shape, dtype, spec, device):
    t = torch.empty(shape, dtype=dtype, device=device)
    if mesh is None:
        return t
    return place(t, NamedSharding(mesh, fit_spec(spec, shape, mesh)))


def build_cell(cfg: ArchConfig, cell: ShapeCell, mesh, *,
               use_flash: bool = False, remat: bool = True,
               seq_shard: Optional[bool] = None, device: str = "cuda",
               optimizer: Optional[AdamW] = None,
               plan: Optional[Tuple[int, int]] = None) -> CellLowering:
    """Runnable artifact for one (arch x shape x mesh) cell: ``fn(*arg_specs)``
    under ``fake_mode`` runs the cell's step on fake ``DTensor``s placed on
    ``mesh`` (a ``DeviceMesh`` whose device type is ``device``'s), or on
    plain fake tensors where ``mesh`` is None.
    ``optimizer`` (default ``make_optimizer(cfg)``) and ``plan`` ((accum,
    micro), default ``plan_accum``) let the dry run cut a cell's depth and
    accumulation and keep the full cell's optimizer and microbatch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_mode = FakeTensorMode()
    with fake_mode:
        return _build(cfg, cell, mesh, use_flash, remat, seq_shard, device,
                      optimizer or make_optimizer(cfg), plan, fake_mode)


def _build(cfg, cell, mesh, use_flash, remat, seq_shard, device, optimizer,
           plan, fake_mode):
    axes = mesh if mesh is not None else {}     # specs need only axis sizes
    dp = dp_axes(axes)
    if seq_shard is None:
        # Megatron-SP by default for training — except recurrent families,
        # whose token-shift ops slice the sequence dim every layer
        seq_shard = (cell.kind == "train"
                     and cfg.family not in ("ssm", "hybrid"))

    if cell.kind == "train":
        accum, micro = plan or plan_accum(cell, axes)
        tp = mesh_axes(axes).get("model", 1)
        seq_split = tp if seq_shard and cell.seq_len % tp == 0 else 1
        st = state_shapes(cfg, optimizer, mesh, device)
        st_sh = train_state_sharding(axes, cfg, st)
        bs = batch_spec(axes, seq_shard=False)
        batch, b_sh = {}, {}
        for k, (shape, dtype) in batch_specs(cfg, cell.seq_len,
                                             micro * accum, accum).items():
            spec = (None,) + tuple(bs[k])
            batch[k] = _placed(mesh, shape, torch.from_numpy(
                np.zeros(0, dtype)).dtype, spec, device)
            b_sh[k] = NamedSharding(axes, fit_spec(spec, shape, axes))
        step = _with_rules(make_train_step(cfg, optimizer,
                                           use_flash=use_flash, remat=remat,
                                           seq_shard=seq_shard), mesh)
        metrics_sh = replicated(axes, {"loss": None, "grad_norm": None,
                                       "lr": None})
        return CellLowering(step, (st, batch), (st_sh, b_sh),
                            (st_sh, metrics_sh), donate_argnums=(0,),
                            meta={"accum": accum, "micro": micro,
                                  "quantized_opt": optimizer.quantized,
                                  "remat": remat, "seq_split": seq_split},
                            fake_mode=fake_mode)

    # inference cells: bf16 weights (serving precision) -------------------
    params = LM(cfg, torch.device(device), None, dtype=torch.bfloat16)
    p_sh = param_sharding(params, axes)
    B, S = cell.global_batch, cell.seq_len
    cross = S // 4 if cfg.n_encoder_layers else 0
    cache = init_cache(cfg, B, S, device, cross_len=cross)
    c_sh = cache_sharding(cache, axes)
    if mesh is not None:
        logical_to_physical(mesh, params, p_sh)
        cache = logical_to_physical(mesh, cache, c_sh)
    logits_sh = NamedSharding(axes, fit_spec((dp, "model"), (B, cfg.vocab),
                                             axes))

    if cell.kind == "prefill":
        tok_spec = (dp, "model" if seq_shard else None)
        batch = {"tokens": _placed(mesh, (B, S), torch.int32, tok_spec,
                                   device)}
        b_sh = {"tokens": NamedSharding(axes, fit_spec(tok_spec, (B, S),
                                                       axes))}
        extra = {}
        if cfg.n_encoder_layers:
            extra["frames"] = (B, cross, cfg.d_model)
        if cfg.frontend == "vision":
            extra["patches"] = (B, cfg.n_frontend_tokens, cfg.d_model)
        for k, shape in extra.items():
            batch[k] = _placed(mesh, shape, torch.float32, (dp, None, None),
                               device)
            b_sh[k] = NamedSharding(axes, fit_spec((dp, None, None), shape,
                                                   axes))
        step = _with_rules(make_prefill_step(cfg, use_flash=use_flash), mesh)
        return CellLowering(step, (params, batch, cache),
                            (p_sh, b_sh, c_sh), (logits_sh, c_sh),
                            donate_argnums=(2,), meta={},
                            fake_mode=fake_mode)

    # decode -------------------------------------------------------------
    tokens = _placed(mesh, (B, 1), torch.int32, (dp, None), device)
    t_sh = NamedSharding(axes, fit_spec((dp, None), (B, 1), axes))
    # the last slot of a full cache; the port's decode step takes the
    # position as a host int (the reference's is a replicated scalar)
    pos = S - 1
    step = _with_rules(make_decode_step(cfg), mesh)
    return CellLowering(step, (params, tokens, cache, pos),
                        (p_sh, t_sh, c_sh, NamedSharding(axes, ())),
                        (t_sh, logits_sh, c_sh),
                        donate_argnums=(2,), meta={}, fake_mode=fake_mode)
