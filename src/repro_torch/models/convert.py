"""Carry the reference's weights and train states into the port, and back.

``repro.models.init_lm`` stacks every block parameter with ``vmap``: a
leading ``n_groups`` axis, one tuple entry of ``params["blocks"]`` per layer
kind; an encoder-decoder's ``params["encoder"]`` is one dict stacked over
its ``n_encoder_layers`` (encoder layer N is index N of each leaf).  ``from_jax_params`` undoes that stacking and returns the port's
``LM`` holding exactly those values.  The JAX pytree arrives as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), so this module
needs no JAX.

``to_jax_layout`` and ``from_jax_layout`` do the same for a whole train
state (the model and its AdamW state), flattened to the leaf names the
reference's checkpoint manager writes (``params/blocks/0/attn/wq`` with its
leading ``n_groups`` axis, ``params/encoder/attn/wq`` with its leading
encoder-layer axis, ``opt/step``, ``opt/m/...``, the q8 moments'
``.../codes`` and ``.../scales``): so a checkpoint of either package
restores in the other.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..optim import Q8State
from .config import ArchConfig
from .transformer import LM, layer_kinds


def _fill(param: torch.nn.Parameter, value) -> None:
    value = np.asarray(value)
    if tuple(param.shape) != value.shape:
        raise ValueError(f"shape {value.shape} does not fit parameter "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(value)))


def _fill_group(module: torch.nn.Module, params, g: int) -> None:
    """Layer ``g`` of each stacked array of ``params`` into ``module``'s
    parameter of the same name; a nested dict (the MoE's ``shared`` MLP)
    is the submodule of its name."""
    for name, value in params.items():
        if isinstance(value, dict):
            _fill_group(getattr(module, name), value, g)
        else:
            _fill(getattr(module, name), value[g])


def from_jax_params(np_params, cfg: ArchConfig, device="cuda") -> LM:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_jax_params: device='cuda' but no CUDA "
                           "device is available; pass device='cpu'")
    model = LM(cfg, device, generator=None)
    _fill(model.embed, np_params["embed"])
    for norm in ("final_norm", "enc_norm"):
        for name, value in np_params.get(norm, {}).items():
            _fill(getattr(getattr(model, norm), name), value)
    for name in ("lm_head", "frontend_proj"):
        if getattr(model, name) is not None:
            _fill(getattr(model, name), np_params[name])
    kinds = layer_kinds(cfg)
    for layer, blk in enumerate(model.blocks):
        g, i = divmod(layer, len(kinds))
        # Each group of a block's parameters (ln1, ln2 and attn + ffn or
        # moe, hymba's mamba, the decoder's ln_cross and cross, or rwkv +
        # cmix) is the port module of the same name.
        for group, params in np_params["blocks"][i].items():
            _fill_group(getattr(blk, group), params, g)
    for layer, blk in enumerate(model.encoder):
        for group, params in np_params["encoder"].items():
            _fill_group(getattr(blk, group), params, layer)
    return model


# ----------------------------------------------------------------------
# whole train states, in the reference's checkpoint layout
# ----------------------------------------------------------------------
def reference_path(cfg: ArchConfig, name: str) -> Tuple[str, Optional[int]]:
    """A port leaf name (``blocks.5.attn.wq``, ``encoder.3.attn.wq``,
    ``final_norm.scale``) as the reference's tree path and the index it is
    stacked at: the layer group, the encoder layer, or None for a leaf the
    reference does not stack."""
    parts = name.split(".")
    if parts[0] == "encoder":
        return "/".join(["encoder"] + parts[2:]), int(parts[1])
    if parts[0] != "blocks":
        return "/".join(parts), None
    g, i = divmod(int(parts[1]), len(layer_kinds(cfg)))
    return "/".join(["blocks", str(i)] + parts[2:]), g


def _tensor_leaves(tree: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A q8 moment is two leaves, ``codes`` and ``scales``."""
    out = {}
    for n, t in tree.items():
        if isinstance(t, Q8State):
            out[n + ".codes"], out[n + ".scales"] = t.codes, t.scales
        else:
            out[n] = t
    return out


def whole(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gathered to its full value on every rank (the
    reference's ``np.asarray`` of a sharded array); a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def placed_like(value: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The full ``value`` laid out as ``ref``: a ``DTensor`` with ``ref``'s
    placements (each rank keeps its own shard; no communication), or a
    tensor on ``ref``'s device."""
    value = value.to(ref.device)
    if not hasattr(ref, "device_mesh"):
        return value
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(value, ref.device_mesh, ref.placements,
                             src_data_rank=None)


def _fill_placed(t: torch.Tensor, value: torch.Tensor) -> None:
    """Writes the full host ``value`` into ``t`` (into each rank's own
    shard of a ``DTensor``)."""
    placed = placed_like(value, t)
    if hasattr(placed, "to_local"):
        t.to_local().copy_(placed.to_local())
    else:
        t.copy_(placed)


def _host_array(shape, t: torch.Tensor) -> np.ndarray:
    return np.empty(shape, dtype=torch.empty(0, dtype=t.dtype).numpy().dtype)


def _stack_into(out: Dict[str, np.ndarray], prefix: str, cfg: ArchConfig,
                leaves: Dict[str, torch.Tensor], host: bool = True) -> None:
    """Host copies of ``leaves``, stacked by layer group where the
    reference stacks them; each device tensor is gathered whole (every
    rank takes part) and copied straight into its slice, one at a time.
    With ``host=False`` only the gathers are made."""
    groups: Dict[str, list] = {}
    for n, t in leaves.items():
        path, g = reference_path(cfg, n)
        groups.setdefault(path, []).append((g, t.detach()))
    for path, members in groups.items():
        arr = None
        for g, t in members:
            t = whole(t)
            if not host:
                continue
            if arr is None:
                arr = _host_array(tuple(t.shape) if g is None
                                  else (len(members),) + tuple(t.shape), t)
            torch.from_numpy(arr if g is None else arr[g]).copy_(t)
        if host:
            out[prefix + path] = arr


def _fill_from(flat: Mapping[str, np.ndarray], prefix: str, cfg: ArchConfig,
               leaves: Dict[str, torch.Tensor]) -> None:
    for n, t in leaves.items():
        path, g = reference_path(cfg, n)
        arr = flat[prefix + path]
        if g is not None:
            arr = arr[g]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{prefix + path}: shape {tuple(arr.shape)} "
                             f"does not fit {n} {tuple(t.shape)}")
        with torch.no_grad():
            _fill_placed(t, torch.from_numpy(np.array(arr)))


def to_jax_layout(state, host: bool = True) -> Dict[str, np.ndarray]:
    """Host copies of a train state's leaves (``state.params``, an ``LM``;
    ``state.opt``, its ``AdamWState``), named and stacked as the
    reference's checkpoint of its ``TrainState``.  With ``host=False`` a
    rank takes part in the gathers of ``DTensor`` leaves and keeps
    nothing (an empty dict)."""
    model, opt = state.params, state.opt
    cfg = model.cfg
    out: Dict[str, np.ndarray] = {}
    _stack_into(out, "params/", cfg, dict(model.named_parameters()), host)
    if host:
        out["opt/step"] = np.asarray(opt.step, np.int32)
    _stack_into(out, "opt/m/", cfg, _tensor_leaves(opt.m), host)
    _stack_into(out, "opt/v/", cfg, _tensor_leaves(opt.v), host)
    return out


def from_jax_layout(flat: Mapping[str, np.ndarray], state) -> None:
    """Writes the leaves of ``flat`` (named as ``to_jax_layout`` names
    them, e.g. read from a reference checkpoint) into ``state`` in place.
    The state must have the checkpoint's structure: the same config, and
    q8 moments where the checkpoint has them."""
    model, opt = state.params, state.opt
    cfg = model.cfg
    _fill_from(flat, "params/", cfg, dict(model.named_parameters()))
    opt.step = int(flat["opt/step"])
    _fill_from(flat, "opt/m/", cfg, _tensor_leaves(opt.m))
    _fill_from(flat, "opt/v/", cfg, _tensor_leaves(opt.v))
