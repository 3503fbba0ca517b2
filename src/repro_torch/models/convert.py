"""Carry the reference's weights into the port.

``repro.models.init_lm`` stacks every block parameter with ``vmap``: a
leading ``n_groups`` axis, one tuple entry of ``params["blocks"]`` per layer
kind.  ``from_jax_params`` undoes that stacking and returns the port's
``LM`` holding exactly those values.  The JAX pytree arrives as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), so this module
needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

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
    for name, value in np_params["final_norm"].items():
        _fill(getattr(model.final_norm, name), value)
    if model.lm_head is not None:
        _fill(model.lm_head, np_params["lm_head"])
    kinds = layer_kinds(cfg)
    for layer, blk in enumerate(model.blocks):
        g, i = divmod(layer, len(kinds))
        # Each group of a block's parameters (ln1, ln2 and attn + ffn or
        # moe, or rwkv + cmix) is the port module of the same name.
        for group, params in np_params["blocks"][i].items():
            _fill_group(getattr(blk, group), params, g)
    return model
