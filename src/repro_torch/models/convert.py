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
        # Each group of a block's parameters (ln1, ln2 and attn + ffn, or
        # rwkv + cmix) is the port module of the same name.
        for group, params in np_params["blocks"][i].items():
            for name, value in params.items():
                _fill(getattr(getattr(blk, group), name), value[g])
    return model
