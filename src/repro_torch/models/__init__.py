"""Model zoo of the port: the dense decoder family, the MoE family
(``moe.py``: dbrx, qwen2-moe) and the ssm family (RWKV6, ``rwkv.py``); see
ROADMAP.md for the families still to come."""
from .config import ArchConfig, MoEConfig, SSMConfig, SHAPES, ShapeCell
from .convert import from_jax_params
from .transformer import (LM, cross_entropy_loss, forward_decode,
                          forward_prefill, forward_train, init_cache, init_lm,
                          layer_kinds)

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "SHAPES", "ShapeCell",
           "LM", "init_lm", "init_cache", "forward_train", "forward_prefill",
           "forward_decode", "cross_entropy_loss",
           "layer_kinds", "from_jax_params"]
