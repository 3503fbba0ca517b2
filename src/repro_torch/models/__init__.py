"""Model zoo of the port: every family of ``repro.models`` — dense
decoders, MoE (``moe.py``: dbrx, qwen2-moe), ssm (RWKV6, ``rwkv.py``),
hybrid (Hymba's attention and Mamba heads, ``mamba.py``), encoder-decoder
(Seamless) and the vision-stub VLM (InternVL)."""
from . import mamba
from .config import ArchConfig, MoEConfig, SSMConfig, SHAPES, ShapeCell
from .convert import from_jax_params
from .transformer import (LM, cross_entropy_loss, forward_decode,
                          forward_prefill, forward_train, init_cache, init_lm,
                          layer_kinds)

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "SHAPES", "ShapeCell",
           "LM", "init_lm", "init_cache", "forward_train", "forward_prefill",
           "forward_decode", "cross_entropy_loss",
           "layer_kinds", "from_jax_params", "mamba"]
