"""InternVL2-76B: InternViT frontend (STUB) + InternLM2-76B-style LM
backbone.

[arXiv:2404.16821; unverified] — 80L, d_model=8192, 64H GQA kv=8,
d_ff=28672 (SwiGLU), vocab=128256.  ``input_specs`` provides 256 patch
embeddings per image that replace the first token positions.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision",
    n_frontend_tokens=256,
    source="[arXiv:2404.16821; unverified]",
)
