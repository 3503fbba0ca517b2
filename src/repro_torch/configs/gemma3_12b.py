"""Gemma-3 12B: dense decoder, 5:1 local:global sliding-window attention.

[hf:google/gemma-3-1b-pt scaled; unverified] — 48L, d_model=3840, 16H GQA
kv=8 (head_dim 256), d_ff=15360 (GeGLU), vocab=262144, 128k context via
window 1024 local layers + global every 6th layer.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    norm="rmsnorm",
    mlp="geglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    global_every=6,              # 5 local : 1 global
    tie_embeddings=True,
    source="[hf:google/gemma-3-1b-pt; unverified]",
)
