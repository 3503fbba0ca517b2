"""Qwen3-32B: dense, qk-norm, GQA kv=8, SwiGLU, RMSNorm.

[hf:Qwen/Qwen3-8B scaled; hf] — 64L, d_model=5120, 64H, d_ff=25600,
vocab=151936.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    norm="rmsnorm",
    mlp="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
