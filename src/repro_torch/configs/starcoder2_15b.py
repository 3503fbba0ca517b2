"""StarCoder2-15B: dense code LM, GQA kv=4, RoPE, gelu MLP, layernorm.

[arXiv:2402.19173; hf] — 40L, d_model=6144, 48H, d_ff=24576, vocab=49152.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    norm="layernorm",
    mlp="gelu",
    rope_theta=100_000.0,
    source="[arXiv:2402.19173; hf]",
)
