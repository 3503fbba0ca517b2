"""Hymba-1.5B: hybrid blocks with parallel attention + Mamba heads.

[arXiv:2411.13676; hf] — 32L, d_model=1600, 25H GQA kv=5, d_ff=5504,
vocab=32001, ssm_state=16; sliding-window attention (1024) keeps the
attention path sub-quadratic -> runs long_500k.
"""
from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10_000.0,
    sliding_window=1024,
    global_every=0,              # all attention heads local (SWA)
    ssm=SSMConfig(kind="mamba", state_dim=16, expand=2, conv_dim=4),
    source="[arXiv:2411.13676; hf]",
)
