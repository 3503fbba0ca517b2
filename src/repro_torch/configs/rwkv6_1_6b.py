"""RWKV-6 "Finch" 1.6B: attention-free, data-dependent decay WKV.

[arXiv:2404.05892; unverified] — 24L, d_model=2048, d_ff=7168 (channel
mix), vocab=65536, head_dim 64.  O(1) decode state -> runs long_500k.
"""
from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                  # d_model / ssm.head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    norm="layernorm",
    mlp="gelu",                  # unused (channel-mix FFN)
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    source="[arXiv:2404.05892; unverified]",
)
