"""Qwen1.5/2-MoE-A2.7B: 60 routed experts top-4 + 4 shared experts,
fine-grained d_ff=1408, MHA (kv=16).

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 24L, d_model=2048, 16H, vocab=151936.
"""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared_experts=4),
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
)
