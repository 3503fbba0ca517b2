"""DBRX-132B: fine-grained MoE, 16 experts top-4, GQA kv=8.

[hf:databricks/dbrx-base; unverified] — 40L, d_model=6144, 48H,
d_ff_expert=10752 (SwiGLU), vocab=100352.
"""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    norm="layernorm",
    mlp="swiglu",
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
    source="[hf:databricks/dbrx-base; unverified]",
)
