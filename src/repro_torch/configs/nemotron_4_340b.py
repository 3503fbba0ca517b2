"""Nemotron-4 340B: dense, squared-ReLU MLP, GQA kv=8, layernorm.

[arXiv:2402.16819; unverified] — 96L, d_model=18432, 96H, d_ff=73728,
vocab=256000.  Trains with 8-bit optimizer state + gradient-accumulation
scan to fit the v5e single-pod memory budget (DESIGN.md §5).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    norm="layernorm",
    mlp="relu2",
    rope_theta=10_000.0,
    source="[arXiv:2402.16819; unverified]",
)
