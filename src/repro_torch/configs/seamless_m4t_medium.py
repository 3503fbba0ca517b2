"""SeamlessM4T-medium: speech/text encoder-decoder transformer backbone.

[arXiv:2308.11596; hf] — 12 encoder + 12 decoder layers, d_model=1024,
16 heads (GQA kv=16 == MHA), d_ff=4096, vocab=256206.  The audio frontend
(conformer feature extractor) is a STUB: ``input_specs`` provides
precomputed frame embeddings (B, S/4, d) per DESIGN.md §4.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                 # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    norm="layernorm",
    mlp="gelu",
    rope_theta=10_000.0,
    frontend="audio",
    n_frontend_tokens=0,         # frames supplied as encoder input
    source="[arXiv:2308.11596; hf]",
)
