"""Optimizers of the port: AdamW with optional 8-bit moments.  The
reference's gradient compression (``repro.optim.compress``) belongs to the
multi-device slice (ROADMAP.md §A)."""
from .adamw import (AdamW, AdamWState, Q8State, dequantize_q8, named_leaves,
                    quantize_q8)

__all__ = ["AdamW", "AdamWState", "Q8State", "quantize_q8", "dequantize_q8",
           "named_leaves"]
