"""A model's operations for one batch of prompts, by family: every product
with a weight (2 operations a multiply-add), the LM head at the last
position only (the engine computes no other), attention's two products
over the pairs its mask lets through, and the recurrences'
multiply-adds (WKV6 5·hd² a token and head, the kernel's count; the
selective scan 4 a token, channel and state).  Elementwise work and the
embedding's gather are not counted."""
from __future__ import annotations

from .kernels import visible_pairs


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def weight_flops_per_token(m: dict) -> int:
    """Products with the blocks' weights, a token (the head excluded)."""
    d, ff = m["d_model"], m["d_ff"]
    if m["family"] == "ssm":
        lora = max(32, d // 16)
        per_layer = 6 * d * d + 2 * d * ff + 2 * d * lora
    elif m["family"] == "hybrid":
        hd, s = _hd(m), m["ssm"]
        inner = s["expand"] * d
        attn = 2 * d * m["n_heads"] * hd + 2 * d * m["n_kv_heads"] * hd
        ssm = d * 2 * inner + 2 * inner * s["state_dim"] + inner * d
        per_layer = attn + ssm + 3 * d * ff
    else:
        raise ValueError(f"no count for family {m['family']!r}")
    return 2 * per_layer * m["n_layers"]


def recurrence_flops_per_token(m: dict) -> int:
    if m["family"] == "ssm":
        hd = m["ssm"]["head_dim"]
        return 5 * hd * hd * (m["d_model"] // hd) * m["n_layers"]
    s = m["ssm"]
    return 4 * s["expand"] * m["d_model"] * s["state_dim"] * m["n_layers"]


def attention_flops(m: dict, L: int) -> int:
    """One prompt of L tokens, every layer."""
    if m["family"] != "hybrid":
        return 0
    pairs = visible_pairs(L, L, True, m.get("sliding_window", 0))
    return 4 * _hd(m) * m["n_heads"] * pairs * m["n_layers"]


def head_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab"]


def batch_flops(m: dict, L: int, B: int) -> int:
    """A batch of B prompts of L tokens."""
    per_prompt = (L * (weight_flops_per_token(m)
                       + recurrence_flops_per_token(m))
                  + attention_flops(m, L) + head_flops(m))
    return B * per_prompt
