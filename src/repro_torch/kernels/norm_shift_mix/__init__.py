"""rwkv6's LayerNorm, token shift and static mixes in one pass."""
