"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit)."""
BF16_FLOPS = 989e12          # tensor cores, bfloat16 in, float32 sums
F32_FLOPS = 67e12            # float32 outside the tensor cores
HBM_BYTES = 3.35e12          # bytes a second of HBM3


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations
    over ``peak_flops`` and the bytes over the HBM rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
