"""Kernel ``kernels/rwkv6`` (the WKV6 forward): the least time the card
could take for the traced cycle's launches, from their counted operations
and bytes, over the device time of those launches, in %."""
from perfbench.counts import kernels, peaks


def read(ctx):
    tr, m = ctx.trace, ctx.model
    if tr is None or m["family"] != "ssm":
        return None
    n, secs = tr.kernel_time("wkv6_kernel", exclude=("bwd",))
    if n != m["n_layers"] * len(tr.lengths) or secs <= 0:
        return None
    hd = m["ssm"]["head_dim"]
    B = int(ctx.mix["batch"])
    bound = sum(m["n_layers"] * peaks.bound_s(
        *kernels.wkv6(B, L, m["d_model"] // hd, hd),
        kernels.PEAK_FLOPS["wkv6"]) for L in tr.lengths)
    return 100.0 * bound / secs
