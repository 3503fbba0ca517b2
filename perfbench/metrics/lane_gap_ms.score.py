"""Lanes on the device (``core/executor.py``): the mean device time, in
ms, from an element's completion event to the start event of the next
element on the same CUDA stream over the window: the lane's drain and
refill, timed with CUDA events (``sched.stats()["lane_gap"]``)."""


def read(ctx):
    a = ctx.stats_open.get("lane_gap")
    b = ctx.stats_close.get("lane_gap")
    if a is None or b is None or b[0] == a[0]:
        return None
    return 1e3 * (b[1] - a[1]) / (b[0] - a[0])
