"""Scheduler lanes (``core/executor.py``): the mean time of the program's
``lane.wait`` span over the window, in ms: an element from its submission
to its lane worker's start (the lane's queue, its parents, evictions, the
pause gate; ``sched.stats()["spans"]``)."""


def read(ctx):
    a = ctx.stats_open.get("spans", {}).get("lane.wait")
    b = ctx.stats_close.get("spans", {}).get("lane.wait")
    if a is None or b is None or b[0] == a[0]:
        return None
    return 1e3 * (b[1] - a[1]) / (b[0] - a[0])
