"""Lanes' host issue (``core/executor.py``; the model step's dispatch):
the mean time of the program's ``lane.issue`` span over the window, in
ms: an element from its lane worker's start to its completion event
recorded, every copy and launch of it issued (``sched.stats()["spans"]``)."""


def read(ctx):
    a = ctx.stats_open.get("spans", {}).get("lane.issue")
    b = ctx.stats_close.get("spans", {}).get("lane.issue")
    if a is None or b is None or b[0] == a[0]:
        return None
    return 1e3 * (b[1] - a[1]) / (b[0] - a[0])
