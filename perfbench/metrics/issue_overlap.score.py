"""Lanes' host issue (``core/executor.py``): of the lane-seconds spent in
``lane.issue`` over the window, the share in % spent while at least one
other lane was issuing too, where the lanes contend for the interpreter
(``sched.stats()["issue_overlap_s"]`` over the span's seconds)."""


def read(ctx):
    a = ctx.stats_open.get("spans", {}).get("lane.issue")
    b = ctx.stats_close.get("spans", {}).get("lane.issue")
    if a is None or b is None or b[0] == a[0] or b[1] <= a[1] \
            or "issue_overlap_s" not in ctx.stats_open:
        return None
    overlap = ctx.stats_close["issue_overlap_s"] - \
        ctx.stats_open["issue_overlap_s"]
    return 100.0 * overlap / (b[1] - a[1])
