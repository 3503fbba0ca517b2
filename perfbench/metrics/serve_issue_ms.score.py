"""Serving engine and scheduler (``runtime/serving.py``,
``core/scheduler.py``, ``capture.py``): the mean time of the program's
``serve.issue`` span over the window, in ms: one batch's prompts stacked,
its arrays made, its launch captured or replayed and submitted, on the
program's clock (``sched.stats()["spans"]``)."""


def read(ctx):
    a = ctx.stats_open.get("spans", {}).get("serve.issue")
    b = ctx.stats_close.get("spans", {}).get("serve.issue")
    if a is None or b is None or b[0] == a[0]:
        return None
    return 1e3 * (b[1] - a[1]) / (b[0] - a[0])
