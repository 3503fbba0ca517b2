"""Serving engine and scheduler (``runtime/serving.py``,
``core/scheduler.py``, ``submission.py``, ``capture.py``): the mean host
time of the flush that issued each batch of the window, in ms, on the
harness's own clock."""


def read(ctx):
    recs = ctx.window.records
    return 1e3 * sum(r.flush_s for r in recs) / len(recs) if recs else None
