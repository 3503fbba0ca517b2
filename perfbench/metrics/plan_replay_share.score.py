"""Scheduler capture (``core/capture.py``): of the episodes the window
captured, the share that replayed a recorded plan, in %, from the
scheduler's ``plan_replays`` and ``plan_records`` counters."""


def read(ctx):
    rep = ctx.stats_close["plan_replays"] - ctx.stats_open["plan_replays"]
    rec = ctx.stats_close["plan_records"] - ctx.stats_open["plan_records"]
    return 100.0 * rep / (rep + rec) if rep + rec else None
