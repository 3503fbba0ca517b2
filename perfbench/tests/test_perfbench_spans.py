"""The readers of the program's spans and counters
(``metrics/{serve_issue_ms,lane_wait_ms,lane_issue_ms,lane_gap_ms,
issue_overlap}.score.py``) against synthetic ``sched.stats()`` snapshots
taken at the window's opening and closing: each reads the difference of
the two, and nothing where the program keeps no such counter (the parent
of the change that added them) or its count did not move."""
from types import SimpleNamespace

import pytest

from perfbench import harness

OPEN = {"plan_replays": 3, "plan_records": 2,
        "spans": {"serve.issue": (10, 0.011), "lane.wait": (20, 0.5),
                  "lane.issue": (20, 4.0), "lane.sync": (20, 2.0)},
        "lane_gap": (18, 0.036), "issue_overlap_s": 1.0}
CLOSE = {"plan_replays": 43, "plan_records": 2,
         "spans": {"serve.issue": (50, 0.055), "lane.wait": (100, 2.1),
                   "lane.issue": (100, 20.0), "lane.sync": (100, 10.0)},
         "lane_gap": (96, 0.192), "issue_overlap_s": 9.0}
# (metric, what it reads from OPEN to CLOSE)
READINGS = [
    ("serve_issue_ms.score", 1e3 * 0.044 / 40),
    ("lane_wait_ms.score", 1e3 * 1.6 / 80),
    ("lane_issue_ms.score", 1e3 * 16.0 / 80),
    ("lane_gap_ms.score", 1e3 * 0.156 / 78),
    ("issue_overlap.score", 100.0 * 8.0 / 16.0),
]


def ctx(opened, closed):
    return SimpleNamespace(stats_open=opened, stats_close=closed,
                           trace=None, window=None)


def parent(stats):
    """A snapshot of a program that keeps none of the new counters."""
    return {k: v for k, v in stats.items()
            if k not in ("spans", "lane_gap", "issue_overlap_s")}


@pytest.mark.parametrize("metric, want", READINGS)
def test_reader_takes_the_windows_difference(metric, want):
    assert harness.reader(metric)(ctx(OPEN, CLOSE)) == pytest.approx(want)


@pytest.mark.parametrize("metric", [m for m, _ in READINGS])
@pytest.mark.parametrize("case", ["parent", "still", "no_span"])
def test_reader_gives_nothing_without_a_reading(metric, case):
    opened, closed = {
        "parent": (parent(OPEN), parent(CLOSE)),
        "still": (OPEN, OPEN),
        "no_span": (dict(OPEN, spans={}), dict(CLOSE, spans={})),
    }[case]
    got = harness.reader(metric)(ctx(opened, closed))
    if case == "no_span" and metric == "lane_gap_ms.score":
        assert got == pytest.approx(dict(READINGS)[metric])   # no span read
    else:
        assert got is None


def test_benchmark_lists_the_readers_for_the_cell():
    cell = harness.resolve("rwkv6.score_long")
    names = {m["name"] for m in cell.per_layer}
    assert {m for m, _ in READINGS} <= names
    for m in cell.per_layer:
        if m["name"] in dict(READINGS):
            assert m["source"] == "program_counter"
            assert m["moves"] == "tokens_per_s"
            assert m["workloads"] == ["rwkv6.score_long"]
