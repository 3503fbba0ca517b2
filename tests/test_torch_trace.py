"""The port's layer spans and counters (``core/timeline.py``): the serving
engine's, the scheduler's and the lanes' spans on the real executor with
``device="cpu"`` and a tiny ``ServingEngine``, their always-on aggregates
in ``sched.stats()``, the lane counters, the Chrome export's rows and time
base, and the daemon monitor's utilization gauge over element spans."""
import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import function, make_scheduler
from repro_torch.core.timeline import LANE_THREAD_ROW, TIMELINE_PID, Timeline
from repro_torch.daemon import RuntimeMonitor
from repro_torch.models import LM
from repro_torch.runtime.serving import ServingEngine

SPAN_NAMES = ("serve.flush", "serve.issue", "serve.collect", "sched.launch",
              "lane.wait", "lane.issue", "lane.sync")
LAYER_KINDS = ("serve", "sched", "lane")
DEVICE_KINDS = ("compute", "h2d", "d2h", "d2d")
ROUNDS, CLIENTS = 3, 2


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("qwen3_32b", reduced=True)
    torch.manual_seed(0)
    return cfg, LM(cfg, torch.device("cpu"))


def serve(tiny, trace):
    """Two engines on one CPU scheduler, ``ROUNDS`` rounds of one batch
    each, flushed together and collected in turn.  Returns the scheduler's
    stats, its spans and the batches' first rids by round."""
    cfg, lm = tiny
    s = make_scheduler("parallel", device="cpu", trace=trace)
    engines = [ServingEngine(cfg, lm, batch_size=2, max_new_tokens=2,
                             scheduler=s, device="cpu")
               for _ in range(CLIENTS)]
    rng = np.random.RandomState(0)
    try:
        for _ in range(ROUNDS):
            for eng in engines:
                for _ in range(2):
                    eng.submit(rng.randint(0, cfg.vocab, 8))
                eng.flush()
            for eng in engines:
                assert len(eng.collect()) == 2
        for eng in engines:
            eng.close()
        return s.stats(), list(s.timeline.spans)
    finally:
        s.close()


def test_batch_spans_share_trace_id_and_nest_by_parent(tiny):
    _, spans = serve(tiny, trace=True)
    by_uid = {sp.uid: sp for sp in spans}
    reads = sum(1 for sp in spans if sp.uid == -1)    # host reads' copies
    assert len(by_uid) == len(spans) - reads + 1, "span uids are unique"
    issues = [sp for sp in spans if sp.name == "serve.issue"]
    assert len(issues) == ROUNDS * CLIENTS
    for issue in issues:
        flush = by_uid[issue.parent]
        assert flush.name == "serve.flush" and flush.parent is None
        assert flush.t0 <= issue.t0 <= issue.t1 <= flush.t1
        launches = [sp for sp in spans if sp.parent == issue.uid]
        assert [sp.name for sp in launches] == ["sched.launch"]
        launch = launches[0]
        assert launch.trace_id == issue.trace_id is not None
        assert issue.t0 <= launch.t0 <= launch.t1 <= issue.t1
        kids = [sp for sp in spans if sp.parent == launch.uid]
        elements = [sp for sp in kids if sp.kind in DEVICE_KINDS]
        assert {sp.kind for sp in elements} == {"h2d", "compute"}
        assert all(sp.trace_id == issue.trace_id for sp in kids)
        for name in ("lane.wait", "lane.issue", "lane.sync"):
            assert sorted(sp.lane for sp in kids if sp.name == name) == \
                sorted(sp.lane for sp in elements)
        for e in elements:
            lane = [sp for sp in kids if sp.lane == e.lane]
            issue_ = next(sp for sp in lane if sp.name == "lane.issue"
                          and sp.t0 <= e.t0 <= e.t1 <= sp.t1)
            wait = next(sp for sp in lane if sp.name == "lane.wait"
                        and sp.t1 == issue_.t0)
            sync = next(sp for sp in lane if sp.name == "lane.sync"
                        and sp.t0 == issue_.t1)
            assert wait.t0 == e.t_issue
            assert launch.t0 <= wait.t0 <= launch.t1
            assert sync.t0 <= sync.t1


def test_span_aggregates_equal_the_records_when_traced(tiny):
    stats, spans = serve(tiny, trace=True)
    assert set(stats["spans"]) == set(SPAN_NAMES)
    for name in SPAN_NAMES:
        mine = [sp for sp in spans if sp.name == name]
        assert {sp.kind for sp in mine} == {name.split(".")[0]}
        # each record's seconds were added to the aggregate in record order
        assert stats["spans"][name] == (len(mine), sum(sp.dur for sp in mine))


def test_untraced_keeps_only_todays_spans_and_still_counts(tiny):
    stats, spans = serve(tiny, trace=False)
    assert not [sp for sp in spans if sp.kind in LAYER_KINDS]
    assert {sp.kind for sp in spans} == {"h2d", "compute", "host", "d2h"}
    n = stats["spans"]
    batches = ROUNDS * CLIENTS
    elements = sum(1 for sp in spans if sp.kind in ("h2d", "compute"))
    assert n["serve.issue"][0] == n["sched.launch"][0] == batches
    # each flush issued one batch and each collect took it; close()
    # found nothing left to drain
    assert n["serve.flush"][0] == n["serve.collect"][0] == batches
    for name in ("lane.wait", "lane.issue", "lane.sync"):
        assert n[name][0] == elements == 2 * batches
        assert n[name][1] >= 0.0
    assert stats["lane_gap"] == (0, 0.0)      # no CUDA stream on the CPU
    assert 0.0 <= stats["issue_overlap_s"] <= n["lane.issue"][1]


def _sim_program(trace):
    s = make_scheduler("parallel", simulate=True, trace=trace)
    k = function(lambda a, b: None, modes=("const", "out"), name="k")
    for i in range(6):
        x = s.array(np.zeros(1 << 16, np.float32), name=f"x{i}")
        y = s.array(np.zeros(1 << 16, np.float32), name=f"y{i}")
        k.with_options(scheduler=s, cost_s=1e-4 * (1 + i % 3))(x, y)
    s.sync()
    spans = list(s.timeline.spans)
    stats = s.stats()
    s.close()
    return spans, stats


def test_tracing_leaves_the_simulators_element_spans_bit_for_bit():
    plain, stats = _sim_program(trace=False)
    traced, _ = _sim_program(trace=True)
    # element uids come from one counter for the whole process
    assert [replace(sp, uid=0) for sp in traced
            if sp.kind not in LAYER_KINDS] == \
        [replace(sp, uid=0) for sp in plain]
    assert [sp.name for sp in traced if sp.kind in LAYER_KINDS] == \
        ["sched.launch"] * 6
    assert stats["spans"]["sched.launch"][0] == 6
    assert "lane.wait" not in stats["spans"]     # no lane threads


@pytest.mark.parametrize("edges, want", [
    # (clock, lane's +1 or -1) in order; lane-seconds with two or more in
    ([(0, 1), (1, 1), (3, -1), (4, -1)], 2 * (3 - 1)),
    ([(0, 1), (2, -1), (2, 1), (5, -1)], 0.0),
    ([(0, 1), (1, 1), (2, 1), (4, -1), (5, -1), (6, -1)],
     2 * 1 + 3 * 2 + 2 * 1),
])
def test_issue_overlap_counts_each_lanes_share(edges, want):
    now = [0.0]
    tl = Timeline(clock=lambda: now[0])
    inside, opened, total = 0, [], 0.0
    for t, d in edges:
        now[0] = float(t)
        assert tl.issue_edge(d) == float(t)
        if d > 0:
            opened.append(t)
        else:
            total += t - opened.pop(0)
        inside += d
    assert inside == 0
    got = tl.stats()["issue_overlap_s"]
    assert got == pytest.approx(want) and got <= total


def test_lane_gap_and_span_aggregates_are_cumulative():
    tl = Timeline()
    for s in (1e-3, 2e-3, 4e-3):
        tl.lane_gap(s)
    tl.close_span("lane.wait", 1.0, 1.5)
    first = tl.stats()
    tl.close_span("lane.wait", 2.0, 2.25)
    assert first["lane_gap"] == (3, pytest.approx(7e-3))
    assert first["spans"] == {"lane.wait": (1, 0.5)}
    assert tl.stats()["spans"] == {"lane.wait": (2, 0.75)}
    assert tl.spans == []                    # untraced: counted, not kept


def test_elements_outside_any_span_carry_no_trace():
    seen = []
    k = function(lambda a, o: a + 1, modes=("const", "out"), name="k",
                 outputs=0)
    s = make_scheduler("parallel", device="cpu", trace=True)
    try:
        x = s.array(np.ones(4, np.float32), name="x")
        with s.timeline.span("serve.issue", trace_id=41):
            seen.append(k.with_options(scheduler=s)(x))
        s.sync()                        # the two in order on the timeline
        seen.append(k.with_options(scheduler=s)(x))
        s.sync()
        spans = s.timeline.spans
    finally:
        s.close()
    computes = [sp for sp in spans if sp.kind == "compute"]
    launches = {sp.uid: sp for sp in spans if sp.name == "sched.launch"}
    assert [sp.trace_id for sp in computes] == [41, None]
    assert launches[computes[0].parent].trace_id == 41
    assert launches[computes[1].parent].parent is None


def test_chrome_export_rows_and_profiler_time_base(tiny, tmp_path):
    cfg, lm = tiny
    s = make_scheduler("parallel", device="cpu", trace=True)
    eng = ServingEngine(cfg, lm, batch_size=2, max_new_tokens=2,
                        scheduler=s, device="cpu")
    try:
        eng.submit(np.arange(8) % cfg.vocab)
        eng.flush()
        eng.collect()
        eng.close()
        tl = s.timeline
        assert tl.epoch_unix_ns > 0
        alone = tmp_path / "timeline.json"
        tl.to_chrome_trace(str(alone))
        doc = json.loads(alone.read_text())
        base = doc["baseTimeNanoseconds"]
        rows = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
                if e["ph"] == "M"}
        lanes = {sp.lane for sp in tl.spans if sp.kind == "lane"}
        for lane in lanes:
            assert rows[lane] == f"lane {lane} stream"
            assert rows[lane + LANE_THREAD_ROW] == f"lane {lane} thread"
        assert rows[-6] == "serving engine and scheduler"
        first = tl.spans[0]
        ev = next(e for e in doc["traceEvents"] if e["ph"] == "X")
        assert ev["ts"] == pytest.approx(
            (tl.epoch_unix_ns - base) / 1e3 + first.t0 * 1e6, abs=1e-3)
        # a profiler's file lends its base and its events
        prof = tmp_path / "profiler.json"
        theirs = {"ph": "X", "name": "kernel", "pid": 0, "tid": 7,
                  "ts": 5.0, "dur": 1.0}
        prof.write_text(json.dumps({"schemaVersion": 1,
                                    "baseTimeNanoseconds": base - 10**9,
                                    "traceEvents": [theirs]}))
        both = tmp_path / "both.json"
        tl.to_chrome_trace(str(both), profiler_trace=str(prof))
        merged = json.loads(both.read_text())
        assert merged["schemaVersion"] == 1
        assert merged["traceEvents"][0] == theirs
        mine = [e for e in merged["traceEvents"][1:] if e["ph"] == "X"]
        assert {e["pid"] for e in mine} == {TIMELINE_PID}
        assert mine[0]["ts"] == pytest.approx(ev["ts"] + 1e6, abs=1e-3)
    finally:
        s.close()


def test_monitor_utilization_reads_busy_seconds_of_element_spans():
    """The gauge sums the element spans recorded since its last sample
    (device-timed on the card, as the lane workers record them there)
    and none of the layer spans, over the interval and the lanes."""
    s = make_scheduler("parallel", device="cpu", trace=True)
    try:
        mon = RuntimeMonitor(s, interval_s=None)
        mon.sample_once(now=10.0)
        k = function(lambda a, o: a * 2, modes=("const", "out"), name="k",
                     outputs=0)
        for i in range(2):
            with s.timeline.span("serve.issue", trace_id=i):
                k.with_options(scheduler=s)(s.array(np.ones(8), name=f"a{i}"))
        s.sync()
        tl = s.timeline
        lanes = s.streams.lanes_created
        # as the card's lane worker records a device interval
        tl.record(10**9, "k_card", "compute", 0, 3.0, 3.25, trace_id=7)
        busy = sum(sp.dur for sp in tl.spans if sp.kind in DEVICE_KINDS)
        assert busy >= 0.25
        assert any(sp.kind == "lane" for sp in tl.spans)
        got = mon._lane_utilization(10.0 + 4 * busy / lanes)
        assert got == pytest.approx(0.25, rel=1e-9)
        assert mon._busy_idx == len(tl.spans)
        assert mon._lane_utilization(11.0) == 0.0     # nothing new since
    finally:
        s.close()


def test_counters_lose_no_update_under_thread_switches():
    """More threads than cores entering and leaving ``lane.issue`` and
    closing spans with the interpreter switching threads every
    microsecond: every span counted, the issuing count back at zero, and
    the overlap within the lane-seconds spent issuing."""
    import sys
    import threading
    tl = Timeline()
    threads, rounds = 2 * (os.cpu_count() or 2) + 2, 300
    spent = [0.0] * threads

    def lane(i):
        for _ in range(rounds):
            t0 = tl.issue_edge(+1)
            t1 = tl.issue_edge(-1)
            spent[i] += t1 - t0
            tl.close_span("lane.issue", t0, t1, lane=i)
            tl.lane_gap(1e-6)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lane, args=(i,))
                   for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    st = tl.stats()
    n, secs = st["spans"]["lane.issue"]
    assert n == threads * rounds and st["lane_gap"][0] == n
    assert secs == pytest.approx(sum(spent))
    assert tl._issuing == 0
    assert 0.0 <= st["issue_overlap_s"] <= secs * (1 + 1e-9)
