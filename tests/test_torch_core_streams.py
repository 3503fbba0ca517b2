"""StreamManager in the port, the suite of ``tests/test_streams.py`` run on
``repro_torch.core``: FIFO lane reclaim, max_lanes saturation, event
accounting and scheduler element retirement (§IV-C).

Each case drives the port and the reference the same way and asserts,
besides the reference's own checks on the port, that both assign the same
lanes, wait on the same events and count the same lanes and events.
"""
import numpy as np

from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401

import repro.core as J
import repro_torch.core as T


def ce(c, *args, cost_s=0.0, name=""):
    return c.ComputationalElement(fn=None, args=tuple(args), name=name,
                                  cost_s=cost_s)


def link(child, *parents):
    child.parents = list(parents)
    for p in parents:
        p.children.append(child)
    return child


class DoneSet:
    """Explicit completion oracle for driving StreamManager directly."""

    def __init__(self):
        self.done = set()

    def finish(self, *elements):
        self.done.update(e.uid for e in elements)

    def __call__(self, element):
        return element.uid in self.done


def lanes(sm, *elements):
    return ([(e.name, e.stream) for e in elements],
            sm.lanes_created, sm.events_created)


def assign(sm, e, done):
    """One assignment: the lane's id and the events waited on, by name."""
    lane, events = sm.assign(e, done)
    return lane.lane_id, [p.name for p in events]


def both(run):
    got, want = run(T), run(J)
    assert got == want
    return got


def test_fifo_lane_reclaim_order():
    def run(c):
        sm, done = c.StreamManager(), DoneSet()
        first = [ce(c, name=f"a{i}") for i in range(3)]
        for e in first:
            sm.assign(e, done)
        assert [e.stream for e in first] == [0, 1, 2]
        done.finish(*first)
        for idx in (1, 2, 0):          # FIFO order, not lane-id order
            sm.release(first[idx])
        second = [ce(c, name=f"b{i}") for i in range(3)]
        for e in second:
            sm.assign(e, done)
        assert [e.stream for e in second] == [1, 2, 0]
        assert sm.lanes_created == 3
        return lanes(sm, *first, *second)
    both(run)


def test_new_lane_only_when_no_empty_lane():
    def run(c):
        sm, done = c.StreamManager(), DoneSet()
        e1, e2 = ce(c, name="e1"), ce(c, name="e2")
        sm.assign(e1, done)
        sm.assign(e2, done)
        assert e2.stream != e1.stream
        assert sm.lanes_created == 2
        return lanes(sm, e1, e2)
    both(run)


def test_max_lanes_saturation_falls_back_to_least_loaded():
    def run(c):
        sm, done = c.StreamManager(max_lanes=2), DoneSet()
        a, b = ce(c, name="a"), ce(c, name="b")
        sm.assign(a, done)
        sm.assign(b, done)
        assert sm.lanes_created == 2
        extra = link(ce(c, name="extra"), a)
        sm.assign(extra, done)
        assert extra.stream == a.stream
        cc = ce(c, name="c")
        sm.assign(cc, done)            # saturated: least-loaded lane
        assert sm.lanes_created == 2
        assert cc.stream == b.stream
        return lanes(sm, a, b, extra, cc)
    both(run)


def test_tail_parent_needs_no_event():
    def run(c):
        sm, done = c.StreamManager(), DoneSet()
        p = ce(c, name="p", cost_s=1e-3)
        sm.assign(p, done)
        child = link(ce(c, name="child"), p)
        got = assign(sm, child, done)
        assert got == (p.stream, [])
        assert sm.events_created == 0
        return got, lanes(sm, p, child)
    both(run)


def test_cross_lane_parent_costs_one_event():
    def run(c):
        sm, done = c.StreamManager(), DoneSet()
        p1, p2 = ce(c, name="p1", cost_s=2e-3), ce(c, name="p2", cost_s=1e-3)
        sm.assign(p1, done)
        sm.assign(p2, done)
        assert p1.stream != p2.stream
        child = link(ce(c, name="child"), p1, p2)
        got = assign(sm, child, done)
        assert got == (p1.stream, ["p2"])   # the costlier parent's lane
        assert sm.events_created == 1
        return got, lanes(sm, p1, p2, child)
    both(run)


def test_earlier_same_lane_parent_needs_no_event():
    def run(c):
        sm, done = c.StreamManager(), DoneSet()
        p = ce(c, name="p", cost_s=1e-3)
        sm.assign(p, done)
        c1 = link(ce(c, name="c1", cost_s=1e-3), p)
        sm.assign(c1, done)
        assert c1.stream == p.stream
        c2 = link(ce(c, name="c2"), p, c1)
        got = assign(sm, c2, done)
        assert got == (p.stream, [])
        return got, lanes(sm, p, c1, c2)
    both(run)


def test_non_tail_same_lane_parent_needs_no_event():
    """A parent that is not the lane's tail is still ordered by the lane's
    FIFO queue: no event."""
    def run(c):
        sm, done = c.StreamManager(max_lanes=1), DoneSet()
        p = ce(c, name="p", cost_s=1e-3)
        sm.assign(p, done)
        c1 = link(ce(c, name="c1", cost_s=1e-3), p)
        sm.assign(c1, done)
        r = link(ce(c, name="r"), p)
        got = assign(sm, r, done)
        assert got == (p.stream, [])
        assert sm.events_created == 0
        return got, lanes(sm, p, c1, r)
    both(run)


def test_finished_parent_needs_no_event():
    def run(c):
        sm, done = c.StreamManager(), DoneSet()
        p1, p2 = ce(c, name="p1"), ce(c, name="p2")
        sm.assign(p1, done)
        sm.assign(p2, done)
        done.finish(p2)
        child = link(ce(c, name="child"), p1, p2)
        got = assign(sm, child, done)
        assert "p2" not in got[1]
        return got, lanes(sm, p1, p2, child)
    both(run)


def test_sync_clears_retired_elements():
    def run(c):
        s = c.make_scheduler("parallel", simulate=True)
        for rounds in range(3):
            for i in range(4):
                x = s.array(np.zeros(1024, np.float32), name=f"x{rounds}_{i}")
                s.launch(None, [c.inout(x)], name="k", cost_s=1e-4)
            s.sync()
            assert s._elements == []    # not re-walked by the next sync
        assert s.dag.num_elements == 24     # 4 kernels + 4 h2d per round
        spans = [(sp.name, sp.kind, sp.lane, sp.t0, sp.t1)
                 for sp in s.timeline.spans]
        s.close()
        return spans, s.streams.lanes_created, s.streams.events_created
    both(run)
