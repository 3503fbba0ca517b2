"""The window holds whole batches and whole cycles, its rate is their
tokens over its length, and a stall inside it lowers the rate."""
import pytest

from perfbench import generator, loop

MIX = dict(kind="closed_batches", lengths=[2, 4, 8],
           batches_per_cycle=[4, 2, 1], batch=1, new_tokens=1, in_flight=2,
           check_per_length=1)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeEngine:
    """Each batch takes its tokens / ``speed`` seconds of the fake clock,
    paid when collected; ``stall_at`` adds a pause before one batch."""

    def __init__(self, clock, speed=100.0, stall_at=None, stall=0.0):
        self.clock, self.speed = clock, speed
        self.stall_at, self.stall = stall_at, stall
        self.queued, self.count = [], [0]

    def submit(self, tokens, new_tokens):
        req = type("Req", (), {"tokens": tokens, "result": None})()
        self.queued.append(req)
        return req

    def flush(self):
        pass

    def collect(self):
        for r in self.queued:
            self.clock.t += len(r.tokens) / self.speed
            r.result = [0]
        self.count[0] += 1
        if self.count[0] == self.stall_at:
            self.clock.t += self.stall
        done, self.queued = self.queued, []
        return done


def window(stall_at=None, stall=0.0, seconds=1.0, cycles=None):
    clock = Clock()
    shared = [0]
    engines = [FakeEngine(clock, stall_at=stall_at, stall=stall)
               for _ in range(2)]
    for e in engines:
        e.count = shared
    clients = loop.Clients(engines, 1, clock=clock)
    return clients.run(generator.batches(MIX, 10, 3), seconds, cycles)


def test_window_holds_whole_cycles_and_ends_drained():
    win = window(seconds=1.0)
    per = len(generator.cycle_lengths(MIX))
    assert len(win.records) % per == 0
    assert [r.batch.index for r in win.records] == list(
        range(len(win.records)))
    assert all(r.t_done <= win.t_close for r in win.records)
    assert win.tokens == sum(r.batch.n_tokens for r in win.records)
    assert win.seconds >= 1.0
    # every cycle but the last started before the window's length ran out
    assert win.records[-per].t_dispatch - win.t_open < 1.0
    assert win.rate == pytest.approx(
        sum(len(r.batch.tokens[0]) for r in win.records) / win.seconds)


def test_stall_inside_the_window_lowers_the_rate():
    calm = window(seconds=0.0)
    stalled = window(stall_at=3, stall=0.2, seconds=0.0)
    assert stalled.tokens == calm.tokens
    assert stalled.seconds == pytest.approx(calm.seconds + 0.2)
    assert stalled.rate < calm.rate


def test_zero_seconds_runs_one_cycle():
    win = window(seconds=0.0)
    assert len(win.records) == len(generator.cycle_lengths(MIX))
    assert {r.batch.cycle for r in win.records} == {0}


@pytest.mark.parametrize("cycles", [1, 2, 3])
def test_cycles_ends_the_run_after_that_many(cycles):
    """Set-up's settle rounds: a run of ``cycles`` whole cycles, drained."""
    win = window(seconds=float("inf"), cycles=cycles)
    assert len(win.records) == cycles * len(generator.cycle_lengths(MIX))
    assert {r.batch.cycle for r in win.records} == set(range(cycles))
