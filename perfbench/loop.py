"""The closed loop that drives ``repro_torch``'s serving engine.

``in_flight`` clients share one scheduler, each a ``ServingEngine`` with
one batch outstanding: a client submits a batch's requests, flushes, and
waits for them with ``collect``, and then takes the next batch of the
run's order.  So ``in_flight`` batches are in flight at all times, through
the engine's public calls alone.

The window opens at a completion with nothing in flight (the end of the
warm-up) and closes at a completion with nothing in flight: once a cycle
of the mix is about to start ``seconds`` or more after the opening, no
batch of it is dispatched, and the window closes when the last batch in
flight completes.  So the window holds whole cycles, every batch of it
completes inside it, no part of a batch lies outside it, and a stall
inside it lowers the rate.
"""
from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence

from .generator import Batch


@dataclass
class Record:
    batch: Batch
    client: int
    t_dispatch: float = 0.0     # host clock before the first submit
    flush_s: float = 0.0        # host time of the flush that issued it
    t_done: float = 0.0         # host clock when its collect returned
    requests: list = field(default_factory=list)


@dataclass
class Window:
    t_open: float
    t_close: float
    records: List[Record]

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    @property
    def tokens(self) -> int:
        """Prompt tokens of the window's batches, each counted whole."""
        return sum(r.batch.n_tokens for r in self.records)

    @property
    def rate(self) -> float:
        return self.tokens / self.seconds


class Clients:
    """The clients of one run: engines on one scheduler, each with at most
    one batch outstanding.  ``span(name)`` wraps each flush and each
    collect (the profiler's ``record_function`` in a traced run)."""

    def __init__(self, engines: Sequence, new_tokens: int,
                 clock: Callable[[], float] = time.perf_counter,
                 span: Optional[Callable] = None) -> None:
        self.engines = list(engines)
        self.new_tokens = int(new_tokens)
        self.clock = clock
        self.span = span or (lambda name: contextlib.nullcontext())

    def dispatch(self, client: int, batch: Batch) -> Record:
        eng = self.engines[client]
        rec = Record(batch, client, t_dispatch=self.clock())
        rec.requests = [eng.submit(row, self.new_tokens)
                        for row in batch.tokens]
        with self.span("flush"):
            t0 = self.clock()
            eng.flush()
            rec.flush_s = self.clock() - t0
        return rec

    def wait(self, rec: Record) -> Record:
        with self.span("collect"):
            self.engines[rec.client].collect()
        rec.t_done = self.clock()
        return rec

    def warm(self, batches: Sequence[Batch]) -> List[Record]:
        """Each run of ``len(engines)`` batches dispatched together, one a
        client, and waited for before the next run."""
        k = len(self.engines)
        out = []
        for i in range(0, len(batches), k):
            recs = [self.dispatch(c, b) for c, b in
                    enumerate(batches[i:i + k])]
            out.extend(self.wait(r) for r in recs)
        return out

    def run(self, batches: Iterator[Batch], seconds: float,
            cycles: Optional[int] = None) -> Window:
        """The measured window over ``batches`` (an endless iterator that
        starts at a cycle's first batch), from now, with nothing in
        flight, to the completion of the last batch of the cycle that was
        running ``seconds`` after the opening, or of the ``cycles``-th
        cycle, whichever comes first."""
        t_open = self.clock()
        pending = collections.deque()
        records: List[Record] = []
        nxt: Optional[Batch] = next(batches)
        cycle, cycles_run = nxt.cycle, 0
        for c in range(len(self.engines)):
            if nxt.cycle != cycle:
                break
            pending.append(self.dispatch(c, nxt))
            nxt = next(batches)
        while pending:
            rec = self.wait(pending.popleft())
            records.append(rec)
            if nxt is None:
                continue
            if nxt.cycle != cycle:       # a cycle would start
                cycles_run += 1
                if rec.t_done - t_open >= seconds or cycles_run == cycles:
                    nxt = None
                    continue
                cycle = nxt.cycle
            pending.append(self.dispatch(rec.client, nxt))
            nxt = next(batches)
        return Window(t_open, records[-1].t_done, records)
