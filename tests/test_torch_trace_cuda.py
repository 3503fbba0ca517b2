"""Device-timed element spans on the card (``core/executor.py``): each
element's span is its device interval, from its start event to its
completion event, placed on the executor's clock through the device's
anchor, inside its lane's host spans; the lane gap is counted on the
device.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_trace_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import function, make_scheduler
from repro_torch.core.executor import ANCHOR_PERIOD_S, anchor_reading

SLEEP_CYCLES = 20_000_000        # about 10 ms at the H100's clocks
# The anchor places an event within half its reading's width; a few
# microseconds more for the clock's own reads.
TOL_S = 50e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lanes are CUDA streams")
    return torch.device("cuda")


def sleep_s() -> float:
    """The device time of one ``torch.cuda._sleep(SLEEP_CYCLES)``, by
    CUDA events, after a warm one."""
    torch.cuda._sleep(SLEEP_CYCLES)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def spin(x, o):
    torch.cuda._sleep(SLEEP_CYCLES)
    return x + 1


@pytest.mark.cuda
def test_element_span_is_its_device_interval(card):
    want = sleep_s()
    k = function(spin, modes=("const", "out"), name="spin", outputs=0)
    s = make_scheduler("parallel", device="cuda", trace=True)
    try:
        # a first round loads the kernels' modules, which holds the device
        # idle inside the elements' intervals
        for _ in range(2):
            n0 = len(s.timeline.spans)
            x = s.array(np.zeros(16, np.float32), name="x")
            ys = [k.with_options(scheduler=s)(x) for _ in range(3)]
            s.sync()
            assert all(np.asarray(y)[0] == 1.0 for y in ys)
        spans = list(s.timeline.spans)
        stats = s.stats()
    finally:
        s.close()
    spins = [sp for sp in spans[n0:] if sp.name == "spin"]
    assert len(spins) == 3
    for e in spins:
        before = [sp for sp in spans[:spans.index(e)] if sp.lane == e.lane]
        issue = next(sp for sp in reversed(before) if sp.name == "lane.issue")
        sync = next(sp for sp in reversed(before) if sp.name == "lane.sync")
        assert issue.dur < want / 2, "the launch returns before the sleep"
        # the kernel's device time, and of the host's issue at most the
        # part between the start event and the launches (three lane
        # threads take turns at the interpreter there)
        assert want - TOL_S <= e.dur <= want + issue.dur + TOL_S
        assert issue.t0 - TOL_S <= e.t0 <= issue.t1 + TOL_S
        assert sync.t0 - TOL_S <= e.t1 <= sync.t1 + TOL_S
    n, gap = stats["lane_gap"]
    # every element after a stream's first counts one gap, on the device
    lanes = {sp.lane for sp in spans if sp.kind in ("compute", "h2d")}
    elements = sum(1 for sp in spans if sp.kind in ("compute", "h2d"))
    assert n == elements - len(lanes) and gap >= 0.0


@pytest.mark.cuda
def test_anchor_reading_tracks_the_host_clock(card):
    """Two anchor readings half a re-anchoring period apart: the device's
    time between them is the host's, so that an anchor places an event
    within ``TOL_S`` for a whole period (besides the readings' widths)."""
    import time
    stream = torch.cuda.Stream(priority=-1)
    a, ta, wa = anchor_reading(stream, time.perf_counter)
    time.sleep(ANCHOR_PERIOD_S / 2)
    b, tb, wb = anchor_reading(stream, time.perf_counter)
    assert max(wa, wb) < TOL_S
    drift = (tb - ta) - a.elapsed_time(b) / 1e3
    assert abs(drift) <= TOL_S / 2 + (wa + wb) / 2
