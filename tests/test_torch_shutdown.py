"""Clean shutdown in the port, the suite of ``tests/test_shutdown.py`` with
torch kernels on CPU lanes: GrScheduler.close() joins executor workers and
releases spill tiers; stats()/tenant_stats() are consistent snapshots under
concurrent submission (no torn counters for a monitor loop).
"""
import os
import threading
import time

import numpy as np
import pytest

from repro_torch.core import const, make_scheduler, out
from repro_torch.core.tiers import DiskTier


def _lane_threads():
    return [t for t in threading.enumerate() if t.name.startswith("lane-")]


def test_close_joins_real_executor_worker_threads():
    s = make_scheduler("parallel", num_devices=2, device="cpu")
    x = s.array(np.arange(64, dtype=np.float32), name="x")
    y = s.array(np.zeros(64, np.float32), name="y")

    def fn(a, b):
        return a * 2

    s._launch(fn, [const(x), out(y)], name="dbl")
    s.sync()
    assert _lane_threads(), "expected live lane workers while open"
    s.close()
    for t in _lane_threads():
        assert not t.is_alive(), f"{t.name} still alive after close()"
    assert not _lane_threads()


def test_close_is_idempotent_and_shutdown_is_an_alias():
    s = make_scheduler("parallel", simulate=True)
    s.close()
    s.close()
    s.shutdown()                           # alias, also post-close safe
    assert s._closed


def test_context_manager_closes_even_on_error():
    with pytest.raises(RuntimeError, match="boom"):
        with make_scheduler("parallel", simulate=True) as s:
            raise RuntimeError("boom")
    assert s._closed


def test_close_drains_inflight_work_first():
    s = make_scheduler("parallel", device="cpu")
    x = s.array(np.ones(32, np.float32), name="x")
    y = s.array(np.zeros(32, np.float32), name="y")
    started = threading.Event()

    def slow(a, b):
        started.set()
        time.sleep(0.2)
        return a + 1

    e = s._launch(slow, [const(x), out(y)], name="slow")
    assert started.wait(10)
    s.close()                              # must drain, not abandon
    assert e.done_event.is_set()
    assert not _lane_threads()


def test_close_releases_disk_tier_spool_directory():
    s = make_scheduler("parallel", simulate=True,
                       memory_budget=8 * 1024, spill_tiers=[DiskTier()])
    spool = s.memory.tiers[0].spool_dir
    assert os.path.isdir(spool)
    # force dirty spills through the tier
    arrs = []
    for i in range(6):
        a = s.array(np.zeros(1024, np.float32), name=f"a{i}")
        b = s.array(np.zeros(1024, np.float32), name=f"b{i}")
        s._launch(None, [const(a), out(b)], name=f"k{i}", cost_s=1e-4)
        arrs += [a, b]
    s.sync()
    s.close()
    assert not os.path.isdir(spool), "spool dir must not rely on GC/atexit"


def test_serving_engine_owns_vs_borrowed_scheduler():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.runtime.serving import ServingEngine

    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    with ServingEngine(cfg, params, batch_size=2, max_new_tokens=2,
                       device="cpu") as eng:
        reqs = [eng.submit(rng.randint(0, cfg.vocab, 8)) for _ in range(2)]
        done = eng.drain()
        assert len(done) == 2 and all(r.result is not None for r in reqs)
    assert eng.sched._closed                # engine owned it -> closed

    borrowed = make_scheduler("parallel", device="cpu")
    with ServingEngine(cfg, params, batch_size=2, max_new_tokens=2,
                       scheduler=borrowed, device="cpu") as eng2:
        eng2.submit(rng.randint(0, cfg.vocab, 8))
    assert not borrowed._closed             # borrowed -> left open
    borrowed.close()


# ======================================================================
# Satellite 2: consistent stats snapshots under concurrency
# ======================================================================

def _stats_invariants(st):
    assert st["elements"] >= 0
    assert 0.0 <= st["mem_occupancy"] <= 1.0 + 1e-9
    assert st["mem_resident_bytes"] >= 0


def test_stats_and_tenant_stats_consistent_under_concurrent_launches():
    s = make_scheduler("parallel", num_devices=2, device="cpu",
                       memory_budget=1 << 20)
    stop = threading.Event()
    errors = []

    def reader():
        try:
            while not stop.is_set():
                _stats_invariants(s.stats())
                ts = s.tenant_stats()
                for _t, d in ts.items():
                    assert d["elements"] >= 1
                    assert d["busy_s"] >= 0.0
        except Exception as exc:            # surfaced below
            errors.append(exc)

    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in readers:
        t.start()

    def fn(a, b):
        return a * 0.5

    try:
        for i in range(40):
            x = s.array(np.ones(256, np.float32), name=f"x{i}")
            y = s.array(np.zeros(256, np.float32), name=f"y{i}")
            s._launch(fn, [const(x), out(y)],
                      name="halve", tenant=f"t{i % 3}")
            if i % 8 == 7:
                s.sync()
        s.sync()
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=10)
    assert errors == [], errors
    ts = s.tenant_stats()
    assert sum(d["elements"] for d in ts.values()) >= 40
    s.close()


def test_timeline_device_busy_since_walks_incrementally():
    s = make_scheduler("parallel", simulate=True)
    idx, busy = s.timeline.device_busy_since(0)
    assert busy == 0.0
    a = s.array(np.zeros(512, np.float32), name="a")
    b = s.array(np.zeros(512, np.float32), name="b")
    s._launch(None, [const(a), out(b)], name="k", cost_s=5e-3)
    s.sync()
    idx2, busy2 = s.timeline.device_busy_since(idx)
    assert idx2 > idx and busy2 >= 5e-3    # kernel + h2d transfers
    idx3, busy3 = s.timeline.device_busy_since(idx2)
    assert idx3 == idx2 and busy3 == 0.0   # nothing new since
    s.close()


def test_stats_snapshot_taken_under_submission_lock(monkeypatch):
    """stats() must hold the pipeline lock for its whole merge: patch one
    sub-stats source to assert the lock is held when it is sampled."""
    s = make_scheduler("parallel", simulate=True)
    seen = {}
    orig = type(s.memory).stats

    def probing_stats(self):
        seen["locked"] = s.pipeline._lock._is_owned()
        return orig(self)

    monkeypatch.setattr(type(s.memory), "stats", probing_stats)
    s.stats()
    assert seen["locked"] is True
    s.close()
