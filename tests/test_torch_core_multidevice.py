"""Multi-device scheduling in the port: the suite of
``tests/test_multidevice.py`` with torch kernels on CPU lanes — placement
policies, D2D insertion, simulated per-device capacity, and real-executor
correctness."""
import numpy as np
import pytest

from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401

from repro_torch.benchsuite.multidevice import (build_locality_heavy,
                                                build_task_parallel)
from repro_torch.core import (ElementKind, SimExecutor, SimHardware, const,
                              inout, make_scheduler, out)


# ----------------------------------------------------------------------
# Simulated scaling
# ----------------------------------------------------------------------

def _task_parallel_makespan(num_devices, placement="affinity"):
    s = make_scheduler("parallel", simulate=True, num_devices=num_devices,
                       placement=placement)
    build_task_parallel(s, branches=4, chain=4)
    s.sync()
    return s.timeline.makespan, s.stats()


def test_two_devices_beat_one_on_task_parallel():
    t1, _ = _task_parallel_makespan(1)
    t2, st2 = _task_parallel_makespan(2)
    assert t1 / t2 >= 1.5, f"2-device speedup only {t1 / t2:.2f}"
    # all lanes pinned, chains stay local
    assert st2["d2d_transfers"] == 0


def test_four_devices_scale_further():
    t2, _ = _task_parallel_makespan(2)
    t4, _ = _task_parallel_makespan(4)
    assert t4 < t2


def test_single_device_multidevice_api_is_identity():
    """num_devices=1 must behave exactly like the pre-multi-device runtime."""
    t_plain, st = _task_parallel_makespan(1)
    assert st["d2d_transfers"] == 0
    assert "lanes_per_device" not in st     # multi-device stats stay hidden


# ----------------------------------------------------------------------
# Placement policies
# ----------------------------------------------------------------------

def test_affinity_inserts_fewer_d2d_than_round_robin():
    def run(placement):
        s = make_scheduler("parallel", simulate=True, num_devices=2,
                           placement=placement)
        build_locality_heavy(s, groups=4, iters=6)
        s.sync()
        return s.stats()["d2d_transfers"]

    rr, aff = run("round-robin"), run("affinity")
    assert aff < rr
    assert aff == 0                         # persistent data never migrates


def test_round_robin_cycles_devices():
    s = make_scheduler("parallel", simulate=True, num_devices=3,
                       placement="round-robin")
    es = []
    for i in range(6):
        x = s.array(np.zeros(1024, np.float32), name=f"x{i}")
        es.append(s.launch(None, [inout(x)], name=f"k{i}", cost_s=1e-3))
    s.sync()
    assert [e.device for e in es] == [0, 1, 2, 0, 1, 2]


def test_min_load_spreads_independent_kernels():
    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       placement="min-load")
    es = []
    for i in range(4):
        x = s.array(np.zeros(1024, np.float32), name=f"x{i}")
        es.append(s.launch(None, [inout(x)], name=f"k{i}", cost_s=1e-3))
    s.sync()
    per_dev = {d: sum(1 for e in es if e.device == d) for d in (0, 1)}
    assert per_dev == {0: 2, 1: 2}


def test_affinity_follows_input_bytes():
    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       placement="affinity")
    big = s.array(np.zeros(1 << 20, np.float32), name="big")
    small = s.array(np.zeros(64, np.float32), name="small")
    k_big = s.launch(None, [inout(big)], name="warm_big", cost_s=1e-3)
    k_small = s.launch(None, [inout(small)], name="warm_small", cost_s=1e-3)
    assert k_big.device != k_small.device   # min-load fallback spread them
    y = s.array(shape=(1,), dtype=np.float32, name="y")
    k = s.launch(None, [const(big), const(small), out(y)], name="consume",
                 cost_s=1e-3)
    assert k.device == k_big.device         # big input wins
    s.sync()


# ----------------------------------------------------------------------
# Placement policies under contention (asymmetric DAG)
# ----------------------------------------------------------------------

def _asymmetric_contended(placement):
    """Two heavy bulk kernels contend with a short chain on a persistent
    array A.  Costs are distinct so min-load comparisons never tie.

    Launch order: bulk1 (5ms), warm-A (0.1ms), bulk2 (6ms), then two chain
    hops on A (0.2ms each).  Returns (kernel devices, d2d count)."""
    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       placement=placement)
    ks = []
    b1 = s.array(np.zeros(1 << 12, np.float32), name="b1")
    ks.append(s.launch(None, [inout(b1)], name="bulk1", cost_s=5e-3))
    A = s.array(np.zeros(1 << 12, np.float32), name="A")
    ks.append(s.launch(None, [inout(A)], name="warmA", cost_s=1e-4))
    b2 = s.array(np.zeros(1 << 12, np.float32), name="b2")
    ks.append(s.launch(None, [inout(b2)], name="bulk2", cost_s=6e-3))
    ks.append(s.launch(None, [inout(A)], name="hop1", cost_s=2e-4))
    ks.append(s.launch(None, [inout(A)], name="hop2", cost_s=2e-4))
    s.sync()
    return [k.device for k in ks], s.stats()["d2d_transfers"]


def test_affinity_keeps_contended_chain_local():
    devices, d2d = _asymmetric_contended("affinity")
    # bulk1 -> dev0 (fallback), warm/bulk2 -> dev1 (less loaded); the chain
    # then follows A's bytes and never migrates.
    assert devices == [0, 1, 1, 1, 1]
    assert d2d == 0


def test_min_load_migrates_contended_chain():
    devices, d2d = _asymmetric_contended("min-load")
    # bulk2 lands next to A (dev1 was less loaded), so min-load pulls the
    # chain's first hop to the idle device despite locality: one migration.
    assert devices == [0, 1, 1, 0, 0]
    assert d2d == 1


def test_round_robin_scatters_contended_chain():
    devices, d2d = _asymmetric_contended("round-robin")
    # Pure cycling: hop2's device differs from hop1's, dragging A across
    # the link once even though nothing about load or locality asked for it.
    assert devices == [0, 1, 0, 1, 0]
    assert d2d == 1


# ----------------------------------------------------------------------
# D2D transfer elements
# ----------------------------------------------------------------------

def test_d2d_inserted_for_cross_device_read():
    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       placement="round-robin")
    x = s.array(np.zeros(1 << 20, np.float32), name="x")
    s.launch(None, [inout(x)], name="k0", cost_s=1e-3)      # device 0
    k1 = s.launch(None, [inout(x)], name="k1", cost_s=1e-3)  # device 1
    assert k1.device == 1
    assert s.d2d_transfers == 1
    # The D2D element is the kernel's parent (RAW through the moved copy).
    kinds = [p.kind for p in k1.parents]
    assert ElementKind.D2D in kinds
    s.sync()
    d2d = [sp for sp in s.timeline.spans if sp.kind == "d2d"]
    assert len(d2d) == 1
    # The copy occupies the link for bytes / d2d_gbps seconds.
    expect = (1 << 22) / (s.executor.hw.d2d_gbps * 1e9)
    assert d2d[0].dur == pytest.approx(expect, rel=1e-6)


def test_d2d_moves_ownership_once_per_migration():
    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       placement="affinity")
    x = s.array(np.zeros(1024, np.float32), name="x")
    s.launch(None, [inout(x)], name="k0", cost_s=1e-3)
    # Affinity keeps every later consumer on the owning device: no D2D.
    for i in range(5):
        s.launch(None, [inout(x)], name=f"k{i + 1}", cost_s=1e-3)
    s.sync()
    assert s.d2d_transfers == 0


def test_sim_hardware_promoted_to_requested_devices():
    hw = SimHardware(h2d_gbps=10.0)
    s = make_scheduler("parallel", simulate=True, hw=hw, num_devices=2)
    assert isinstance(s.executor, SimExecutor)
    assert s.executor.hw.num_devices == 2
    assert s.executor.hw.h2d_gbps == 10.0   # calibration preserved


def test_per_device_capacity_is_independent():
    """Two full-occupancy kernels: same device -> serialized; two devices ->
    concurrent."""
    def run(num_devices, placement):
        s = make_scheduler("parallel", simulate=True,
                           num_devices=num_devices, placement=placement)
        for i in range(2):
            x = s.array(np.zeros(1024, np.float32), name=f"x{i}")
            s.launch(None, [inout(x)], name=f"k{i}", cost_s=1e-2,
                     parallel_fraction=1.0)
        s.sync()
        return s.timeline.makespan

    t1 = run(1, "round-robin")
    t2 = run(2, "round-robin")
    assert t1 >= 2e-2 * 0.99
    assert t2 <= 1.1e-2


# ----------------------------------------------------------------------
# Real executor (ThreadLaneExecutor): correctness with any device count
# ----------------------------------------------------------------------

@pytest.mark.parametrize("placement", ["round-robin", "min-load", "affinity"])
def test_real_executor_multidevice_matches_numpy(placement):
    s = make_scheduler("parallel", num_devices=2, placement=placement,
                       device="cpu")
    try:
        x = s.array(np.arange(64, dtype=np.float32), name="x")
        y = s.array(np.zeros(64, np.float32), name="y")
        z = s.array(np.zeros(64, np.float32), name="z")
        s.launch(lambda a, _: a * a, [const(x), out(y)], name="sq")
        s.launch(lambda a, _: a + 3, [const(x), out(z)], name="p3")
        s.launch(lambda a, b: a + b, [const(y), inout(z)],
                 name="mix")
        ref = np.arange(64, dtype=np.float32)
        np.testing.assert_allclose(np.asarray(z), ref ** 2 + ref + 3)
    finally:
        s.shutdown()


def test_real_executor_task_parallel_chains():
    s = make_scheduler("parallel", num_devices=2, placement="affinity",
                       device="cpu")
    try:
        outs = []
        for b in range(3):
            x = s.array(np.full(32, float(b), np.float32), name=f"x{b}")
            for _ in range(3):
                y = s.array(np.zeros(32, np.float32), name=f"y{b}")
                s.launch(lambda a, _: a + 1, [const(x), out(y)],
                         name="inc")
                x = y
            outs.append(x)
        for b, o in enumerate(outs):
            np.testing.assert_allclose(np.asarray(o), b + 3)
    finally:
        s.shutdown()
