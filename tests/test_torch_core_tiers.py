"""Tiered spill hierarchy in the port, the suite of ``tests/test_tiers.py``
with torch kernels on CPU lanes: the pluggable BackingTier stack.

Covers the tier stack end to end: construction (``make_tiers`` names /
instances / errors), the bit-identical no-tiers default, the peer-device
tier's strict sim-makespan win over flat D2H, physical round trips on the
real executor for every tier (disk and lossless-compressed bit-exact,
bf16 within its designed bound), stack ordering (capacity overflow to the
next tier), spool-file hygiene (shutdown + GC), the ``verify()`` debug
hook, capture/replay under a tier stack, and the checkpoint manager's
snapshot-through-spill (hard-linked disk spills, nondestructive reads of
the compressed tier).
"""
import gc
import glob
import os

import numpy as np
import pytest

from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401

from repro_torch.checkpoint import CheckpointManager
from repro_torch.benchsuite.outofcore import (build_outofcore, verify_outofcore,
                                              working_set_bytes)
from repro_torch.core import (CompressedHostTier, DiskTier, ElementKind,
                              PeerDeviceTier, function, make_scheduler)
from repro_torch.core.tiers import make_tiers

N = 256
CHUNK = 4 * N

STAGE = function(lambda x, o: x * 2.0 + 1.0, modes=("const", "out"),
                 name="tier_stage", outputs=0)


def _stage(sched, cost_s=1e-4):
    return STAGE.with_options(scheduler=sched, cost_s=cost_s)


def _tiered_outofcore(tiers, *, simulate, chunks=6, n=N, cost_s=1e-4,
                      num_devices=1, device=None, budget=None):
    if budget is None:
        budget = working_set_bytes(chunks, n) // 2
    s = make_scheduler("parallel", simulate=simulate, num_devices=num_devices,
                       memory_budget=budget, spill_tiers=tiers, device="cpu")
    arrays = build_outofcore(s, chunks=chunks, n=n, cost_s=cost_s,
                             device=device)
    return s, arrays


# ======================================================================
# Construction and the flat default
# ======================================================================

def test_make_tiers_accepts_names_instances_and_rejects_junk():
    tiers = make_tiers(["peer-device", CompressedHostTier(lossy=True), "disk"])
    assert [t.name for t in tiers] == ["peer-device", "compressed-host",
                                      "disk"]
    assert tiers[1].lossy
    assert make_tiers(None) == []
    with pytest.raises(ValueError, match="unknown spill tier"):
        make_tiers(["nvme-of"])
    with pytest.raises(TypeError):
        make_tiers([42])
    tiers[2].close()                   # remove the spool dir it created


def test_no_tiers_default_is_bit_identical_flat_d2h():
    """``spill_tiers=None`` (and ``[]``) must execute the exact flat
    schedule: identical timeline spans, identical memory stats, no
    ``mem_tiers`` key, every EVICT on the D2H engine."""
    def run(**kw):
        s = make_scheduler("parallel", simulate=True,
                           memory_budget=working_set_bytes(6, N) // 2, **kw)
        build_outofcore(s, chunks=6, n=N, cost_s=1e-4)
        s.sync()
        spans = [(sp.name, sp.kind, sp.lane, sp.t0, sp.t1)
                 for sp in s.timeline.spans]
        stats = {k: v for k, v in s.stats().items() if k.startswith("mem_")}
        return spans, stats
    spans_default, st_default = run()
    spans_none, st_none = run(spill_tiers=None)
    spans_empty, st_empty = run(spill_tiers=[])
    assert spans_default == spans_none == spans_empty
    assert st_default == st_none == st_empty
    assert "mem_tiers" not in st_default
    evict_kinds = {k for name, k, *_ in spans_default
                   if name.startswith("evict_")}
    assert evict_kinds == {"d2h"}


def test_stack_miss_falls_back_to_flat_d2h():
    """A stack whose every tier refuses (capacity 0) behaves like flat
    D2H: no tier residency, plain EVICT write-backs."""
    tier = CompressedHostTier(capacity_bytes=0)
    s, arrays = _tiered_outofcore([tier], simulate=True)
    s.sync()
    st = s.stats()
    assert st["mem_spills"] >= 1
    assert st["mem_tiers"]["compressed-host"]["spills"] == 0
    assert all(a.backing_tier is None
               for a in arrays["x"] + arrays["y"] + arrays["z"])
    assert s.memory.verify().ok


# ======================================================================
# Peer-device tier: sim makespan acceptance
# ======================================================================

def test_peer_tier_sim_strictly_beats_flat_d2h():
    """Acceptance: out-of-core with a peer tier beats flat D2H
    on simulated makespan (D2D at 50 GB/s vs PCIe at 12 GB/s), with the
    spilled blocks parked device-resident on the idle peer."""
    kw = dict(simulate=True, chunks=6, n=1 << 16, cost_s=1e-5,
              num_devices=2, device=0,
              budget={0: working_set_bytes(6, 1 << 16) // 2, 1: None})
    s_flat, _ = _tiered_outofcore(None, **kw)
    s_flat.sync()
    s_peer, arrays = _tiered_outofcore([PeerDeviceTier()], **kw)
    s_peer.sync()
    assert s_peer.timeline.makespan < s_flat.timeline.makespan
    tstats = s_peer.stats()["mem_tiers"]["peer-device"]
    assert tstats["spills"] >= 1 and tstats["wire_bytes"] > 0
    # Peer spills ran on the D2D link, not the D2H engine.
    assert any(sp.kind == "d2d" and sp.name.startswith("evict_")
               for sp in s_peer.timeline.spans)
    # Peer-parked blocks are device-resident (no backing_tier: the migrate
    # stage brings them back with a plain D2D).
    assert all(a.backing_tier is None
               for a in arrays["x"] + arrays["y"] + arrays["z"])
    assert s_peer.memory.verify().ok


def test_peer_tier_refuses_without_budget_room():
    """A peer with no free budget never accepts — spills must not cascade."""
    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       memory_budget={0: 2 * CHUNK, 1: CHUNK},
                       spill_tiers=[PeerDeviceTier()])
    stage = STAGE.with_options(scheduler=s, cost_s=1e-4, device=0)
    xs = [s.array(np.ones(N, np.float32), name=f"pr_{i}") for i in range(3)]
    for x in xs:
        stage(x)
    s.sync()
    # Device 1's budget (1 chunk) can never hold a spill while also being
    # eligible: anything routed there would exceed its budget.
    assert s.memory.pools[1].resident_bytes <= CHUNK
    assert s.memory.verify().ok


# ======================================================================
# Physical round trips on the real executor
# ======================================================================

def test_disk_tier_real_roundtrip_bit_exact(tmp_path):
    tier = DiskTier(spool_dir=str(tmp_path))
    s, arrays = _tiered_outofcore([tier], simulate=False)
    try:
        assert verify_outofcore(arrays)
        s.sync()
        st = s.stats()["mem_tiers"]["disk"]
        assert st["spills"] >= 1 and tier.files_written >= 1
        # Bit-exact: the closed form in float32 exactly.
        for x, z in zip(arrays["x"], arrays["z"]):
            expect = np.asarray(x.host, np.float32) * 4.0 + 3.0
            np.testing.assert_array_equal(np.asarray(z), expect)
        assert s.memory.verify().ok
    finally:
        s.shutdown()
    # Satellite 2: no leaked spool files after shutdown.
    assert glob.glob(os.path.join(str(tmp_path), "blk_*")) == []


def test_compressed_lossless_real_roundtrip_bit_exact():
    tier = CompressedHostTier(lossy=False)
    s, arrays = _tiered_outofcore([tier], simulate=False)
    try:
        assert verify_outofcore(arrays)
        s.sync()
        st = s.stats()["mem_tiers"]["compressed-host"]
        assert st["spills"] >= 1 and not st["lossy"]
        for x, z in zip(arrays["x"], arrays["z"]):
            expect = np.asarray(x.host, np.float32) * 4.0 + 3.0
            np.testing.assert_array_equal(np.asarray(z), expect)
        assert s.memory.verify().ok
    finally:
        s.shutdown()


def test_compressed_lossy_real_roundtrip_within_bf16_bound():
    """bf16 demotion: exact only to the tier's reported ``max_abs_error``
    bound (~2^-8 relative), never bit-exact — the exactness flag is the
    contract."""
    tier = CompressedHostTier(lossy=True)
    s, arrays = _tiered_outofcore([tier], simulate=False)
    try:
        s.sync()
        st = s.stats()["mem_tiers"]["compressed-host"]
        assert st["lossy"] and st["lossy_blocks"] >= 1
        bound = st["max_abs_error"]
        assert 0.0 < bound < 0.05
        for x, z in zip(arrays["x"], arrays["z"]):
            expect = np.asarray(x.host, np.float32) * 4.0 + 3.0
            # One lossy hop per value at most (y spilled, z = 2*y + 1).
            assert np.max(np.abs(np.asarray(z) - expect)) <= 2 * bound + 1e-7
        assert s.memory.verify().ok
    finally:
        s.shutdown()


def test_peer_tier_real_roundtrip_bit_exact():
    tier = PeerDeviceTier()
    s, arrays = _tiered_outofcore([tier], simulate=False, num_devices=2,
                                  device=0,
                                  budget={0: working_set_bytes(6, N) // 2,
                                          1: None})
    try:
        assert verify_outofcore(arrays)
        for x, z in zip(arrays["x"], arrays["z"]):
            expect = np.asarray(x.host, np.float32) * 4.0 + 3.0
            np.testing.assert_array_equal(np.asarray(z), expect)
        s.sync()
        assert s.stats()["mem_tiers"]["peer-device"]["spills"] >= 1
        assert s.memory.verify().ok
    finally:
        s.shutdown()


def test_host_read_restores_through_tier():
    """``ma.read()`` of a tier-resident block must decode the payload
    synchronously (host access localization through the tier)."""
    tier = CompressedHostTier(lossy=False)
    s = make_scheduler("parallel", device="cpu", memory_budget=2 * CHUNK,
                       spill_tiers=[tier])
    try:
        x = s.array(np.full(N, 2.0, np.float32), name="hr_x")
        y = _stage(s)(x)                     # dirty device-only output
        x2 = s.array(np.full(N, 5.0, np.float32), name="hr_x2")
        _stage(s)(x2)                        # pressure: y spilled to tier
        s.sync()
        assert y.backing_tier == "compressed-host"
        np.testing.assert_array_equal(y.read(), np.full(N, 5.0, np.float32))
        assert y.backing_tier is None and y.host_valid
        assert s.memory.verify().ok
    finally:
        s.shutdown()


# ======================================================================
# Stack ordering, capacity overflow, hygiene
# ======================================================================

def test_stack_overflows_to_next_tier(tmp_path):
    """First-accepting-tier-wins: a capacity-bounded compressed tier takes
    blocks until full, the rest overflow to disk."""
    comp = CompressedHostTier(lossy=False, capacity_bytes=CHUNK)
    disk = DiskTier(spool_dir=str(tmp_path))
    s, arrays = _tiered_outofcore([comp, disk], simulate=True, chunks=8)
    s.sync()
    st = s.stats()["mem_tiers"]
    assert st["compressed-host"]["spills"] >= 1
    assert st["disk"]["spills"] >= 1
    assert st["compressed-host"]["spilled_bytes_resident"] <= CHUNK
    assert s.memory.verify().ok
    s.shutdown()


def test_disk_spool_removed_on_gc(tmp_path):
    """Satellite 2: a tier-resident block that becomes garbage must drop
    its spool file via the weakref finalizer — no leaks between spill and
    shutdown."""
    tier = DiskTier(spool_dir=str(tmp_path))
    s = make_scheduler("parallel", device="cpu", memory_budget=2 * CHUNK,
                       spill_tiers=[tier])
    try:
        x = s.array(np.ones(N, np.float32), name="gc_x")
        y = _stage(s)(x)
        x2 = s.array(np.ones(N, np.float32), name="gc_x2")
        _stage(s)(x2)                        # y spilled to disk
        s.sync()
        assert y.backing_tier == "disk"
        assert len(glob.glob(os.path.join(str(tmp_path), "blk_*"))) == 1
        del y
        gc.collect()
        assert glob.glob(os.path.join(str(tmp_path), "blk_*")) == []
        assert s.memory.verify().ok
    finally:
        s.shutdown()


def test_disk_own_spool_dir_removed_on_shutdown():
    tier = DiskTier()
    spool = tier.spool_dir
    assert os.path.isdir(spool)
    s, arrays = _tiered_outofcore([tier], simulate=False)
    s.shutdown()
    assert not os.path.exists(spool)


def test_pool_occupancy_and_verify_hook():
    """Satellite 1: ``MemoryPool.stats()`` exposes occupancy, scheduler
    stats aggregate it, per-tier ``spilled_bytes_resident`` is reported
    and ``verify()`` is clean after a tiered workload."""
    tier = CompressedHostTier(lossy=False)
    s, arrays = _tiered_outofcore([tier], simulate=True)
    s.sync()
    pstats = s.memory.pools[0].stats()
    assert 0.0 <= pstats["occupancy"] <= 1.0
    st = s.stats()
    assert 0.0 <= st["mem_occupancy"] <= 1.0
    tstats = st["mem_tiers"]["compressed-host"]
    assert tstats["spilled_bytes_resident"] == sum(
        a.nbytes for a in arrays["x"] + arrays["y"] + arrays["z"]
        if a.backing_tier == "compressed-host")
    assert s.memory.verify().ok
    # The unbounded default reports occupancy 0 (nothing to fill).
    s2 = make_scheduler("parallel", simulate=True)
    assert s2.memory.pools[0].stats()["occupancy"] == 0.0


# ======================================================================
# Capture/replay under a tier stack
# ======================================================================

def test_capture_replays_tier_spills():
    """A captured episode that spills to a tier must replay (same tier
    residency at episode entry) and keep the tier bookkeeping exact."""
    tier = CompressedHostTier(lossy=False)
    s = make_scheduler("parallel", device="cpu", memory_budget=2 * CHUNK,
                       spill_tiers=[tier])
    try:
        outs = []
        for ep in range(3):
            with s.capture("tier_ep"):
                # Second allocation forces the first (dirty, non-frontier)
                # output onto the tier *inside* the episode, so the plan
                # records a tier EVICT.
                x = s.array(np.full(N, float(ep), np.float32),
                            name=f"tc{ep}_a")
                y = _stage(s)(x)
                x2 = s.array(np.full(N, float(ep + 10), np.float32),
                             name=f"tc{ep}_b")
                y2 = _stage(s)(x2)
                outs.append((y, y2))
            s.sync()
        st = s.stats()
        assert st["plan_records"] == 1 and st["plan_replays"] == 2
        (plan,) = s.plan_cache.candidates("tier_ep")
        evict_cfgs = [cfg for pe, cfg in zip(plan.elements, plan.configs)
                      if pe.kind is ElementKind.EVICT]
        assert any(cfg.get("tier") == "compressed-host"
                   for cfg in evict_cfgs)
        for ep, (y, y2) in enumerate(outs):
            np.testing.assert_array_equal(
                y.read(), np.full(N, 2.0 * ep + 1.0, np.float32))
            np.testing.assert_array_equal(
                y2.read(), np.full(N, 2.0 * (ep + 10) + 1.0, np.float32))
        assert s.memory.verify().ok
    finally:
        s.shutdown()


# ======================================================================
# Snapshot-through-spill (checkpoint integration)
# ======================================================================

def test_save_managed_hard_links_disk_spills(tmp_path):
    """A disk-resident block is checkpointed by hard-linking the published
    spool file — zero data movement — and restores bit-exact; the spill
    stays resident (the checkpoint is a copy-on-write reference)."""
    tier = DiskTier(spool_dir=str(tmp_path / "spool"))
    s = make_scheduler("parallel", memory_budget=2 * CHUNK,
                       spill_tiers=[tier], device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    try:
        x = s.array(np.arange(N, dtype=np.float32), name="sl_x")
        y = _stage(s)(x)
        x2 = s.array(np.ones(N, np.float32), name="sl_x2")
        y2 = _stage(s)(x2)                   # y spilled to disk
        s.sync()
        assert y.backing_tier == "disk"
        expect_y = np.arange(N, dtype=np.float32) * 2.0 + 1.0
        stats = mgr.save_managed(7, {"y": y, "y2": y2})
        assert stats["spill_links"] == 1
        assert stats["spill_link_bytes"] == y.nbytes
        assert y.backing_tier == "disk"      # spill undisturbed
        # The link shares the spool inode (metadata-only snapshot).
        ckpt_file = os.path.join(str(tmp_path / "ckpt"), "step_7", "y.npy")
        from repro_torch.core.element import dep_key
        spool_file = tier.path_for(dep_key(y))
        assert os.path.samefile(ckpt_file, spool_file)
        # Restore into fresh arrays: bit-exact through the link.
        ny = s.array(np.zeros(N, np.float32), name="sl_ny")
        ny2 = s.array(np.zeros(N, np.float32), name="sl_ny2")
        mgr.restore_managed({"y": ny, "y2": ny2}, step=7)
        np.testing.assert_array_equal(ny.read(), expect_y)
        np.testing.assert_array_equal(ny2.read(), np.full(N, 3.0, np.float32))
        assert s.memory.verify().ok
    finally:
        s.shutdown()


def test_save_managed_reads_compressed_tier_nondestructively(tmp_path):
    tier = CompressedHostTier(lossy=False)
    s = make_scheduler("parallel", memory_budget=2 * CHUNK,
                       spill_tiers=[tier], device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    try:
        x = s.array(np.arange(N, dtype=np.float32), name="tr_x")
        y = _stage(s)(x)
        x2 = s.array(np.ones(N, np.float32), name="tr_x2")
        _stage(s)(x2)                        # y spilled (compressed)
        s.sync()
        assert y.backing_tier == "compressed-host"
        stats = mgr.save_managed(1, {"y": y})
        assert stats["tier_reads"] == 1 and stats["spill_links"] == 0
        assert y.backing_tier == "compressed-host"   # peek, not reload
        ny = s.array(np.zeros(N, np.float32), name="tr_ny")
        mgr.restore_managed({"y": ny}, step=1)
        np.testing.assert_array_equal(
            ny.read(), np.arange(N, dtype=np.float32) * 2.0 + 1.0)
        assert s.memory.verify().ok
    finally:
        s.shutdown()
