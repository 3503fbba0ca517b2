"""GrFunction frontend + ambient runtime in the port: the suite of
``tests/test_frontend.py`` with torch kernels on CPU lanes.

Covers: declare-once call semantics (modes, output allocation, call-scoped
options), the ambient-runtime resolution order (explicit > bound > ambient >
array-inferred) and its edge cases (nesting, cross-thread isolation, the
no-runtime error), capture keyed by declared-function identity, the
deprecated ``scheduler.launch`` shim, and the ManagedArray
write-after-transfer ownership regression."""
import threading

import numpy as np
import pytest

from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401

import repro_torch.api as gr
from repro_torch.core import AccessMode, ElementKind, make_scheduler
from repro_torch.core.frontend import set_runtime


@pytest.fixture(autouse=True)
def _clean_default_runtime():
    """Never leak a module-level default runtime across tests."""
    prev = set_runtime(None)
    yield
    set_runtime(prev)


def sim():
    return make_scheduler("parallel", simulate=True)


def kernels_in(s):
    return [sp for sp in s.timeline.spans if sp.kind == "compute"]


# ----------------------------------------------------------------------
# GrFunction call semantics
# ----------------------------------------------------------------------

def test_declared_modes_drive_dependencies():
    s = sim()
    sq = gr.function(None, modes=("const", "out"), name="SQ", cost_s=1e-4)
    red = gr.function(None, modes=("const", "const", "out"), name="RED",
                      cost_s=1e-4)
    x1, x2 = s.array(np.ones(64, np.float32)), s.array(np.ones(64, np.float32))
    y1 = s.array(shape=(64,), dtype=np.float32)
    y2 = s.array(shape=(64,), dtype=np.float32)
    z = s.array(shape=(1,), dtype=np.float32)
    e1 = sq(x1, y1, scheduler=s)
    e2 = sq(x2, y2, scheduler=s)
    e3 = red(y1, y2, z, scheduler=s)
    s.sync()
    assert {p.name for p in e3.parents} == {e1.name, e2.name}
    assert e1.stream != e2.stream           # independent branches overlap
    assert [a.mode for a in e3.args] == [AccessMode.CONST, AccessMode.CONST,
                                         AccessMode.OUT]


def test_output_allocation_like_input_and_explicit_spec():
    s = make_scheduler("parallel", device="cpu")
    try:
        dbl = gr.function(lambda a, _o: a * 2.0,
                          modes=("const", "out"), outputs=0, name="DBL")
        total = gr.function(lambda a, _o: a.sum()[None],
                            modes=("const", "out"),
                            outputs=((1,), np.float32), name="SUM")
        x = s.array(np.arange(32, dtype=np.float32), name="x")
        y = dbl(x, scheduler=s)             # runtime-allocated from spec
        z = total(y, scheduler=s)
        np.testing.assert_allclose(np.asarray(z), [2.0 * np.arange(32).sum()])
        np.testing.assert_allclose(np.asarray(y), 2.0 * np.arange(32))
        assert y.shape == (32,) and y.dtype == np.float32
    finally:
        s.shutdown()


def test_output_spec_tuple_sequence_and_pair_disambiguation():
    """A 2-tuple of non-shape specs is a sequence (one per OUT position);
    a ((shape,), dtype) 2-tuple is a single pair."""
    s = sim()
    two = gr.function(None, modes=("const", "const", "out", "out"),
                      outputs=(0, 1), name="TWO", cost_s=1e-4)
    a = s.array(np.zeros((4,), np.float32))
    b = s.array(np.zeros((8,), np.float64))
    o1, o2 = two(a, b, scheduler=s)
    assert o1.shape == (4,) and o1.dtype == np.float32
    assert o2.shape == (8,) and o2.dtype == np.float64
    pair = gr.function(None, modes=("const", "out"),
                       outputs=((3, 3), np.int32), name="PAIR", cost_s=1e-4)
    o = pair(a, scheduler=s)
    assert o.shape == (3, 3) and o.dtype == np.int32
    # A 2-sequence of explicit pairs is a sequence, not one pair.
    pairs2 = gr.function(None, modes=("const", "out", "out"),
                         outputs=[((4,), np.float32), ((8,), np.int32)],
                         name="PAIRS2", cost_s=1e-4)
    p1, p2 = pairs2(a, scheduler=s)
    assert p1.shape == (4,) and p1.dtype == np.float32
    assert p2.shape == (8,) and p2.dtype == np.int32
    s.sync()
    bad = gr.function(None, modes=("const", "out"), outputs="nope",
                      name="BAD")
    with pytest.raises(TypeError, match="output spec"):
        bad(a, scheduler=s)


def test_with_options_overrides_outputs_without_polluting_config():
    s = sim()
    f = gr.function(None, modes=("const", "out"), outputs=0, name="K",
                    cost_s=1e-4)
    x = s.array(np.zeros(4, np.float32))
    g = f.with_options(outputs=((8,), np.int64))
    y = g(x, scheduler=s)
    assert y.shape == (8,) and y.dtype == np.int64   # override honored
    assert "outputs" not in g.config                 # not leaked to config
    y0 = f(x, scheduler=s)
    assert y0.shape == (4,) and y0.dtype == np.float32
    s.sync()


def test_missing_non_out_argument_raises():
    s = sim()
    f = gr.function(None, modes=("const", "inout"), name="K")
    x = s.array(np.zeros(8, np.float32))
    with pytest.raises(TypeError, match="must be supplied"):
        f(x, scheduler=s)


def test_allocation_without_spec_raises():
    s = sim()
    f = gr.function(None, modes=("const", "out"), name="K")
    x = s.array(np.zeros(8, np.float32))
    with pytest.raises(TypeError, match="outputs= spec"):
        f(x, scheduler=s)


def test_with_options_scopes_qos_and_cost_without_mutating_declaration():
    s = sim()
    f = gr.function(None, modes=("inout",), name="K", cost_s=1e-4)
    x = s.array(np.zeros(8, np.float32))
    e = f.with_options(priority=2, tenant="lat", cost_s=5e-4,
                       parallel_fraction=0.5)(x, scheduler=s)
    assert (e.priority, e.tenant, e.cost_s) == (2, "lat", 5e-4)
    assert e.config["parallel_fraction"] == 0.5
    e2 = f(x, scheduler=s)                  # the declaration is untouched
    assert (e2.priority, e2.tenant, e2.cost_s) == (0, "default", 1e-4)
    assert "parallel_fraction" not in e2.config
    assert e.fn_key == e2.fn_key == f.fid   # same declared identity
    s.sync()


def test_with_options_device_pins_placement():
    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       placement="round-robin")
    f = gr.function(None, modes=("inout",), name="K", cost_s=1e-4)
    xs = [s.array(np.zeros(8, np.float32), name=f"x{i}") for i in range(4)]
    es = [f.with_options(device=1)(x, scheduler=s) for x in xs]
    s.sync()
    assert all(e.device == 1 for e in es)   # round-robin bypassed
    # and the auto-inserted prefetches followed the pinned device
    transfers = [sp for sp in s.timeline.spans if sp.kind == "h2d"]
    assert len(transfers) == 4


# ----------------------------------------------------------------------
# Ambient runtime resolution
# ----------------------------------------------------------------------

def test_no_active_runtime_raises_clear_error():
    f = gr.function(None, modes=("inout",), name="K")
    with pytest.raises(gr.NoActiveRuntimeError,
                       match="gr.runtime|scheduler="):
        f(object())
    with pytest.raises(gr.NoActiveRuntimeError):
        gr.get_runtime()
    with pytest.raises(gr.NoActiveRuntimeError):
        gr.array(np.zeros(4, np.float32))


def test_ambient_runtime_resolves_arrays_and_calls():
    f = gr.function(None, modes=("const", "out"), name="K", cost_s=1e-4)
    with gr.runtime(policy="parallel", simulate=True) as s:
        x = gr.array(np.zeros(16, np.float32), name="x")
        y = gr.array(shape=(16,), dtype=np.float32, name="y")
        e = f(x, y)
        assert x._scheduler is s
        assert e in s._elements
        s.sync()
    assert gr.current_runtime() is None     # popped on exit


def test_nested_runtime_contexts_inner_wins_and_unwind():
    f = gr.function(None, modes=("inout",), name="K", cost_s=1e-4)
    with gr.runtime(policy="parallel", simulate=True) as outer:
        xo = gr.array(np.zeros(8, np.float32))
        with gr.runtime(policy="parallel", simulate=True) as inner:
            assert gr.get_runtime() is inner
            xi = gr.array(np.zeros(8, np.float32))
            assert xi._scheduler is inner
            f(xi)
        assert gr.get_runtime() is outer    # inner popped, outer restored
        f(xo)
        outer.sync()
        inner.sync()
        assert len(kernels_in(outer)) == 1
        assert len(kernels_in(inner)) == 1
    with pytest.raises(gr.NoActiveRuntimeError):
        gr.get_runtime()


def test_explicit_scheduler_beats_ambient_beats_array_inference():
    f = gr.function(None, modes=("inout",), name="K", cost_s=1e-4)
    s_exp, s_amb, s_arr = sim(), sim(), sim()
    x = s_arr.array(np.zeros(8, np.float32))
    with gr.runtime(scheduler=s_amb):
        assert f(x, scheduler=s_exp) in s_exp._elements
        assert f(x) in s_amb._elements      # ambient wins over the array's
    assert f(x) in s_arr._elements          # falls back to the array's owner
    for s in (s_exp, s_amb, s_arr):
        s.sync()


def test_module_level_default_runtime():
    s = sim()
    f = gr.function(None, modes=("inout",), name="K", cost_s=1e-4)
    set_runtime(s)
    x = gr.array(np.zeros(8, np.float32))
    f(x)
    with gr.runtime(policy="parallel", simulate=True) as inner:
        assert gr.get_runtime() is inner    # thread stack beats the default
    assert gr.get_runtime() is s
    s.sync()
    assert len(kernels_in(s)) == 1


def test_runtime_adopting_scheduler_rejects_factory_kwargs():
    s = sim()
    with pytest.raises(TypeError, match="adopts an existing"):
        gr.runtime(scheduler=s, num_devices=2)
    with pytest.raises(TypeError, match="policy"):
        gr.runtime("serial", scheduler=s)   # would silently ignore "serial"


def test_shared_runtime_instance_is_safe_across_threads():
    """The scheduler is created eagerly, so one runtime object entered from
    several threads concurrently pushes the same scheduler everywhere (no
    lazy-creation race, no spurious LIFO error on exit)."""
    rt = gr.runtime(policy="parallel", simulate=True)
    f = gr.function(None, modes=("inout",), name="K", cost_s=1e-5)
    errs = []
    barrier = threading.Barrier(4)

    def worker(tid):
        try:
            barrier.wait()
            with rt as s:
                assert s is rt.scheduler
                f(gr.array(np.zeros(8, np.float32), name=f"x{tid}"))
            assert gr.current_runtime() is None
        except BaseException as exc:
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    rt.scheduler.sync()
    assert len(kernels_in(rt.scheduler)) == 4


def test_cross_thread_isolation_of_runtime_stack():
    """4 threads each enter their own ambient runtime (multitenant-harness
    pattern: barrier + shared declared function) — every thread's work must
    land on its own scheduler and the stacks must never bleed across."""
    n_threads, chains, per = 4, 3, 4
    stage = gr.function(None, modes=("inout",), name="K", cost_s=1e-5)
    scheds, errs = {}, []
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        try:
            with gr.runtime(policy="parallel", simulate=True) as s:
                scheds[tid] = s
                barrier.wait()              # all runtimes active at once
                for c in range(chains):
                    x = gr.array(np.zeros(64, np.float32),
                                 name=f"t{tid}_x{c}")
                    for k in range(per):
                        e = stage.with_options(
                            name=f"t{tid}_k{c}_{k}",
                            tenant=f"tenant{tid}")(x)
                        assert e in s._elements
                barrier.wait()              # everyone still nested
                assert gr.get_runtime() is s
                s.sync()
            assert gr.current_runtime() is None
        except BaseException as exc:
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(tid,))
               for tid in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    for tid, s in scheds.items():
        assert len(kernels_in(s)) == chains * per
        assert set(s.tenant_stats()) == {f"tenant{tid}"}


# ----------------------------------------------------------------------
# Capture keyed by declared-function identity
# ----------------------------------------------------------------------

def _episode(s, f, x, y):
    with s.capture("ep"):
        f(x, y, scheduler=s)


def test_capture_replays_across_recreated_closures():
    """The declaration is the identity: re-wrapping the same GrFunction's
    underlying callable per episode (the serving pattern) keeps replaying
    one plan."""
    s = sim()
    f = gr.function(None, modes=("const", "out"), name="K", cost_s=1e-4)
    x = s.array(np.zeros(32, np.float32), name="x")
    for i in range(4):
        y = s.array(shape=(32,), dtype=np.float32, name=f"y{i}")
        _episode(s, f, x, y)
        s.sync()
    st = s.stats()
    assert st["plan_records"] >= 1
    assert st["plan_replays"] >= 2


def test_capture_distinguishes_equal_named_declarations():
    """Two declarations that collide on name/config/cost must not alias one
    plan — fn_key is part of the match."""
    s = sim()
    f1 = gr.function(None, modes=("const", "out"), name="K", cost_s=1e-4)
    f2 = gr.function(None, modes=("const", "out"), name="K", cost_s=1e-4)
    x = s.array(np.zeros(32, np.float32), name="x")
    y1 = s.array(shape=(32,), dtype=np.float32, name="y1")
    _episode(s, f1, x, y1)
    s.sync()
    records = s.stats()["plan_records"]
    y2 = s.array(shape=(32,), dtype=np.float32, name="y2")
    _episode(s, f2, x, y2)                  # same shapes, different identity
    s.sync()
    st = s.stats()
    assert st["plan_replays"] == 0
    assert st["plan_records"] > records     # re-recorded, not replayed


@pytest.mark.parametrize("simulate", [True, False])
def test_grfunction_capture_roundtrip_bit_identical(simulate):
    """GrFunction-driven episodes under capture: replayed episodes produce
    bit-identical results to the recorded run (sim + real executors)."""
    if simulate:
        s = sim()
        dbl = gr.function(None, modes=("const", "out"), name="DBL",
                          cost_s=1e-4)
    else:
        s = make_scheduler("parallel", device="cpu")
        dbl = gr.function(lambda a, _o: a * 2.0,
                          modes=("const", "out"), name="DBL")
    try:
        x = s.array(np.arange(64, dtype=np.float32), name="x")
        results = []
        for _ in range(4):
            y = s.array(shape=(64,), dtype=np.float32, name="y")
            with s.capture("bitident"):
                dbl(x, y, scheduler=s)
            results.append(np.asarray(y).copy())
        assert s.stats()["plan_replays"] >= 1
        if not simulate:
            for r in results[1:]:
                np.testing.assert_array_equal(results[0], r)
    finally:
        s.shutdown()


def test_spacesharing_runner_keeps_declared_identity_across_submits():
    """SpaceSharedRunner re-creates its kernel closure per submit (it binds
    the submit's fn/element) but must reuse one declared identity per
    (name, arity), or captured episodes could never replay."""
    from repro_torch.runtime.spacesharing import SpaceSharedRunner, SubmeshPool
    runner = SpaceSharedRunner(SubmeshPool(devices=["cpu"], n_lanes=1))
    try:
        f = lambda a: a + 1.0  # noqa: E731
        results = [runner.submit(f, [runner.sched.array(
            np.full(8, i, np.float32), name=f"in{i}")], name="task")
            for i in range(3)]
        vals = [np.asarray(r.get()) for r in results]
        for i, v in enumerate(vals):
            np.testing.assert_allclose(v, i + 1.0)
        keys = {e.fn_key for e in runner.sched._elements
                if e.kind is ElementKind.KERNEL}
        assert len(keys) == 1 and None not in keys
    finally:
        runner.sched.shutdown()


def test_capture_replays_out_of_range_device_pin():
    """A pin beyond num_devices clamps identically at record and match
    time — identical episodes must replay, not re-record per episode."""
    s = make_scheduler("parallel", simulate=True, num_devices=2)
    f = gr.function(None, modes=("const", "out"), name="K", cost_s=1e-4)
    x = s.array(np.zeros(32, np.float32), name="x")
    for i in range(4):
        y = s.array(shape=(32,), dtype=np.float32, name=f"y{i}")
        with s.capture("pinned"):
            e = f.with_options(device=7)(x, y, scheduler=s)
        assert e.device == 1                # clamped to the last device
        s.sync()
    st = s.stats()
    # 2 records is the usual warm-up (x flips to device-resident after the
    # first episode); before clamping ahead of capture matching this was 4
    # records / 0 replays — every episode re-recorded.
    assert st["plan_records"] == 2
    assert st["plan_replays"] == 2


# ----------------------------------------------------------------------
# The deprecated launch shim
# ----------------------------------------------------------------------

def test_launch_shim_still_works_and_warns():
    from repro_torch.core import const, out
    s = sim()
    x = s.array(np.zeros(16, np.float32))
    y = s.array(shape=(16,), dtype=np.float32)
    with pytest.warns(DeprecationWarning, match="repro.api.function"):
        e = s.launch(None, [const(x), out(y)], name="K", cost_s=1e-4)
    s.sync()
    assert e.kind is ElementKind.KERNEL
    assert e.fn_key is None                 # legacy launches carry no identity


# ----------------------------------------------------------------------
# ManagedArray host-write ownership regression (satellite bugfix)
# ----------------------------------------------------------------------

def test_write_on_never_transferred_array_keeps_location_bits():
    s = sim()
    x = s.array(np.zeros(16, np.float32), name="x")
    x.write(np.ones(16, np.float32))
    assert x.host_valid and not x.device_valid
    assert x.device_id is None              # nothing to go stale
    x[0] = 3.0
    assert x.host_valid and not x.device_valid and x.device_id is None


def test_write_after_d2d_clears_stale_ownership():
    """x migrates dev0 -> dev1 (D2D moves ownership), then the host writes
    it: no device owns a valid copy anymore, so device_id must clear —
    a stale id previously mis-keyed capture slot-state matching and the
    migrate stage's ownership claims."""
    s = make_scheduler("parallel", simulate=True, num_devices=2,
                       placement="round-robin")
    f = gr.function(None, modes=("inout",), name="K", cost_s=1e-4)
    x = s.array(np.zeros(32, np.float32), name="x")
    f.with_options(device=0)(x, scheduler=s)       # prefetch + run on dev0
    assert (x.device_valid, x.device_id) == (True, 0)
    f.with_options(device=1)(x, scheduler=s)       # D2D migrates to dev1
    assert (x.device_valid, x.device_id) == (True, 1)
    d2d_before = s.d2d_transfers
    assert d2d_before == 1
    s.sync()
    x.write(np.ones(32, np.float32))               # host overwrite
    assert x.host_valid and not x.device_valid
    assert x.device_id is None                     # regression: was stale 1
    # Re-running on dev0 must H2D-prefetch (fresh host data), not D2D the
    # dead device copy.
    f.with_options(device=0)(x, scheduler=s)
    s.sync()
    assert s.d2d_transfers == d2d_before
    assert (x.device_valid, x.device_id) == (True, 0)


def test_write_keeps_capture_slot_state_stable_across_episodes():
    """The trainer's write-then-launch pattern: after the fix, the re-written
    array presents the same slot state every episode, so one recorded plan
    keeps replaying instead of re-recording per episode."""
    s = sim()
    f = gr.function(None, modes=("const", "out"), name="STEP", cost_s=1e-4)
    x = s.array(np.zeros(32, np.float32), name="x")
    for i in range(4):
        x.write(np.full(32, float(i), np.float32))
        y = s.array(shape=(32,), dtype=np.float32, name=f"y{i}")
        with s.capture("step"):
            f(x, y, scheduler=s)
        s.sync()
    st = s.stats()
    # Without clearing device_id on write, episode 1 re-records (x presents
    # a stale device_id=0 the recorded slot never had).
    assert st["plan_records"] == 1
    assert st["plan_replays"] == 3
