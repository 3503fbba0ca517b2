"""Random DAG programs and memory scenarios for the core-runtime tests.

A program is a list of (template, array indices, cost) drawn from a seed;
the templates cover every access-mode pattern (const/out, inout,
const/const/out, const/inout, const/out/out).  ``drive`` issues a program
through either surface of a package's API, the declared ``GrFunction``s or
the legacy ``launch`` with per-call modes, so one helper serves ``repro``
and ``repro_torch`` alike.  ``capture_demotion`` and ``concurrent_stress``
are the memory manager's concurrency cases on a real scheduler, on CPU
lanes or on the card.  Imports neither JAX nor either package: the card's
tests and ``chip_smoke.py`` use it too.
"""
import threading
import warnings

import numpy as np

N = 64

MODES = {"copy2": ("const", "out"), "bump": ("inout",),
         "add": ("const", "const", "out"), "axpy": ("const", "inout"),
         "split": ("const", "out", "out")}

# Kernels on torch tensors; the same arithmetic on numpy arrays gives the
# expected values.
KERNELS = {
    "copy2": lambda a, _o: a * 2.0,
    "bump": lambda a: a + 1.0,
    "add": lambda a, b, _o: a + b,
    "axpy": lambda a, b: b + 0.5 * a,
    "split": lambda a, _o1, _o2: (a + 1.0, a - 1.0),
}

STAT_KEYS = ("elements", "edges", "d2d_transfers", "lanes_created",
             "events_created")


def random_program(seed: int, n_arrays: int = 6, n_kernels: int = 14):
    """A reproducible random DAG: (template, array indices, cost)."""
    rng = np.random.RandomState(seed)
    names = sorted(MODES)
    prog = []
    for _ in range(n_kernels):
        tname = names[rng.randint(len(names))]
        idxs = rng.choice(n_arrays, size=len(MODES[tname]), replace=False)
        cost = float(rng.choice([1e-5, 1e-4, 1e-3]))
        prog.append((tname, [int(j) for j in idxs], cost))
    return prog


def make_arrays(s, n_arrays: int = 6, n: int = N):
    """Array i holds the value i + 1 everywhere."""
    return [s.array(np.full(n, i + 1.0, np.float32), name=f"a{i}")
            for i in range(n_arrays)]


def drive(gr, s, prog, arrays, kernels=None, surface="frontend"):
    """Issues ``prog`` on scheduler ``s`` through ``gr`` (``repro.api`` or
    ``repro_torch.api``): declared functions, or the legacy ``launch``."""
    kernels = kernels or {t: (lambda *a: None) for t in MODES}
    if surface == "legacy":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            for i, (tname, idxs, cost) in enumerate(prog):
                args = [gr.Arg(arrays[j], gr.AccessMode(m))
                        for j, m in zip(idxs, MODES[tname])]
                s.launch(kernels[tname], args, name=f"k{i}_{tname}",
                         cost_s=cost)
        return
    fns = {t: gr.function(kernels[t], modes=MODES[t], name=t) for t in MODES}
    with gr.runtime(scheduler=s):
        for i, (tname, idxs, cost) in enumerate(prog):
            fns[tname].with_options(name=f"k{i}_{tname}", cost_s=cost)(
                *(arrays[j] for j in idxs))


def structure(s):
    """Order-preserving, uid-free view of every scheduled element."""
    return [(e.name, e.kind.value, e.stream, e.device,
             sorted(p.name for p in e.parents)) for e in s._elements]


def edges(s):
    """``structure`` without lanes and devices."""
    return [(e.name, e.kind.value, sorted(p.name for p in e.parents))
            for e in s._elements]


def timeline(s):
    return [(sp.name, sp.kind, sp.lane, sp.t0, sp.t1)
            for sp in s.timeline.spans]


def numpy_program(prog, n_arrays: int = 6, n: int = N, dtype=np.float32):
    """The values ``prog`` computes, on numpy arrays in program order."""
    vals = [np.full(n, i + 1.0, dtype) for i in range(n_arrays)]
    for tname, idxs, _ in prog:
        res = KERNELS[tname](*(vals[j] for j in idxs))
        res = res if isinstance(res, tuple) else (res,)
        writable = [j for j, m in zip(idxs, MODES[tname]) if m != "const"]
        for j, r in zip(writable, res):
            vals[j] = np.asarray(r, dtype)
    return vals


def simulated(gr, policy, prog, n: int = N):
    """``prog``'s elements (``structure``) and stats on the simulator with
    no launch overhead: its host clock stands still while the program is
    issued, so every lane and event is assigned with every element in
    flight."""
    s = gr.make_scheduler(policy, simulate=True, launch_overhead_s=0.0)
    # The simulator never touches values: a read-only view of one element
    # stands for each array, at its full size.
    arrays = [s.array(np.broadcast_to(np.float32(i + 1.0), (n,)),
                      name=f"a{i}") for i in range(6)]
    drive(gr, s, prog, arrays)
    struct = structure(s)
    s.sync()
    stats = {k: s.stats()[k] for k in STAT_KEYS}
    s.close()
    return struct, stats


def hold_lanes(s, policy):
    """Holds each lane of the real scheduler ``s`` before its first element
    until the returned event is set, so that the program is issued with
    every element in flight, as ``simulated`` issues it.  The serial
    policy waits for each element as it is issued, so nothing is held."""
    gate = threading.Event()
    if policy == "serial":
        gate.set()
    else:
        s.executor.pre_exec = lambda _e: gate.wait()
    return gate


def _stage_fn(x, o):
    return x * 2.0 + 1.0


def assert_conservation(sched, arrays):
    """resident_bytes per device == sum of nbytes of device-valid arrays."""
    for d in range(sched.num_devices):
        expect = sum(a.nbytes for a in arrays
                     if a.device_valid and (a.device_id or 0) == d)
        got = sched.memory.pools[d].resident_bytes
        assert got == expect, f"device {d}: tracked {got} != actual {expect}"


def capture_demotion(gr, s, n: int = 256):
    """A host write demotes a replay mid-episode on the real scheduler
    ``s``: the un-flushed plan suffix is dropped, the episode finishes
    eagerly, and at every step the location bits equal the tracked
    residency and, at each sync, the physically installed bytes."""
    stage = gr.function(_stage_fn, modes=("const", "out"), name="dm_stage",
                        outputs=0).with_options(scheduler=s, cost_s=1e-4)
    alive = []

    def episode(write_mid=False):
        with s.capture("demote_ep"):
            a = s.array(np.full(n, 1.0, np.float32), name="dm_a")
            b = stage(a)
            if write_mid:               # a is plan-bound: demotes the replay
                a.write(np.full(n, 10.0, np.float32))
            c = s.array(np.full(n, 2.0, np.float32), name="dm_c")
            d = stage(c)
            alive.extend([a, b, c, d])
            assert_conservation(s, alive)
        s.sync()
        assert_conservation(s, alive)
        assert s.memory.verify(physical=True).ok
        return a, b, c, d

    episode()                                 # record
    episode()                                 # replay
    assert s.stats()["plan_replays"] == 1
    a, b, c, d = episode(write_mid=True)      # demoted mid-replay
    assert np.array_equal(np.asarray(b), np.full(n, 3.0, np.float32))
    assert np.array_equal(np.asarray(d), np.full(n, 5.0, np.float32))
    assert np.array_equal(np.asarray(a), np.full(n, 10.0, np.float32))
    assert_conservation(s, alive)
    episode()                                 # the plan survives demotion
    assert s.stats()["plan_replays"] >= 2


def concurrent_stress(gr, s, n: int = 256, threads: int = 4,
                      per_thread: int = 12):
    """Submitter threads race a syncing thread on the real scheduler
    ``s``: the barrier covers work submitted during the unlocked drain,
    every element completes, the values are right and the ledgers equal
    the bytes installed.  Returns the arrays."""
    stage = gr.function(_stage_fn, modes=("const", "out"), name="st_stage",
                        outputs=0).with_options(scheduler=s, cost_s=1e-4)
    results, errors = {}, []
    start = threading.Barrier(threads + 1)

    def submitter(tid):
        try:
            start.wait()
            outs = []
            for i in range(per_thread):
                v = float(tid * 100 + i)
                x = s.array(np.full(n, v, np.float32), name=f"st{tid}_{i}")
                outs.append((v, x, stage(x)))
                if i % 4 == 3:
                    s.sync()
            results[tid] = outs
        except Exception as exc:              # pragma: no cover - fail path
            errors.append(exc)

    pool = [threading.Thread(target=submitter, args=(t,))
            for t in range(threads)]
    for t in pool:
        t.start()
    start.wait()
    for _ in range(6):
        s.sync()                              # racing barriers
    for t in pool:
        t.join()
    s.sync()
    assert not errors, errors
    assert not s.dag.frontier
    assert not s._elements
    for outs in results.values():
        for val, _x, arr in outs:
            assert np.array_equal(np.asarray(arr),
                                  np.full(n, 2.0 * val + 1.0, np.float32))
    arrays = [a for outs in results.values() for _, x, arr in outs
              for a in (x, arr)]
    assert_conservation(s, arrays)
    assert s.memory.verify(physical=True).ok
    return arrays
