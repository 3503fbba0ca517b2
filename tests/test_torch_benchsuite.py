"""The benchsuite port (``repro_torch.benchsuite``) against ``repro.benchsuite``.

Each kernel function against the JAX one on the same seeded inputs; each
workload under both policies on CPU lanes against the JAX reference and the
port's own ``run_reference``; the simulator's schedules bit for bit; the
executor's rule for ``out`` arguments; the out-of-core scenario through real
spills.  The port runs on ``device="cpu"`` here; ``test_torch_benchsuite_cuda.py``
holds the cases that need the card.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.benchsuite as J
import repro.benchsuite.kernels as JK
import repro_torch.benchsuite as T
import repro_torch.benchsuite.kernels as TK
import repro_torch.core.executor as texec
from repro.benchsuite.costmodel import sim_hardware as j_sim_hardware
from repro.core import make_scheduler as j_make_scheduler
from repro_torch.benchsuite.costmodel import sim_hardware as t_sim_hardware
from repro_torch.core import function, make_scheduler

TINY = 2e-5                     # as tests/test_benchsuite.py
NAMES = sorted(T.BENCHMARKS)
# float32 kernels: the same operations, summed in another order.
F32 = dict(rtol=2e-5, atol=2e-6)

DECLARED = ["SQUARE", "REDUCE_DIFF", "BLACK_SCHOLES", "BLUR_S", "BLUR_M",
            "BLUR_L", "SOBEL", "EXTEND_MASK", "UNSHARPEN", "COMBINE",
            "COMBINE_LOW", "NB_SCORES", "RIDGE_SCORES", "SOFTMAX_NORM",
            "ENSEMBLE_AVG", "SPMV", "L2_NORM", "DIVIDE", "CONV_RELU_POOL",
            "DENSE_EMBED", "CONCAT_DENSE"]


def _kernel_args(name: str, rng) -> list:
    """Seeded numpy arguments for one declared kernel, output placeholders
    included (zeros of the output's shape)."""
    def f32(*shape):
        return rng.rand(*shape).astype(np.float32)

    def zeros(*shape, dtype=np.float32):
        return np.zeros(shape, dtype)
    img = (37, 41)
    if name == "SQUARE":
        return [f32(257), zeros(257)]
    if name == "REDUCE_DIFF":
        return [f32(257), f32(257), zeros(1)]
    if name == "BLACK_SCHOLES":
        return [rng.rand(257) * 100 + 20, zeros(257, dtype=np.float64)]
    if name in ("BLUR_S", "BLUR_M", "BLUR_L", "SOBEL", "EXTEND_MASK"):
        return [f32(*img), zeros(*img)]
    if name == "UNSHARPEN":
        return [f32(*img), f32(*img), zeros(*img)]
    if name in ("COMBINE", "COMBINE_LOW"):
        return [f32(*img), f32(*img), f32(*img), zeros(*img)]
    if name in ("NB_SCORES", "RIDGE_SCORES"):
        return [f32(300, 20), (rng.randn(10, 20) * 0.1).astype(np.float32),
                (rng.randn(10) * 0.1).astype(np.float32), zeros(300, 10)]
    if name == "SOFTMAX_NORM":
        return [rng.randn(300, 10).astype(np.float32), zeros(300, 10)]
    if name == "ENSEMBLE_AVG":
        return [f32(300, 10), f32(300, 10), zeros(300, dtype=np.int32)]
    if name == "SPMV":
        n, nnz = 50, 400
        rows = np.sort(rng.randint(0, n, nnz)).astype(np.int32)
        cols = rng.randint(0, n, nnz).astype(np.int32)
        return [f32(nnz), cols, rows, f32(n), zeros(n)]
    if name == "L2_NORM":
        return [f32(257), zeros(1)]
    if name == "DIVIDE":
        return [f32(257), f32(1) + 0.5, zeros(257)]
    if name == "CONV_RELU_POOL":
        return [f32(2, 3, 17, 15), (rng.randn(5, 3, 3, 3) * 0.2).astype(
            np.float32), zeros(2, 5, 8, 7)]
    if name == "DENSE_EMBED":
        return [f32(2, 4, 5, 5), (rng.randn(100, 8) * 0.1).astype(np.float32),
                zeros(2, 8)]
    if name == "CONCAT_DENSE":
        return [f32(3, 8), f32(3, 8), rng.randn(16, 1).astype(np.float32),
                zeros(3, 1)]
    raise KeyError(name)


def test_every_kernel_function_is_declared_and_covered():
    fns = {getattr(TK, d).fn for d in DECLARED}
    names = {f.func.__name__ if isinstance(f, functools.partial)
             else f.__name__ for f in fns}
    assert len(names) == 19
    assert names == {n for n in dir(TK) if n.startswith("k_")}


@pytest.mark.parametrize("decl", DECLARED)
def test_declaration_matches_the_reference(decl):
    jg, tg = getattr(JK, decl), getattr(TK, decl)
    assert tg.name == jg.name
    assert [m.value for m in tg.modes] == [m.value for m in jg.modes]
    assert tg.outputs == jg.outputs
    assert tg.lint_shapes == jg.lint_shapes
    if isinstance(jg.fn, functools.partial):
        assert tg.fn.keywords == jg.fn.keywords
        assert tg.fn.func.__name__ == jg.fn.func.__name__
    else:
        assert tg.fn.__name__ == jg.fn.__name__


@pytest.mark.parametrize("decl", DECLARED)
def test_kernel_matches_jax(decl):
    args = _kernel_args(decl, np.random.RandomState(DECLARED.index(decl)))
    want = np.asarray(getattr(JK, decl).fn(*map(jnp.asarray, args)))
    got = getattr(TK, decl).fn(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    if decl == "BLACK_SCHOLES":
        # the port computes in float64 as declared; JAX without x64 in
        # float32 (prices up to about 80: float32 tolerance)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        s = args[0]
        want64 = T.BS().closed_form({f"s{i}": s for i in range(10)},
                                    iters=1)["c0"]
        np.testing.assert_allclose(got, want64, rtol=1e-12, atol=1e-12)
    elif decl == "ENSEMBLE_AVG":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, **F32)


def test_conv_refuses_a_stride_other_than_one():
    x, w = torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 3, 3)
    with pytest.raises(ValueError, match="stride"):
        TK.k_conv_relu_pool(x, w, None, stride=2)


@functools.lru_cache(maxsize=None)
def _tiny(name):
    data = T.BENCHMARKS[name].make_data(TINY)
    return data, J.BENCHMARKS[name].run_reference(data, iters=2)


def test_make_data_is_the_references_bit_for_bit():
    for name in NAMES:
        for scale in (TINY, 1e-3):
            a = T.BENCHMARKS[name].make_data(scale, seed=3)
            b = J.BENCHMARKS[name].make_data(scale, seed=3)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            assert (T.BENCHMARKS[name].footprint_bytes(scale)
                    == J.BENCHMARKS[name].footprint_bytes(scale))
            assert (T.BENCHMARKS[name].sizes(scale)
                    == J.BENCHMARKS[name].sizes(scale))


@pytest.mark.parametrize("policy", ["serial", "parallel"])
@pytest.mark.parametrize("name", NAMES)
def test_workload_on_cpu_lanes_matches_jax_and_own_reference(name, policy):
    b = T.BENCHMARKS[name]
    data, jax_ref = _tiny(name)
    s = make_scheduler(policy, device="cpu")
    try:
        got = b.build(s, data, gpu=None, iters=2)
        if policy == "parallel":
            assert s.stats()["lanes_created"] >= 2
    finally:
        s.shutdown()
    own = b.run_reference(data, iters=2, device="cpu")
    assert got.keys() == jax_ref.keys() == own.keys()
    for k in got:
        np.testing.assert_allclose(got[k], jax_ref[k], rtol=2e-3, atol=1e-4,
                                   err_msg=f"{name}:{k} vs JAX")
        np.testing.assert_allclose(got[k], own[k], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name}:{k} vs run_reference")


def test_closed_forms_hold_vec_and_bs():
    vec, bs = T.BENCHMARKS["VEC"], T.BENCHMARKS["B&S"]
    data = vec.make_data(TINY)
    own = vec.run_reference(data, iters=3, device="cpu")["z"]
    exact = vec.closed_form(data, iters=3)["z"]
    scale = np.sum(np.abs(data["x1"].astype(np.float64) ** 2
                          - data["x2"].astype(np.float64) ** 2))
    assert np.all(np.abs(own - exact) <= 1e-6 * scale)
    data = bs.make_data(TINY)
    own = bs.run_reference(data, iters=3, device="cpu")
    exact = bs.closed_form(data, iters=3)
    for k in exact:
        assert own[k].dtype == np.float64
        np.testing.assert_allclose(own[k], exact[k], rtol=1e-12, atol=1e-12)


def test_run_reference_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = T.BENCHMARKS["VEC"].make_data(TINY)
    with pytest.raises(RuntimeError, match="cuda"):
        T.BENCHMARKS["VEC"].run_reference(data)


def _sim(pkg_make, hw_for, bench, gpu, mode, data):
    policy = "serial" if mode == "serial" else "parallel"
    s = pkg_make(policy, simulate=True, hw=hw_for(gpu, policy),
                 oracle=mode == "oracle")
    bench.build(s, data, gpu=gpu, iters=4)
    spans = [(sp.name, sp.kind, sp.lane, sp.t0, sp.t1)
             for sp in s.timeline.spans]
    return s.timeline.makespan, s.stats()["lanes_created"], spans


@functools.lru_cache(maxsize=None)
def _sim_data(name):
    return T.BENCHMARKS[name].make_data(0.02)


@pytest.mark.parametrize("mode", ["serial", "parallel", "oracle"])
@pytest.mark.parametrize("gpu", sorted(T.GPUS))
@pytest.mark.parametrize("name", NAMES)
def test_simulator_schedule_is_the_references(name, gpu, mode):
    data = _sim_data(name)
    want = _sim(j_make_scheduler, j_sim_hardware, J.BENCHMARKS[name],
                J.GPUS[gpu], mode, data)
    got = _sim(make_scheduler, t_sim_hardware, T.BENCHMARKS[name],
               T.GPUS[gpu], mode, data)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]


def test_out_argument_gets_a_fresh_tensor_and_is_never_uploaded(monkeypatch):
    uploaded = []
    real = texec._to_device

    def spy(x, dev, *begin):
        uploaded.append(x)
        return real(x, dev, *begin)
    monkeypatch.setattr(texec, "_to_device", spy)
    seen = []

    def kernel(a, o, io):
        seen.append((o, io.clone()))
        return a + 1, io * 2

    k = function(kernel, modes=("const", "out", "inout"), name="k")
    s = make_scheduler("parallel", device="cpu")
    try:
        a = s.array(np.arange(6, dtype=np.int32).reshape(2, 3), name="a")
        o = s.array(shape=(2, 3), dtype=np.int32, name="o")
        io = s.array(np.full(4, 3.0), name="io")                 # float64
        # a host read below replaces each mirror with the device copy
        o_host, io_host = o.host, io.host
        k.with_options(scheduler=s)(a, o, io)
        np.testing.assert_array_equal(np.asarray(o), [[1, 2, 3], [4, 5, 6]])
        np.testing.assert_array_equal(np.asarray(io), np.full(4, 6.0))
        # a second call: ``o`` is now on the device and passes as it is
        k.with_options(scheduler=s)(a, o, io)
        s.sync()
    finally:
        s.shutdown()
    first_o, first_io = seen[0]
    assert first_o.shape == (2, 3) and first_o.dtype == torch.int32
    # on the CPU an upload would alias the host buffer
    assert first_o.data_ptr() != o_host.ctypes.data
    torch.testing.assert_close(first_io, torch.full((4,), 3.0,
                                                    dtype=torch.float64))
    torch.testing.assert_close(seen[1][1], torch.full((4,), 6.0,
                                                      dtype=torch.float64))
    assert all(x is not o_host for x in uploaded)  # the out buffer: never
    assert any(x is io_host for x in uploaded)     # the inout one: uploaded


def test_outofcore_spills_and_verifies_on_cpu_lanes():
    n = 1 << 10
    budget = T.working_set_bytes(6, n) // 2
    s = make_scheduler("parallel", device="cpu", memory_budget=budget)
    try:
        arrays = T.build_outofcore(s, chunks=6, n=n)
        assert T.verify_outofcore(arrays)
        s.sync()
        assert s.stats()["mem_spills"] >= 1
        evicted = [a for a in arrays["x"] + arrays["y"] if not a.device_valid]
        assert evicted and all(a.device is None for a in evicted)
    finally:
        s.shutdown()
