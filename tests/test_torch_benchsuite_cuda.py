"""The benchsuite and the executor's data path on CUDA-stream lanes.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_benchsuite_cuda.py
"""
import time

import numpy as np
import pytest
import torch

import repro_torch.core.executor as texec
from repro_torch.benchsuite import BENCHMARKS
from repro_torch.core import function, make_scheduler

# Small sizes: a few thousand to a few hundred thousand elements a workload.
SCALE = 1e-3
NAMES = sorted(BENCHMARKS)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lanes are CUDA streams")
    return torch.device("cuda")


@pytest.mark.cuda
def test_upload_is_staged_through_pinned_memory_and_asynchronous(card):
    x = np.random.RandomState(0).rand(1 << 24).astype(np.float32)  # 64 MiB
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(1_000_000_000)      # about half a second busy
        t0 = time.perf_counter()
        y = texec._to_device(x, card)
        issued_s = time.perf_counter() - t0
        pending = not side.query()
    # The call returned while the copy still waited behind the sleep on
    # the lane's stream: from pageable memory it would have blocked.
    assert pending, f"the upload finished before its call returned " \
                    f"({issued_s:.3f} s)"
    side.synchronize()
    assert y.is_cuda and y.dtype == torch.float32
    assert torch.equal(y.cpu(), torch.from_numpy(x))


@pytest.mark.cuda
def test_out_argument_is_never_uploaded_on_the_card(card, monkeypatch):
    uploaded = []
    real = texec._to_device

    def spy(x, dev, *begin):
        uploaded.append(x)
        return real(x, dev, *begin)
    monkeypatch.setattr(texec, "_to_device", spy)
    seen = []

    def kernel(a, o, io):
        seen.append((o.device.type, o.shape, o.dtype))
        return a * 2, io + 1

    k = function(kernel, modes=("const", "out", "inout"), name="k")
    s = make_scheduler("parallel", device="cuda")
    try:
        a = s.array(np.arange(1000, dtype=np.float64), name="a")
        o = s.array(shape=(1000,), dtype=np.float64, name="o")
        io = s.array(np.zeros(7, np.int32), name="io")
        # a host read below replaces each mirror with the device copy
        o_host, io_host = o.host, io.host
        k.with_options(scheduler=s)(a, o, io)
        np.testing.assert_array_equal(np.asarray(o), np.arange(1000) * 2.0)
        np.testing.assert_array_equal(np.asarray(io), np.ones(7, np.int32))
    finally:
        s.shutdown()
    assert seen == [("cuda", (1000,), torch.float64)]
    assert all(x is not o_host for x in uploaded)
    assert any(x is io_host for x in uploaded)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_workload_serial_equals_parallel_on_cuda_lanes(card, name):
    b = BENCHMARKS[name]
    data = b.make_data(SCALE)

    def run(policy):
        s = make_scheduler(policy, device="cuda")
        try:
            out = b.build(s, data, gpu=None, iters=2)
            return out, s.stats()["lanes_created"]
        finally:
            s.shutdown()
    (ser, _), (par, lanes) = run("serial"), run("parallel")
    ref = b.run_reference(data, iters=2, device="cuda")
    assert lanes >= 2
    for k in ref:
        # HITS sums by atomics on the card: the last bits may differ
        np.testing.assert_allclose(par[k], ser[k], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(par[k], ref[k], rtol=1e-5, atol=1e-6)
    if name == "VEC":
        exact = b.closed_form(data, iters=2)["z"]
        scale = np.sum(np.abs(data["x1"].astype(np.float64) ** 2
                              - data["x2"].astype(np.float64) ** 2))
        assert np.all(np.abs(par["z"] - exact) <= 1e-6 * scale)
    if name == "B&S":
        exact = b.closed_form(data, iters=2)
        for k in exact:
            np.testing.assert_allclose(par[k], exact[k], rtol=1e-12,
                                       atol=1e-12)
