"""The analysis passes and bf16 managed arrays on CUDA-stream lanes.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package (bf16 host
arrays need ``ml_dtypes``, which comes without JAX), so it runs where only
PyTorch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_analysis_cuda.py
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.analysis import SanitizerError
from repro_torch.analysis.sanitizer import digest
from repro_torch.benchsuite import BENCHMARKS
from repro_torch.core import function, make_scheduler, out
from repro_torch.core.element import ComputationalElement

SCALE = 1e-3
NAMES = sorted(BENCHMARKS)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lanes are CUDA streams")
    return torch.device("cuda")


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


@pytest.mark.cuda
def test_canary_catches_an_inplace_const_write_on_the_card(card):
    s = make_scheduler("parallel", device="cuda", sanitize=True)
    try:
        x = s.array(np.ones(1 << 20, np.float32), name="cx")
        y = s.array(shape=(1 << 20,), dtype=np.float32, name="cy")

        def mutates(a, _o):
            a.add_(1.0)
            return a * 2.0

        function(mutates, modes=("const", "out"), name="bad_mutates",
                 scheduler=s)(x, y)
        with pytest.raises(SanitizerError, match="write through const"):
            s.sync()
    finally:
        s.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "bool",
                                   "bfloat16 bits", "uint8 odd"])
def test_canary_digest_agrees_between_host_and_device(card, dtype):
    rng = np.random.RandomState(0)
    if dtype == "bfloat16 bits":
        host = rng.randint(0, 1 << 16, size=(37, 11)).astype(np.uint16)
        dev = torch.from_numpy(host.view(np.int16)).to(card).view(
            torch.bfloat16)
    elif dtype == "uint8 odd":
        host = rng.randint(0, 256, size=1001).astype(np.uint8)
        dev = torch.from_numpy(host).to(card)
    elif dtype == "bool":
        host = rng.rand(333) > 0.5
        dev = torch.from_numpy(host).to(card)
    else:
        host = (rng.randn(3, 1 << 12) * 100).astype(dtype)
        dev = torch.from_numpy(host).to(card)
    assert digest(host) == digest(dev)
    other = dev.clone()
    other.view(-1)[7:8].copy_(other.view(-1)[8:9] if dtype != "bool"
                              else ~other.view(-1)[7:8])
    if not torch.equal(other.reshape(-1).view(torch.uint8),
                       dev.reshape(-1).view(torch.uint8)):
        assert digest(other) != digest(dev)


@pytest.mark.cuda
def test_bf16_round_trip_on_cuda_lanes(card):
    import ml_dtypes
    n = 4099
    bits = np.random.RandomState(1).randint(
        0, 1 << 15, size=n).astype(np.uint16)       # finite, positive
    s = make_scheduler("parallel", device="cuda")
    try:
        x = s.array(bits.view(ml_dtypes.bfloat16), name="bx")
        y = s.array(shape=(n,), dtype=ml_dtypes.bfloat16, name="by")
        seen = {}

        def k(a, _o):
            seen["in"] = a.view(torch.int16).cpu().numpy().view(np.uint16)
            r = (a * 2).to(torch.bfloat16)
            seen["out"] = r.view(torch.int16).cpu().numpy().view(np.uint16)
            return r

        function(k, modes=("const", "out"), name="dbl", scheduler=s)(x, y)
        got = _bits(y)
        assert np.asarray(y).dtype == ml_dtypes.bfloat16
        assert np.array_equal(seen["in"], bits)        # upload kept the bits
        assert np.array_equal(got, seen["out"])        # host read the bits
        function(lambda a: a.clone(), modes=("inout",), name="touch",
                 scheduler=s)(x)
        assert np.array_equal(_bits(x), bits)          # back off the card
    finally:
        s.shutdown()


@pytest.mark.cuda
def test_waw_race_between_two_cuda_lanes_raises(card):
    s = make_scheduler("parallel", device="cuda", sanitize=True)
    try:
        a = s.array(np.ones(1024, np.float32), name="ra")
        started = threading.Event()

        def slow(_o):
            started.set()
            torch.cuda._sleep(200_000_000)
            return torch.zeros(1024, device="cuda")

        e1 = ComputationalElement(fn=slow, args=(out(a),), name="W1")
        e2 = ComputationalElement(fn=lambda _o: torch.ones(1024,
                                                           device="cuda"),
                                  args=(out(a),), name="W2")
        s.executor.submit(e1, 0, ())
        assert started.wait(30.0)
        s.executor.submit(e2, 1, ())
        with pytest.raises(SanitizerError, match="WAW"):
            s.executor.wait(e2)
        s.executor.wait(e1)
    finally:
        s.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_sanitized_workload_equals_unsanitized_on_cuda_lanes(card, name):
    b = BENCHMARKS[name]
    data = b.make_data(SCALE)

    def run(sanitize):
        s = make_scheduler("parallel", device="cuda", sanitize=sanitize)
        try:
            res = b.build(s, data, gpu=None, iters=2)
            return res, s.stats()
        finally:
            s.shutdown()
    (plain, _), (sane, st) = run(False), run(True)
    assert st["sanitizer_races_detected"] == 0
    assert st["sanitizer_elements_checked"] > 0
    for k in plain:
        np.testing.assert_allclose(sane[k], plain[k], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_plans_verify_on_cuda_lanes(card):
    b = BENCHMARKS["VEC"]
    data = b.make_data(SCALE)
    s = make_scheduler("parallel", device="cuda", sanitize=True,
                       plan_optimize=True)
    try:
        for _ in range(2):
            with s.capture("VEC"):
                b.build(s, data, gpu=None, iters=1)
            s.sync()
        s.verify()
        st = s.stats()
        assert st["plan_replays"] == 1 and st["sanitizer_races_detected"] == 0
    finally:
        s.shutdown()
