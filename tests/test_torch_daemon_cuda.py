"""The port's daemon on the card: one socket round trip with a chain job and
a reduced ``serve_lm`` job, each equal to the same work run in-process.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_daemon_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import make_scheduler
from repro_torch.daemon import DaemonClient, DaemonServer
from repro_torch.daemon.jobs import run_job
from repro_torch.models import init_lm
from repro_torch.runtime.serving import ServingEngine


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the daemon's lanes are CUDA streams")
    return torch.device("cuda")


@pytest.mark.cuda
def test_daemon_on_the_card_round_trip(card, tmp_path):
    chain = {"n": 4, "size": 1 << 20, "seed": 7}
    lm = {"requests": 3, "prompt_len": 16, "new_tokens": 4, "seed": 3}
    with make_scheduler("parallel", device="cuda") as s:
        want_chain = run_job(s, "chain", chain)
    srv = DaemonServer(os.path.join(str(tmp_path), "d.sock"),
                       store_path=os.path.join(str(tmp_path), "jobs.jsonl"),
                       sched_kw={"device": "cuda"}, workers=2).start()
    try:
        assert srv.scheduler.executor.device.type == "cuda"
        with DaemonClient(srv.socket_path) as c:
            ids = [c.submit("chain", chain)["job_id"],
                   c.submit("serve_lm", lm)["job_id"]]
            got_chain, got_lm = (c.result(j, timeout=300) for j in ids)
    finally:
        srv.stop()
    assert got_chain == want_chain           # bit for bit, digest included
    assert "sha256" in got_chain

    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    model = init_lm(cfg, torch.Generator("cuda").manual_seed(3), "cuda")
    rng = np.random.RandomState(3)
    with ServingEngine(cfg, model, batch_size=2, max_new_tokens=4,
                       device="cuda", use_flash=False) as eng:
        reqs = [eng.submit(rng.randint(0, cfg.vocab, 16)) for _ in range(3)]
        eng.drain()
    assert got_lm["generations"] == [[int(t) for t in r.result]
                                     for r in reqs]
