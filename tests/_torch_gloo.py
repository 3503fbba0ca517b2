"""Runs a snippet on N gloo ranks, one subprocess each, joined by a
``FileStore``: the port's multi-rank code on the CPU.  The snippet sees
``RANK``, ``WORLD``, ``torch``, ``dist``, ``json`` and ``np`` and an
initialised default group; rank 0's last line of output is parsed as
JSON.

After the snippet every rank passes a barrier, destroys its process
groups, then drops every name the snippet bound and collects.  A
``DeviceMesh`` the snippet keeps holds its process group, and with it
gloo's worker and transport threads, past ``destroy_process_group``: left
alone they live into interpreter teardown, where a rank now and then
aborted (``terminate called without an active exception``) after printing
its results.  Released here, they are joined while the interpreter is
whole."""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """\
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD = int(os.environ["GLOO_RANK"]), int(os.environ["GLOO_WORLD"])
torch.set_num_threads(1)
dist.init_process_group("gloo", rank=RANK, world_size=WORLD,
                        store=dist.FileStore(os.environ["GLOO_STORE"], WORLD))
_PRELUDE_NAMES = set(globals()) | {"_PRELUDE_NAMES"}
"""
_CODA = """
dist.barrier()
dist.destroy_process_group()
for _name in set(globals()) - _PRELUDE_NAMES:
    del globals()[_name]
import gc
gc.collect()
"""


def run_gloo(code: str, world: int, timeout: float = 240) -> dict:
    prog = _PRELUDE + textwrap.dedent(code) + _CODA
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   GLOO_WORLD=str(world),
                   GLOO_STORE=os.path.join(tmp, "store"),
                   OMP_NUM_THREADS="1")
        procs = []
        for rank in range(world):
            out = open(os.path.join(tmp, f"out{rank}"), "w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", prog], stdout=out,
                stderr=subprocess.STDOUT,
                env=dict(env, GLOO_RANK=str(rank))), out))
        try:
            codes = [p.wait(timeout=timeout) for p, _ in procs]
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs = []
        for _, out in procs:
            out.seek(0)
            logs.append(out.read())
            out.close()
    assert codes == [0] * world, "\n".join(
        f"--- rank {r} (exit {c}) ---\n{log[-3000:]}"
        for r, (c, log) in enumerate(zip(codes, logs)) if c)
    return json.loads(logs[0].strip().splitlines()[-1])
