"""The port stands alone: ``repro_torch``, ``chip_smoke.py``, the port's
examples (``examples/torch_*.py``) and scripts (``scripts/torch_*.py``)
import neither JAX nor the JAX package, and no entry point quietly runs on
the CPU when it was not asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
# Modules of the daemon, MoE, training, model-family and multi-device
# slices, named so that a missing one fails.
NEW_MODULES = tuple(f"repro_torch.daemon.{m}" for m in (
    "cli", "client", "jobs", "lifecycle", "monitor", "policy", "server",
    "store", "wire", "__main__")) + ("repro_torch.models.moe",) + tuple(
    f"repro_torch.{m}" for m in (
        "optim", "optim.adamw", "data", "data.pipeline", "checkpoint",
        "checkpoint.manager", "runtime.trainer", "launch", "launch.train",
        "models.mamba", "launch.serve", "launch.mesh", "sharding",
        "sharding.context", "sharding.rules", "optim.compress",
        "runtime.spacesharing", "runtime.pipeline", "launch.specs",
        "launch.dryrun", "launch.hlostats"))


def _port_sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py"))
            + sorted((ROOT / "scripts").glob("torch_*.py")))


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        f"    {FORBIDDEN!r})\n"
        "print(len(names), bad)\n"
        "assert len(names) >= 25, names\n"
        f"missing = set({NEW_MODULES!r}) - set(names)\n"
        "assert not missing, missing\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_has_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), \
            f"{path}:{node.lineno} imports {roots}"


def _tiny_cpu_model():
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    cfg = get_config("qwen3_32b", reduced=True)
    return cfg, init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch.core import GrScheduler, make_scheduler
    from repro_torch.daemon import DaemonServer
    from repro_torch.models import from_jax_params, init_lm
    from repro_torch.runtime import ServingEngine, TaskGraphTrainer

    cfg, model = _tiny_cpu_model()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_scheduler()
    with pytest.raises(RuntimeError, match="cuda"):
        GrScheduler()
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, model)
    with pytest.raises(RuntimeError, match="cuda"):
        init_lm(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        from_jax_params({"embed": np.zeros((1, 1), np.float32)}, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        DaemonServer(os.path.join(str(tmp_path), "d.sock"))
    with pytest.raises(RuntimeError, match="cuda"):
        TaskGraphTrainer(cfg)
    from repro_torch.launch import dryrun, serve, train
    with pytest.raises(SystemExit, match="cuda"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(SystemExit, match="cuda"):
        dryrun.main(["--arch", "qwen3_32b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="cuda"):
        serve.main(["--reduced"])
    # The simulator needs no device; the CPU is there when asked for.
    make_scheduler(simulate=True).close()
    make_scheduler(device="cpu").close()
    ServingEngine(cfg, model, device="cpu").close()
    TaskGraphTrainer(cfg, device="cpu").sched.shutdown()


def test_port_raises_for_what_it_has_not_ported():
    """``sanitize=True`` and ``verify()`` raised until the analysis passes
    were ported; now they run on the simulator, and no stub in the port
    still names the analysis slice."""
    from repro_torch.core import make_scheduler
    s = make_scheduler(simulate=True, sanitize=True)
    assert s.sanitizer is not None
    assert s.executor.pre_exec == s.sanitizer.pre_exec
    a = s.array(np.ones(8, np.float32))
    s.launch(None, [], name="noop", cost_s=1e-6)
    del a
    s.sync()
    s.verify()
    assert s.stats()["sanitizer_races_detected"] == 0
    s.close()
    stubs = [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
             if "the analysis slice" in p.read_text()]
    assert not stubs, stubs
