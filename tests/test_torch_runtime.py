"""TaskGraphTrainer, checkpointing and fault tolerance in the port: the
suite of ``tests/test_runtime.py`` on CPU lanes (``device="cpu"``), at its
sizes, plus checkpoints that cross between the two packages and the
``launch.train`` CLI interrupted and resumed.

Tolerances: the reference's own (losses rtol 1e-5 across schedulers and
across a restart, which on one machine are bit for bit); a run that
crosses frameworks compares losses at rtol 1e-3 (bf16 activations round
differently in the two frameworks, as in ``test_torch_train.py``)."""
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.models import init_lm as jinit
from repro.optim import AdamW as JAdamW
from repro.runtime import TaskGraphTrainer as JTrainer
from repro.runtime.steps import TrainState as JTrainState
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import GrScheduler, make_scheduler
from repro_torch.models import from_jax_params
from repro_torch.models.convert import to_jax_layout
from repro_torch.optim import AdamW
from repro_torch.runtime import TaskGraphTrainer, TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cfg():
    return get_config("qwen3_32b", reduced=True)


def test_trainer_runs_through_scheduler(cfg):
    tr = TaskGraphTrainer(cfg, seq_len=32, global_batch=4, accum=2,
                          device="cpu")
    try:
        rep = tr.run(6)
        assert rep.steps_run == 6
        assert rep.losses and all(np.isfinite(rep.losses))
        # the loop was actually scheduled: train_step kernels + host elements
        stats = tr.sched.stats()
        assert stats["elements"] >= 6
    finally:
        tr.sched.shutdown()


def test_trainer_deterministic_across_schedulers(cfg):
    """Parallel-async scheduling must not change training results."""
    def losses(policy):
        tr = TaskGraphTrainer(cfg, seq_len=32, global_batch=4, accum=1,
                              scheduler=GrScheduler(policy=policy,
                                                    device="cpu"),
                              device="cpu")
        try:
            return tr.run(5, metrics_every=1).losses
        finally:
            tr.sched.shutdown()

    np.testing.assert_allclose(losses("serial"), losses("parallel"),
                               rtol=1e-5)


def test_checkpoint_restart_exact_resume(cfg):
    """Crash at step 5, restore from step 4, finish: the loss trajectory
    after resume must equal an uninterrupted run (deterministic stream)."""
    with tempfile.TemporaryDirectory() as d:
        tr1 = TaskGraphTrainer(cfg, seq_len=32, global_batch=4, accum=1,
                               ckpt_dir=os.path.join(d, "a"), ckpt_every=2,
                               seed=7, device="cpu")
        try:
            ref = tr1.run(8, metrics_every=1).losses
        finally:
            tr1.sched.shutdown()

        tr2 = TaskGraphTrainer(cfg, seq_len=32, global_batch=4, accum=1,
                               ckpt_dir=os.path.join(d, "b"), ckpt_every=2,
                               seed=7, device="cpu")
        try:
            rep = tr2.run_with_restart(8, fail_at=5)
        finally:
            tr2.sched.shutdown()
        # steps 5..8 after restart-from-4 must match the reference tail
        np.testing.assert_allclose(rep.losses[-1], ref[-1], rtol=1e-5)
        assert rep.restarts == 2     # the restored run, and the restart


def test_checkpoint_manager_atomic_and_gc():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2, async_save=False)
        state = {"w": np.arange(8, dtype=np.float32),
                 "nested": {"b": np.ones((2, 2))}}
        for step in (1, 2, 3):
            state["w"] = state["w"] + 1
            mgr.save(step, state)
        assert mgr.latest_step() == 3
        restored = mgr.restore(like=state)
        np.testing.assert_array_equal(restored["w"], state["w"])
        # gc kept only the newest 2
        kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        assert kept == ["step_2", "step_3"]
        # no tmp dirs left behind
        assert not [x for x in os.listdir(d) if x.endswith(".tmp")]


def test_checkpoint_snapshot_is_a_copy_and_writer_errors_surface(tmp_path):
    """An async save writes the values of the moment it was called, not
    what the caller changes in place afterwards; a writer that fails
    raises at the next ``wait``."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.zeros(4)
    mgr.save(1, {"w": w})
    w += 5                                   # the next step, in place
    mgr.wait()
    got = mgr.restore(like={"w": w}, step=1)["w"]
    assert isinstance(got, torch.Tensor) and torch.equal(got, torch.zeros(4))
    mgr.save(2, {"x": np.ones(2)}, extra={"bad": object()})
    with pytest.raises(TypeError):
        mgr.wait()


def test_straggler_detection_in_sim():
    """A straggling kernel is detected via the scheduler's history (§IV-A)."""
    from repro_torch.core import const, out
    s = make_scheduler("parallel", simulate=True)
    for i in range(6):
        x = s.array(np.zeros(1024, np.float32), name=f"x{i}")
        y = s.array(np.zeros(1024, np.float32), name=f"y{i}")
        cost = 1e-3 if i < 5 else 50e-3     # last one straggles
        s.launch(None, [const(x), out(y)], name="step", cost_s=cost)
    s.sync()
    assert s.executor.history.stragglers_seen >= 1
    assert s.executor.history.is_straggler("step", {}, 50e-3)


def test_quantized_adamw_trains_like_the_reference(cfg):
    """q8 AdamW through the trainer, from the reference's initial weights:
    the port's losses equal the reference trainer's over two steps (the
    second loss follows the first q8 update), and the checkpoint holds the
    q8 moments under the reference's names.  Later steps are not held:
    blockwise absmax rounds the small second moments of a block to zero
    code, so a moment one code apart between the frameworks (the optimizer
    tests allow that) changes an update from m/sqrt(v) to m/eps; both
    trainers diverge within six steps at this learning rate, the
    reference's own from 5.56 to 31.0."""
    jcfg = jget_config("qwen3_32b", reduced=True)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    jt = JTrainer(jcfg, seq_len=32, global_batch=4,
                  optimizer=JAdamW(lr=1e-3, warmup=1, quantized=True))
    want = jt.run(2, metrics_every=1).losses
    jt.sched.shutdown()
    with tempfile.TemporaryDirectory() as d:
        tr = TaskGraphTrainer(cfg, seq_len=32, global_batch=4,
                              optimizer=AdamW(lr=1e-3, warmup=1,
                                              quantized=True),
                              ckpt_dir=d, ckpt_every=2, device="cpu")
        model = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                cfg, "cpu")
        try:
            rep = tr.run(2, state=TrainState(model, tr.optimizer.init(model)),
                         metrics_every=1)
        finally:
            tr.sched.shutdown()
        leaves = CheckpointManager(d)._manifest(2)[1]
    np.testing.assert_allclose(rep.losses, want, rtol=1e-3)
    assert leaves["opt/m/blocks/0/attn/wq/codes"]["dtype"] == "int8"
    assert leaves["opt/v/blocks/0/ln1/scale/scales"]["shape"] == [2, 1]
    assert leaves["opt/m/final_norm/scale"]["dtype"] == "float32"


# ----------------------------------------------------------------------
# checkpoints across the two packages
# ----------------------------------------------------------------------
def _ref_names_and_shapes(arch, quantized):
    jcfg = jget_config(arch, reduced=True)
    opt = JAdamW(quantized=quantized)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    state = JTrainState(params, opt.init(params))
    with tempfile.TemporaryDirectory() as d:
        mgr = JCheckpointManager(d, async_save=False)
        mgr.save(1, state)
        leaves = CheckpointManager(d)._manifest(1)[1]
    return {n: (e["dtype"], tuple(e["shape"])) for n, e in leaves.items()}


@pytest.mark.parametrize("arch,quantized", [
    ("qwen3_32b", False), ("qwen3_32b", True), ("gemma3_12b", False),
    ("qwen2_moe_a2_7b", True), ("rwkv6_1_6b", False)])
def test_train_state_layout_names_and_shapes_equal_reference(arch,
                                                             quantized):
    cfg = get_config(arch, reduced=True)
    from repro_torch.models import init_lm
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = TrainState(model, AdamW(quantized=quantized).init(model))
    got = {n: (str(a.dtype), tuple(a.shape))
           for n, a in to_jax_layout(state).items()}
    assert got == _ref_names_and_shapes(arch, quantized)


def _ref_trainer(cfg, d, **kw):
    return JTrainer(cfg, seq_len=32, global_batch=4, ckpt_dir=d,
                    ckpt_every=2, **kw)


def test_reference_checkpoint_restores_in_the_port():
    """The reference trains 2 steps and checkpoints; the port restores the
    checkpoint and continues to the reference's losses of steps 3 and 4."""
    jcfg = jget_config("qwen3_32b", reduced=True)
    cfg = get_config("qwen3_32b", reduced=True)
    with tempfile.TemporaryDirectory() as d:
        ref = _ref_trainer(jcfg, os.path.join(d, "ref"))
        want = ref.run(4, metrics_every=1).losses
        ref.sched.shutdown()
        jt = _ref_trainer(jcfg, os.path.join(d, "x"))
        jt.run(2, metrics_every=1)
        jt.sched.shutdown()
        tr = TaskGraphTrainer(cfg, seq_len=32, global_batch=4,
                              ckpt_dir=os.path.join(d, "x"), ckpt_every=2,
                              device="cpu")
        try:
            rep = tr.run(4, metrics_every=1)
        finally:
            tr.sched.shutdown()
    assert rep.restarts == 1 and rep.steps_run == 2
    np.testing.assert_allclose(rep.losses, want[2:], rtol=1e-3)


def test_port_checkpoint_restores_in_the_reference():
    """The port trains 2 steps from the reference's initial weights and
    checkpoints; the reference restores the checkpoint and continues to
    its own uninterrupted losses of steps 3 and 4."""
    jcfg = jget_config("qwen3_32b", reduced=True)
    cfg = get_config("qwen3_32b", reduced=True)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    with tempfile.TemporaryDirectory() as d:
        ref = _ref_trainer(jcfg, os.path.join(d, "ref"))
        want = ref.run(4, metrics_every=1).losses
        ref.sched.shutdown()
        tr = TaskGraphTrainer(cfg, seq_len=32, global_batch=4,
                              ckpt_dir=os.path.join(d, "x"), ckpt_every=2,
                              device="cpu")
        model = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                cfg, "cpu")
        try:
            first = tr.run(2, state=TrainState(model,
                                               tr.optimizer.init(model)),
                           metrics_every=1).losses
        finally:
            tr.sched.shutdown()
        jt = _ref_trainer(jcfg, os.path.join(d, "x"))
        got = jt.run(4, metrics_every=1)
        jt.sched.shutdown()
    np.testing.assert_allclose(first, want[:2], rtol=1e-3)
    assert got.restarts == 1 and got.steps_run == 2
    np.testing.assert_allclose(got.losses, want[2:], rtol=1e-3)


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def _train_cli(ckpt, steps):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3_32b", "--reduced", "--device", "cpu", "--steps", str(steps),
         "--ckpt", ckpt, "--ckpt-every", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout.splitlines()


def test_train_cli_resumes_digit_for_digit(tmp_path):
    """12 steps uninterrupted; then 6 steps (the interruption, with a
    checkpoint at 4) and 12 again (the resume from step 4): every
    ``step N:`` line of the resumed run equals the uninterrupted one."""
    full = _train_cli(str(tmp_path / "a"), 12)
    cut = _train_cli(str(tmp_path / "b"), 6)
    resumed = _train_cli(str(tmp_path / "b"), 12)

    def steps(lines):
        return {ln.split(":")[0]: ln for ln in lines if ln.startswith("step ")}
    assert list(steps(full)) == ["step 5", "step 10", "step 12"]
    assert "resumed from step 4" in resumed
    assert steps(resumed) == steps(full)
    assert steps(cut)["step 5"] == steps(full)["step 5"]
