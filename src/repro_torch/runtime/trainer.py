"""TaskGraphTrainer — the paper's runtime scheduler as a first-class
feature of the training loop: the port of ``repro.runtime.trainer``.

Every training step is issued as plain sequential host code; the scheduler
infers the dependency structure and overlaps:

* ``load_batch``  (host)      — synthetic pipeline / disk reads;
* ``h2d``         (transfer)  — auto-prefetch of the next batch, overlapped
                                 with the current step's compute (the
                                 paper's CT/TC overlap at step granularity);
* ``train_step``  (kernel)    — the device step on a lane's CUDA stream
                                 (RAW on state, WAR on the double-buffered
                                 batch slots);
* ``metrics``     (host read) — syncs only the lane owning the metrics;
* ``checkpoint``  (host)      — async snapshot off the critical path.

Fault tolerance: checkpoint/restart (exact resume via the deterministic
data stream), failure injection, straggler detection via the scheduler's
kernel history (§IV-A put to work).
"""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..checkpoint import CheckpointManager
from ..core import GrScheduler
from ..core.frontend import function
from ..core.managed import ManagedValue
from ..data import SyntheticTokenStream
from ..models.config import ArchConfig
from ..optim import AdamW
from .steps import TrainState, make_train_step


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class TrainerReport:
    steps_run: int = 0
    losses: List[float] = field(default_factory=list)
    restarts: int = 0
    stragglers: int = 0
    wall_time_s: float = 0.0


class TaskGraphTrainer:
    def __init__(self, cfg: ArchConfig, *, seq_len: int = 128,
                 global_batch: int = 8, accum: int = 1,
                 optimizer: Optional[AdamW] = None,
                 scheduler: Optional[GrScheduler] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
                 use_flash: bool = False, remat: bool = True,
                 seed: int = 0,
                 straggler_factor: float = 3.0,
                 capture_steps: bool = True,
                 device: str = "cuda") -> None:
        """``device`` is where the model and the default scheduler's lanes
        live: ``"cuda"`` (raises without a card) unless the caller asks for
        ``"cpu"``.  A ``scheduler`` passed in must run its lanes there."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TaskGraphTrainer: device='cuda' but no CUDA "
                               "device is available; pass device='cpu'")
        self.cfg = cfg
        self.optimizer = optimizer or AdamW(lr=1e-3, warmup=10,
                                            total_steps=1000)
        self.sched = scheduler or GrScheduler(policy="parallel",
                                              device=device)
        self.stream = SyntheticTokenStream(cfg, seq_len, global_batch,
                                           accum=accum, seed=seed)
        self.train_step = make_train_step(cfg, self.optimizer,
                                          use_flash=use_flash, remat=remat)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.sched.executor.history.straggler_factor = straggler_factor
        # The steady-state step issues an identical episode every iteration;
        # capture/replay turns its per-launch scheduling into a plan launch.
        self._capture_steps = capture_steps
        self._seq = seq_len

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """A fresh model (random weights from ``generator``, by default
        seeded 0 on the trainer's device) and its optimizer state."""
        from ..models import init_lm
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = init_lm(self.cfg, generator, device=self.device)
        return TrainState(params, self.optimizer.init(params))

    # ------------------------------------------------------------------
    def run(self, n_steps: int, state: Optional[TrainState] = None,
            fail_at: Optional[int] = None, resume: bool = True,
            metrics_every: int = 5) -> TrainerReport:
        """Run the training loop through the scheduler.  ``fail_at``
        injects a node failure at that step (for the restart test); with a
        checkpoint dir + ``resume=True``, training resumes from the latest
        checkpoint and continues to ``n_steps``.  A ``state`` passed in is
        trained in place."""
        report = TrainerReport()
        t0 = time.perf_counter()
        start_step = 0
        if state is None:
            state = self.init_state()
            if self.ckpt and resume:
                # restore_latest resolves (step, state) atomically — resuming
                # the loop from a step that disagrees with the restored state
                # is what broke bit-exact restart.
                ck_step, ck_state, extra = self.ckpt.restore_latest(like=state)
                if ck_step is not None:
                    saved_seed = extra.get("stream_seed")
                    if saved_seed is not None and saved_seed != self.stream.seed:
                        raise ValueError(
                            f"checkpoint was trained with stream seed "
                            f"{saved_seed}, trainer has {self.stream.seed}: "
                            f"resume would not be exact")
                    start_step, state = ck_step, ck_state
                    report.restarts += 1

        sched = self.sched
        state_v = ManagedValue(sched, state, name="train_state")
        metrics_v = ManagedValue(sched, None, name="metrics")
        # double-buffered host batch slots (WAR handled by the scheduler)
        slots = [
            {k: sched.array(v, name=f"{k}_{i}")
             for k, v in self.stream.batch(0).items()}
            for i in range(2)
        ]

        def step_kernel(state, *flat_batch):
            names = sorted(slots[0].keys())
            batch = dict(zip(names, flat_batch))
            new_state, metrics = self.train_step(state, batch)
            return new_state, metrics

        # Declared once per run: inout train state, const batch slots, out
        # metrics.  The declaration is what capture keys plans by, so every
        # steady-state step replays the same plan.
        slot_keys = sorted(slots[0].keys())
        step_fn = function(
            step_kernel,
            modes=("inout",) + ("const",) * len(slot_keys) + ("out",),
            name="train_step", scheduler=sched)

        for step in range(start_step, n_steps):
            if fail_at is not None and step == fail_at:
                raise SimulatedFailure(f"injected node failure at step {step}")
            slot = slots[step % 2]
            host_batch = self.stream.batch(step)        # host element
            for k in slot_keys:
                slot[k].write(host_batch[k])            # WAR vs step-2 kernel
            # Auto-capture the steady-state step: the double-buffered slots
            # alternate arrays but bind the same plan slots, so one plan
            # covers both phases after a short warm-up.
            ctx = (sched.capture("train_step") if self._capture_steps
                   else contextlib.nullcontext())
            with ctx:
                step_fn(state_v, *(slot[k] for k in slot_keys), metrics_v)
            if (step + 1) % metrics_every == 0 or step == n_steps - 1:
                m = metrics_v.get()                     # syncs this lane only
                report.losses.append(float(m["loss"]))
            if self.ckpt and (step + 1) % self.ckpt_every == 0:
                snap = state_v.get()
                self.ckpt.save(step + 1, snap,
                               extra={"stream_seed": self.stream.seed})
            report.steps_run += 1

        sched.sync()
        if self.ckpt:
            self.ckpt.wait()
        report.stragglers = self.sched.executor.history.stragglers_seen
        report.wall_time_s = time.perf_counter() - t0
        return report

    def run_with_restart(self, n_steps: int, fail_at: int) -> TrainerReport:
        """Convenience: run, crash at ``fail_at``, restart from the latest
        checkpoint, finish — the full fault-tolerance cycle.  The crashed
        run's scheduler is shut down and its state freed before the restart
        builds its own: a full-width train state takes half the card."""
        if self.ckpt is None:
            raise ValueError("run_with_restart needs a checkpoint dir")
        try:
            self.run(n_steps, fail_at=fail_at)
        except SimulatedFailure:
            pass
        # new scheduler (the "restarted job")
        old = self.sched
        old.shutdown()
        self.sched = GrScheduler(policy=old.policy, device=str(self.device))
        self.sched.executor.history.straggler_factor = \
            old.executor.history.straggler_factor
        del old
        gc.collect()
        report = self.run(n_steps)
        report.restarts += 1
        return report
