"""Submesh space-sharing: the paper's SM-level space-sharing re-expressed
at device level, the port of ``repro.runtime.spacesharing``.

The transferable insight is that **independent tasks should occupy idle
resources**.  ``SubmeshPool`` splits the devices into disjoint lanes of
whole devices, and the GrJAX stream manager schedules independent device
tasks (ensemble members, eval-during-train, per-request serving) onto them
concurrently: each task runs under ``torch.device`` of its lane's first
device, on the lane's CUDA stream, which the scheduler's executor already
makes current for it.

A lane is a list of devices, or, where ``devices`` is a ``DeviceMesh`` (a
process group spans the devices, one rank each), a ``(n, 1)`` sub-mesh
with ``axis_names`` over its share of the mesh's ranks.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..core import GrScheduler
from ..core.frontend import GrFunction
from ..core.managed import ManagedValue


def _visible_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("SubmeshPool: devices=None means every CUDA "
                           "device, and none is available; pass CPU devices "
                           "(e.g. [torch.device('cpu')]) for the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class SubmeshPool:
    """Disjoint lanes of whole devices.  ``n_lanes`` is capped at the
    number of devices (one card gives one lane); the devices must split
    evenly."""

    def __init__(self, devices=None, n_lanes: int = 2,
                 axis_names=("data", "model")) -> None:
        if hasattr(devices, "mesh_dim_names"):       # a DeviceMesh
            self._init_mesh(devices, n_lanes, axis_names)
            return
        devices = [torch.device(d) for d in (devices if devices is not None
                                             else _visible_devices())]
        n_lanes = min(n_lanes, len(devices))
        assert n_lanes and len(devices) % n_lanes == 0, \
            "devices must split evenly"
        per = len(devices) // n_lanes
        self.lanes: List = [devices[i * per:(i + 1) * per]
                            for i in range(n_lanes)]
        self.device_type = devices[0].type

    def _init_mesh(self, mesh, n_lanes: int, axis_names) -> None:
        from torch.distributed.device_mesh import DeviceMesh
        ranks = mesh.mesh.flatten()
        n_lanes = min(n_lanes, len(ranks))
        assert len(ranks) % n_lanes == 0, "devices must split evenly"
        per = len(ranks) // n_lanes
        self.lanes = [DeviceMesh(mesh.device_type,
                                 ranks[i * per:(i + 1) * per].reshape(-1, 1),
                                 mesh_dim_names=tuple(axis_names))
                      for i in range(n_lanes)]
        self.device_type = mesh.device_type

    def __len__(self) -> int:
        return len(self.lanes)

    def mesh(self, lane: int):
        """The lane's devices (or its sub-mesh)."""
        return self.lanes[lane % len(self.lanes)]

    def device(self, lane: int) -> torch.device:
        """The device a task on ``lane`` runs on: the lane's first."""
        lane = self.mesh(lane)
        if isinstance(lane, list):
            return lane[0]
        if lane.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(lane.device_type)


class SpaceSharedRunner:
    """Run independent tasks space-shared across a SubmeshPool, with
    dependencies still inferred by the GrJAX scheduler."""

    def __init__(self, pool: SubmeshPool,
                 scheduler: Optional[GrScheduler] = None) -> None:
        self.pool = pool
        self.sched = scheduler or GrScheduler(policy="parallel",
                                              max_lanes=len(pool),
                                              device=pool.device_type)
        # Declared identity per (name, arity): the per-submit closure below
        # must be re-created (it binds this submit's fn and element), but
        # re-minting a fresh GrFunction identity each time would make every
        # captured episode re-record — replay matches on fn_key and always
        # executes the *current* call's closure, so sharing the fid is safe.
        self._task_ids: Dict[tuple, int] = {}

    def submit(self, fn: Callable, value_args: List, name: str = "task"):
        """fn(*device_values) -> result; runs on the lane's devices."""
        result = ManagedValue(self.sched, None, name=f"{name}_out")

        def kernel(*vals):
            ins = vals[:-1]
            # the lane id chosen by the stream manager selects the lane
            lane = kernel_elem.stream or 0
            with torch.device(self.pool.device(lane)):
                return fn(*ins)

        key = (name, len(value_args))
        task = GrFunction(kernel,
                          modes=("const",) * len(value_args) + ("out",),
                          name=name, scheduler=self.sched,
                          _fid=self._task_ids.get(key))
        self._task_ids.setdefault(key, task.fid)
        kernel_elem = task(*value_args, result)
        return result

    def gather(self, results):
        return [r.get() for r in results]
