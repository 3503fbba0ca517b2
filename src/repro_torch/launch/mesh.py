"""Device meshes of the port: the port of ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, one rank per device, built over the process group
that is already set up (``torch.distributed.init_process_group``, or
``torchrun``'s).  It lies on ``cuda`` when the group's backend is NCCL and
on ``cpu`` otherwise (gloo, or the fake backend of a shape-only world).
Building a mesh is a collective: every rank of the world calls it, also a
rank that the mesh leaves out.

The constants are one NVIDIA H100 SXM5's, for the dry run's roofline (no
code reads them yet).  An axis of 16 ranks spans two 8-GPU NVLink domains
(an HGX H100 board holds eight), so part of its traffic crosses the
inter-node fabric at ``INTERNODE_BW``, not ``NVLINK_BW``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: dense bf16 tensor-core
# rate (1,979 TFLOP/s is with 2:4 sparsity).
PEAK_BF16_FLOPS = 989e12
# Same datasheet: HBM3 at 3.35 TB/s, 80 GB.
HBM_BW = 3.35e12
HBM_BYTES = 80e9
# Same datasheet: NVLink 4 at 900 GB/s per GPU, both directions together.
NVLINK_BW = 450e9
# NVIDIA DGX H100 system documentation: one ConnectX-7 400 Gb/s
# InfiniBand port per GPU, per direction.
INTERNODE_BW = 50e9


def mesh_device_type() -> str:
    """``cuda`` for an NCCL world, ``cpu`` for any other backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "torch.distributed.init_process_group first, or "
                           "run under torchrun")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n == world:
        return init_device_mesh(mesh_device_type(), tuple(shape),
                                mesh_dim_names=tuple(names))
    if n > world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the world "
                         f"has {world}")
    # a mesh over the first n ranks (the elastic path after a device loss)
    ranks = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh(mesh_device_type(), ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_mesh_for(n_devices: int, model_parallel: int = 16):
    """Elastic variant: best (data, model) mesh for an arbitrary device
    count (used by the elastic re-mesh path), over the first ``n_devices``
    ranks of the world."""
    tp = min(model_parallel, n_devices)
    while n_devices % tp:
        tp //= 2
    return _mesh((n_devices // tp, tp), ("data", "model"))


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a mapping of the
    same (a shape-only mesh, for the spec functions)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def init_world(device) -> bool:
    """Sets up a world of one rank when no process group exists (NCCL on
    ``cuda``, gloo on ``cpu``), over a ``FileStore`` in a temporary
    directory; under ``torchrun`` (``WORLD_SIZE`` set) its group.  Returns
    whether this call made the group (the caller then destroys it)."""
    import os
    import tempfile
    if dist.is_initialized():
        return False
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    torchrun = "WORLD_SIZE" in os.environ
    if device.type == "cuda":      # before the first NCCL communicator
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              if torchrun else device.index or 0)
    if torchrun:
        dist.init_process_group(backend)
        return True
    fd, path = tempfile.mkstemp(prefix="repro_torch_store_")
    os.close(fd)
    os.unlink(path)
    dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    return True
