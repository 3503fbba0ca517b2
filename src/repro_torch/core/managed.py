"""ManagedArray — GrCUDA's UM-backed polyglot array, adapted to JAX.

GrCUDA arrays live in CUDA Unified Memory: the host reads/writes them like
normal arrays while the runtime tracks every access and orders it against GPU
work (§IV-A).  TPUs have no page-fault UM, so GrJAX keeps an explicit
host/device pair with validity bits and lets the scheduler insert
*asynchronous prefetch* transfers (the paper's recommended mode — §V-C shows
prefetching strictly dominates fault-driven migration).

Host accesses go through ``read()`` / ``write()`` (or ``np.asarray(ma)`` /
indexing), which notify the scheduler: accesses that introduce a data
dependency on in-flight device work become HOST_ACCESS computational
elements; accesses that cannot introduce dependencies are executed
immediately without touching the DAG (§IV-A, low-overhead path).
"""
from __future__ import annotations

import itertools
from typing import Any, Optional, Tuple

import numpy as np

_ARRAY_IDS = itertools.count()


class ManagedArray:
    """A host+device array pair managed by a GrScheduler."""

    def __init__(self, scheduler: Any, host: Optional[np.ndarray] = None, *,
                 shape: Optional[Tuple[int, ...]] = None, dtype=np.float32,
                 name: str = "") -> None:
        if host is None:
            host = np.zeros(shape, dtype=dtype)
        self._scheduler = scheduler
        self.host: np.ndarray = np.asarray(host)
        self.device: Any = None            # torch.Tensor once transferred
        self.host_valid = True
        self.device_valid = False
        # Which device owns the current device copy (single-copy model: a
        # cross-device consumer triggers a D2D element that moves ownership).
        self.device_id: Optional[int] = None
        # Name of the backing tier (tiers.py) currently holding the only
        # valid copy off-device, or None.  Set/cleared exclusively by the
        # MemoryManager's note_spill/note_reload transitions; part of the
        # capture slot state so replayed plans reload from the right tier.
        self.backing_tier: Optional[str] = None
        self.aid = next(_ARRAY_IDS)
        self.name = name or f"arr{self.aid}"

    # -- geometry ------------------------------------------------------
    @property
    def shape(self):
        return self.host.shape

    @property
    def dtype(self):
        return self.host.dtype

    @property
    def nbytes(self) -> int:
        return int(self.host.nbytes)

    # -- device-side value used by executors ---------------------------
    # NOTE on concurrency: ``host_valid``/``device_valid`` are *logical*
    # location bits owned by the scheduling thread and flipped at SCHEDULE
    # time (the scheduler knows what each scheduled element will produce).
    # Worker threads only install the physical ``device`` value.  Reading
    # stale flags from workers caused mis-scheduled prefetches otherwise.
    def device_value(self):
        if self.device is not None:
            return self.device
        return self.host

    def set_physical_device(self, value) -> None:
        """Called by executors when a kernel/transfer materializes a value."""
        self.device = value

    # -- host access API (triggers scheduling) --------------------------
    def read(self) -> np.ndarray:
        self._scheduler.host_read(self)
        return self.host

    def _host_overwrote(self) -> None:
        """Location-bit update after the host mutated ``self.host``.

        The device copy (if any) is now stale, and — crucially — no device
        *owns* a valid copy anymore, so ``device_id`` must be cleared too.
        Leaving it behind (the old behaviour) meant a write after a D2D
        migration kept pointing at the last owning device: capture plans then
        spuriously mismatched fresh arrays (whose ``device_id`` is None) and
        the multi-device migrate stage could treat the dead copy as claimable
        state.  On a never-transferred array this is a no-op: neither
        ``device_valid`` nor ``device_id`` flips.

        The transition routes through the scheduler's MemoryManager (the
        single owner of location-bit flips) so the device pool's resident-set
        accounting drops the stale copy in the same step — bits and residency
        cannot diverge.  Duck-typed test schedulers without a ``memory``
        attribute fall back to the inline flip.
        """
        mem = getattr(self._scheduler, "memory", None)
        if mem is not None:
            mem.note_host_overwrite(self)
            return
        self.host_valid = True
        if self.device_valid or self.device_id is not None:
            self.device_valid = False
            self.device_id = None

    def write(self, value) -> None:
        self._scheduler.host_write(self)
        self.host[...] = value
        self._host_overwrote()

    def __array__(self, dtype=None):
        out = self.read()
        return out.astype(dtype) if dtype is not None else out

    def __getitem__(self, idx):
        return self.read()[idx]

    def __setitem__(self, idx, value):
        self._scheduler.host_write(self)
        self.host[idx] = value
        self._host_overwrote()

    def __repr__(self) -> str:  # pragma: no cover
        loc = "D" if self.device_valid else "-"
        loc += "H" if self.host_valid else "-"
        return f"<ManagedArray {self.name} {self.shape} {self.dtype} [{loc}]>"


class ManagedValue:
    """Device-resident opaque value (e.g. a TrainState pytree) under the
    scheduler's dependency tracking.  No host mirror: it is produced and
    consumed by device kernels; ``get()`` synchronizes the owning lanes and
    returns the pytree (used for checkpointing/metrics)."""

    def __init__(self, scheduler: Any, value: Any = None, name: str = "") -> None:
        self._scheduler = scheduler
        self.device: Any = value
        self.host = None
        self.host_valid = False
        self.device_valid = value is not None
        self.device_id: Optional[int] = 0 if value is not None else None
        self.aid = next(_ARRAY_IDS)
        self.name = name or f"val{self.aid}"

    @property
    def nbytes(self) -> int:
        return 0

    def device_value(self):
        return self.device

    def set_physical_device(self, value) -> None:
        self.device = value

    def get(self):
        self._scheduler._sync_against(self, writes=False)
        return self.device
