"""Backing tiers — the pluggable spill hierarchy behind the MemoryManager.

The flat budget spill has one answer to "where do evicted bytes go": the host, over
the D2H engine.  Multitasking under memory pressure wants a *hierarchy* of
backing stores (see "Towards Efficient and Practical GPU Multitasking in
the Era of LLM", PAPERS.md): an idle peer device over the fast D2D
interconnect first, then compressed host memory, then disk for truly huge
working sets.  This module defines the :class:`BackingTier` interface and
the three concrete tiers; the scheduler takes an *ordered stack* of them
(``GrScheduler(spill_tiers=[...])``) and the submission pipeline asks the
stack where each dirty victim should land — the first tier that
``can_accept`` the block wins, and a stack-wide miss falls back to the
flat D2H spill, which is also the default when no stack is
configured (bit-identical behaviour).

Only *dirty* victims (device copy newer than host) consult the stack: a
clean victim's bytes already live in the host buffer, so dropping the
device copy is free and no tier could do better.

Division of labour (mirrors the location-bit rules in memory.py):

* **Logical** bookkeeping (which tier holds which block, resident byte
  sums, stats) happens at *schedule* time via the MemoryManager's
  ``note_spill``/``note_reload`` — the simulator never moves real bytes.
* **Physical** payloads (compress, write the spool file, device_put to
  the peer) happen at *execution* time on the real executor via
  ``tier.spill(block)`` / ``tier.reload(block)``.

Tier wiring into the rest of the runtime:

* ``PeerDeviceTier`` spills are ``EVICT`` elements with ``src_device``
  set — the simulator runs them on the point-to-point D2D link and the
  real executor device_puts the value onto the peer.  The block stays
  *device-resident* (on the peer), so the ordinary migrate stage brings
  it back with a plain D2D when next consumed — no new reload machinery.
* Host-side tiers (compressed / disk) produce ``EVICT`` elements on the
  D2H engine and later ``RELOAD`` elements on the H2D engine; the block's
  ``backing_tier`` attribute names the holder (part of capture slot
  state, so a replayed plan reloads from the right tier).
* ``DiskTier`` spool files are written tmp+rename (atomic, like
  checkpoint/manager.py) — which is also what lets checkpointing
  hard-link a clean spilled block instead of copying it a second time
  (snapshot-through-spill).
"""
from __future__ import annotations

import os
import shutil
import tempfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .dtypes import to_numpy


def _nbytes(block: Any) -> int:
    try:
        return int(getattr(block, "nbytes", 0))
    except TypeError:  # pragma: no cover - exotic duck types
        return 0


def _block_value(block: Any) -> np.ndarray:
    """The newest physical value of a victim at spill time (real executor):
    the device copy when one is materialized, else the host buffer."""
    dev = getattr(block, "device", None)
    return to_numpy(dev) if dev is not None else np.asarray(block.host)


class BackingTier:
    """One layer of the spill stack.

    Subclasses implement the capacity test, the physical payload
    movement and their own stats; the MemoryManager drives the logical
    (schedule-time) bookkeeping through ``note_spill``/``note_reload``/
    ``note_release`` so stats and residency stay exact on the simulator.
    """

    name = "base"
    #: "host" tiers hold the payload off-device (RELOAD brings it back);
    #: "device" tiers park the block on another device (plain D2D reload).
    location = "host"

    def __init__(self) -> None:
        self.mem = None                       # bound MemoryManager
        self._resident: Dict[int, int] = {}   # key -> logical nbytes
        self.spills = 0
        self.spill_bytes = 0                  # logical bytes spilled (total)
        self.wire_bytes = 0                   # bytes moved over the link
        self.reloads = 0
        self.reload_bytes = 0
        self.drops = 0

    # -- wiring --------------------------------------------------------
    def bind(self, mem: Any) -> None:
        self.mem = mem

    # -- capacity ------------------------------------------------------
    def can_accept(self, nbytes: int, src_device: Optional[int] = None) -> bool:
        raise NotImplementedError

    def plan_spill(self, block: Any) -> dict:
        """Schedule-time description of one spill of ``block``:
        ``transfer_bytes`` (what the copy engine moves), ``config`` extras
        for the EVICT element (frozen into capture plan signatures) and,
        for device tiers, the ``target`` device."""
        return {"transfer_bytes": _nbytes(block), "config": {}, "target": None}

    def reload_wire_bytes(self, block: Any) -> int:
        """Bytes a RELOAD of ``block`` moves over the H2D engine (a
        compressed tier uploads the narrow codes and widens device-side)."""
        return _nbytes(block)

    # -- logical bookkeeping (schedule time, manager lock held) --------
    def holds(self, key: int) -> bool:
        return key in self._resident

    @property
    def resident_bytes(self) -> int:
        return sum(self._resident.values())

    def note_spill(self, key: int, nbytes: int, wire_bytes: int) -> None:
        self._resident[key] = nbytes
        self.spills += 1
        self.spill_bytes += nbytes
        self.wire_bytes += wire_bytes

    def note_reload(self, key: int) -> None:
        nb = self._resident.pop(key, 0)
        self.reloads += 1
        self.reload_bytes += nb

    def note_release(self, key: int) -> None:
        """The block left the tier without a reload (GC, host overwrite)."""
        if self._resident.pop(key, None) is not None:
            self.drops += 1

    # -- physical payloads (real executor) -----------------------------
    def spill(self, block: Any) -> None:
        """Store ``block``'s current value in the tier (executor thread)."""

    def reload(self, block: Any) -> np.ndarray:
        """Return the stored value (and refresh ``block.host``); the caller
        uploads it.  Also used synchronously for host reads of a
        tier-resident block."""
        raise NotImplementedError

    def drop(self, key: int) -> None:
        """Release the physical payload for ``key`` (idempotent)."""

    def peek(self, block: Any):
        """Non-destructive read of the stored value (checkpoint snapshots
        read through the tier without releasing the payload), or None when
        the tier holds no payload for ``block``."""
        return None

    # -- reporting -----------------------------------------------------
    def stats(self) -> dict:
        return {"spills": self.spills,
                "spill_bytes": self.spill_bytes,
                "wire_bytes": self.wire_bytes,
                "reloads": self.reloads,
                "reload_bytes": self.reload_bytes,
                "drops": self.drops,
                "resident_blocks": len(self._resident),
                "spilled_bytes_resident": self.resident_bytes}

    def host_restore_seconds(self, nbytes: int) -> float:
        """Simulated cost of restoring a block host-side (host read path)."""
        return 0.0

    def close(self) -> None:
        """Scheduler shutdown: release every payload and backing resource."""
        self._resident.clear()


# ======================================================================
class PeerDeviceTier(BackingTier):
    """Spill to the least-pressured *other* device over the D2D link.

    The fast tier: NVLink/P2P bandwidth (``SimHardware.d2d_gbps``, default
    50 GB/s) beats the PCIe D2H+H2D round trip several times over, and the
    block stays device-resident — reloading it is the ordinary migrate-stage
    D2D the runtime already performs for cross-device reads.  A block is
    accepted only when some other device can hold it *without* evicting
    (free budget room), so spills never cascade."""

    name = "peer-device"
    location = "device"

    def __init__(self, headroom: float = 1.0) -> None:
        super().__init__()
        #: fraction of a peer's budget the tier may fill (1.0 = up to budget).
        self.headroom = headroom

    def _target_for(self, nbytes: int, src_device: Optional[int]) -> Optional[int]:
        mem = self.mem
        if mem is None or mem.num_devices <= 1:
            return None
        best, best_key = None, None
        for d in range(mem.num_devices):
            if d == (src_device if src_device is not None else 0):
                continue
            pool = mem.pools[d]
            if pool.budget_bytes is not None:
                room = pool.budget_bytes * self.headroom - pool.resident_bytes
                if nbytes > room:
                    continue
            key = (mem.pressure(d), d)
            if best_key is None or key < best_key:
                best, best_key = d, key
        return best

    def can_accept(self, nbytes: int, src_device: Optional[int] = None) -> bool:
        return self._target_for(nbytes, src_device) is not None

    def plan_spill(self, block: Any) -> dict:
        nb = _nbytes(block)
        target = self._target_for(nb, getattr(block, "device_id", None))
        return {"transfer_bytes": nb,
                "config": {"tier": self.name, "spill_target": target},
                "target": target}

    # Peer blocks stay in the device pools; per-tier residency here only
    # feeds the ``spilled_bytes_resident`` pressure stat.


# ======================================================================
class CompressedHostTier(BackingTier):
    """Spill to host memory through a compressor.

    Two codecs, selected by the ``lossy`` exactness flag:

    * ``lossy=False`` (default) — **lossless** ``zlib`` bytes.  The wire
      cost is the full D2H copy (compression happens host-side), the
      round trip is bit-exact, only host RAM is saved.
    * ``lossy=True`` — **bf16 demotion** for float32 blocks: the mantissa
      is rounded (nearest-even) to 8 bits and only the top halfword is
      kept, so both the wire transfer and the host payload are half size.
      This reuses the demote-and-track-the-residual idiom of
      ``repro.optim.compress`` — but where gradient compression *carries*
      the residual into the next step (the same tensor is re-compressed
      every step), a spilled block is re-spilled only after being
      overwritten with unrelated data, so the residual is reported as an
      error bound (``max_abs_error``) instead of fed back.  Non-float32
      blocks fall back to lossless bytes — exactness is only ever traded
      where the flag explicitly allows it.

    ``capacity_bytes`` bounds the tier (by *logical* block bytes) so a
    stack like ``[CompressedHostTier(capacity_bytes=...), DiskTier()]``
    overflows to disk instead of growing host memory without bound.
    """

    name = "compressed-host"
    location = "host"

    def __init__(self, lossy: bool = False,
                 capacity_bytes: Optional[int] = None) -> None:
        super().__init__()
        self.lossy = lossy
        self.capacity_bytes = capacity_bytes
        self.stored_bytes = 0                  # physical payload bytes held
        self.lossy_blocks = 0
        self.max_abs_error = 0.0
        self._payload: Dict[int, Tuple[str, bytes, tuple, str]] = {}

    def can_accept(self, nbytes: int, src_device: Optional[int] = None) -> bool:
        if self.capacity_bytes is None:
            return True
        return self.resident_bytes + nbytes <= self.capacity_bytes

    def _wire_bytes(self, block: Any) -> int:
        nb = _nbytes(block)
        if self.lossy and str(getattr(block, "dtype", "")) == "float32":
            return nb // 2         # demotion happens device-side: half wire
        return nb

    def plan_spill(self, block: Any) -> dict:
        return {"transfer_bytes": self._wire_bytes(block),
                "config": {"tier": self.name}, "target": None}

    def reload_wire_bytes(self, block: Any) -> int:
        return self._wire_bytes(block)

    # -- physical ------------------------------------------------------
    def spill(self, block: Any) -> None:
        from .element import dep_key
        arr = _block_value(block)
        key = dep_key(block)
        if self.lossy and arr.dtype == np.float32:
            # bf16 demotion with round-to-nearest-even on the dropped bits.
            u = np.ascontiguousarray(arr).view(np.uint32)
            rounded = u + 0x7FFF + ((u >> 16) & 1)
            codes = (rounded >> 16).astype(np.uint16)
            approx = (codes.astype(np.uint32) << 16).view(np.float32)
            err = float(np.max(np.abs(arr - approx))) if arr.size else 0.0
            self.max_abs_error = max(self.max_abs_error, err)
            self.lossy_blocks += 1
            payload = ("bf16", codes.tobytes(), arr.shape, "float32")
        else:
            payload = ("zlib", zlib.compress(
                np.ascontiguousarray(arr).tobytes(), 1),
                arr.shape, str(arr.dtype))
        prev = self._payload.get(key)
        if prev is not None:
            self.stored_bytes -= len(prev[1])
        self._payload[key] = payload
        self.stored_bytes += len(payload[1])

    def _decode(self, key: int) -> np.ndarray:
        codec, raw, shape, dtype = self._payload[key]
        if codec == "bf16":
            codes = np.frombuffer(raw, np.uint16).reshape(shape)
            return (codes.astype(np.uint32) << 16).view(np.float32)
        return np.frombuffer(zlib.decompress(raw), dtype).reshape(shape)

    def peek(self, block: Any):
        from .element import dep_key
        key = dep_key(block)
        return self._decode(key) if key in self._payload else None

    def reload(self, block: Any) -> np.ndarray:
        from .element import dep_key
        key = dep_key(block)
        val = self._decode(key)
        host = getattr(block, "host", None)
        if host is not None:
            np.copyto(host, val)
        self.drop(key)
        return val

    def drop(self, key: int) -> None:
        payload = self._payload.pop(key, None)
        if payload is not None:
            self.stored_bytes -= len(payload[1])

    def stats(self) -> dict:
        out = super().stats()
        out.update({"lossy": self.lossy, "stored_bytes": self.stored_bytes})
        if self.lossy:
            out.update({"lossy_blocks": self.lossy_blocks,
                        "max_abs_error": self.max_abs_error})
        return out

    def close(self) -> None:
        super().close()
        self._payload.clear()
        self.stored_bytes = 0


# ======================================================================
class DiskTier(BackingTier):
    """Spill to memory-mapped ``.npy`` files under a spool directory.

    The last-resort tier for working sets bounded by *aggregate* rather
    than device (or even host) memory.  Every spool write is atomic
    (``blk_<key>.tmp`` then ``os.rename``, the checkpoint/manager.py
    idiom), which makes published payload files immutable-by-inode: the
    checkpoint manager snapshots a disk-resident block by *hard-linking*
    the spool file instead of copying it (snapshot-through-spill) and a
    later re-spill replaces the inode without touching the link.

    Spool files are removed on block reload/GC (weakref finalizers in
    memory.py) and the whole directory on ``close()`` (scheduler
    shutdown) — nothing leaks.  ``gbps`` is the simulated disk bandwidth:
    the D2H/H2D engine stays occupied for the whole spill/reload but runs
    at the slower disk rate (the dominating stage of the pipe)."""

    name = "disk"
    location = "host"

    def __init__(self, spool_dir: Optional[str] = None,
                 gbps: float = 3.0) -> None:
        super().__init__()
        self.gbps = gbps
        self._own_dir = spool_dir is None
        self.spool_dir = spool_dir or tempfile.mkdtemp(prefix="grjax_spool_")
        os.makedirs(self.spool_dir, exist_ok=True)
        self.files_written = 0
        self._files: Dict[int, str] = {}

    def can_accept(self, nbytes: int, src_device: Optional[int] = None) -> bool:
        return True

    def plan_spill(self, block: Any) -> dict:
        return {"transfer_bytes": _nbytes(block),
                "config": {"tier": self.name, "tier_gbps": self.gbps},
                "target": None}

    def path_for(self, key: int) -> Optional[str]:
        """Published spool file for ``key`` (checkpoint hard-link source)."""
        return self._files.get(key)

    # -- physical ------------------------------------------------------
    def spill(self, block: Any) -> None:
        from .element import dep_key
        key = dep_key(block)
        arr = _block_value(block)
        final = os.path.join(self.spool_dir, f"blk_{abs(key)}.npy")
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.rename(tmp, final)                  # atomic publish
        self._files[key] = final
        self.files_written += 1

    @staticmethod
    def _typed(val: np.ndarray, block: Any) -> np.ndarray:
        """``.npy`` files store ``ml_dtypes.bfloat16`` as raw 2-byte
        records (``V2``); view them back as the block's host dtype."""
        if val.dtype.kind == "V":
            return val.view(block.host.dtype)
        return val

    def peek(self, block: Any):
        from .element import dep_key
        path = self._files.get(dep_key(block))
        return self._typed(np.load(path), block) if path else None

    def reload(self, block: Any) -> np.ndarray:
        from .element import dep_key
        key = dep_key(block)
        val = np.load(self._files[key], mmap_mode="r")
        val = self._typed(np.array(val), block)   # materialize off the mmap
        host = getattr(block, "host", None)
        if host is not None:
            np.copyto(host, val)
        self.drop(key)
        return val

    def drop(self, key: int) -> None:
        path = self._files.pop(key, None)
        if path is not None:
            try:
                os.remove(path)
            except OSError:       # pragma: no cover - already gone
                pass

    def host_restore_seconds(self, nbytes: int) -> float:
        return nbytes / (self.gbps * 1e9)

    def stats(self) -> dict:
        return dict(super().stats(), gbps=self.gbps,
                    files_written=self.files_written,
                    files_resident=len(self._files))

    def close(self) -> None:
        super().close()
        self._files.clear()
        if self._own_dir:
            shutil.rmtree(self.spool_dir, ignore_errors=True)
        else:
            for f in os.listdir(self.spool_dir):
                if f.startswith("blk_"):
                    try:
                        os.remove(os.path.join(self.spool_dir, f))
                    except OSError:  # pragma: no cover
                        pass


# ======================================================================
TIER_TYPES = {t.name: t for t in (PeerDeviceTier, CompressedHostTier,
                                  DiskTier)}


def make_tiers(spec) -> List[BackingTier]:
    """Normalize a ``spill_tiers`` argument: a list of tier instances
    and/or names ("peer-device" / "compressed-host" / "disk")."""
    if spec is None:
        return []
    tiers: List[BackingTier] = []
    for item in spec:
        if isinstance(item, BackingTier):
            tiers.append(item)
        elif isinstance(item, str):
            try:
                tiers.append(TIER_TYPES[item]())
            except KeyError:
                raise ValueError(f"unknown spill tier {item!r}; choose from "
                                 f"{sorted(TIER_TYPES)}") from None
        else:
            raise TypeError(f"spill tier must be a BackingTier or a name, "
                            f"got {item!r}")
    return tiers
