"""Fault-tolerant checkpointing: the port of ``repro.checkpoint.manager``,
with the same files, manifest and names.

* atomic: writes into ``step_XXXX.tmp`` then ``os.rename`` — a crash
  mid-save never corrupts the latest checkpoint;
* asynchronous: the device→host snapshot happens synchronously (consistent),
  file I/O runs on a background thread off the training critical path (the
  scheduler treats it as a host element);
* per-leaf ``.npy`` files keyed by tree path, with a JSON manifest;
* bounded: keeps the newest ``keep`` checkpoints.

A ``DTensor`` leaf is gathered to its full value for ``save`` and placed
with the placements of ``like``'s leaf by ``restore``, as the reference
writes ``np.asarray`` of a sharded array and ``device_put``s it back with
``like``'s sharding.  In a world of more than one rank every rank calls
``save`` (each gather needs every rank) and only the manager made with
``writer=True`` (rank 0) keeps the host copies and writes them; every
rank restores from that one directory.

A train state (an ``LM`` and its AdamW state, ``runtime.steps.TrainState``)
is written in the reference's layout through ``models.convert``: a
checkpoint of either package restores in the other.  Any other state is a
tree of dicts, lists, tuples and named tuples of arrays or tensors, named
leaf by leaf as the reference names a pytree's paths.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.convert import (from_jax_layout, placed_like, to_jax_layout,
                              whole)

_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_train_state(state: Any) -> bool:
    return isinstance(getattr(state, "params", None), torch.nn.Module)


def _walk(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[tuple]:
    """(path, leaf) in the reference's order: named-tuple fields, sorted
    dict keys, sequence indices."""
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), path + (f,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _rebuild(tree: Any, load, path: Tuple[str, ...] = ()) -> Any:
    """``tree``'s structure with each leaf replaced by ``load(name,
    leaf)``."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), load, path + (f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(v, load, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, load, path + (str(i),))
                          for i, v in enumerate(tree))
    return load("/".join(path), tree)


def _host_copy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return whole(leaf.detach()).cpu().numpy().copy()
    return np.array(leaf)


def _snapshot(state: Any, host: bool = True) -> Dict[str, np.ndarray]:
    """Host copies of every leaf of ``state``, by name; with ``host=False``
    only the gathers of its ``DTensor`` leaves, and an empty dict."""
    if _is_train_state(state):
        return to_jax_layout(state, host)
    if not host:
        for _, v in _walk(state):
            if isinstance(v, torch.Tensor):
                whole(v)
        return {}
    return {"/".join(p): _host_copy(v) for p, v in _walk(state)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True, writer: bool = True) -> None:
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.writer = writer
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # Snapshot-through-spill accounting (save_managed): blocks whose
        # bytes were referenced from a spill tier instead of copied again.
        self.spill_links = 0
        self.spill_link_bytes = 0
        self.tier_reads = 0
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _publish(self, step: int, tmp: str, final: str, manifest: dict,
                 pending, extra: Optional[dict]) -> None:
        for fn, arr in pending:
            np.save(os.path.join(tmp, fn), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest,
                       "extra": extra or {}}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)            # atomic publish
        self._gc()

    def _start(self, write) -> None:
        if not self.async_save:
            write()
            return

        def run():
            try:
                write()
            except BaseException as exc:   # raised again by wait()
                self._error = exc
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def save(self, step: int, state: Any, extra: Optional[dict] = None) -> None:
        """Persist ``state`` (and JSON-serializable ``extra`` metadata — RNG
        seeds, data-stream position, anything else exact resume consumes)."""
        # One in-flight save at a time.  Waiting before the snapshot (the
        # reference waits after it) holds one snapshot in host memory, not
        # two: a full-width train state is tens of GB.
        self.wait()
        # consistent host snapshot (D2H) — synchronous
        leaves = _snapshot(state, host=self.writer)
        if not self.writer:              # took part in the gathers only
            return
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        manifest, pending = {}, []
        for name, arr in leaves.items():
            fn = name.replace("/", "__") + ".npy"
            manifest[name] = {"file": fn, "dtype": str(arr.dtype),
                              "shape": list(arr.shape)}
            pending.append((fn, arr))

        def write():
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            self._publish(step, tmp, final, manifest, pending, extra)
        self._start(write)

    # ------------------------------------------------------------------
    def save_managed(self, step: int, arrays, extra: Optional[dict] = None,
                     ) -> dict:
        """Persist a ``{name: ManagedArray}`` mapping with
        **snapshot-through-spill**: a block the memory subsystem has already
        written to a backing tier is *referenced* instead of copied again.

        * Disk-tier blocks: the published spool file (tiers.py writes it
          tmp+rename, so the inode is immutable — a later re-spill replaces
          the file, never rewrites it) is **hard-linked** into the
          checkpoint, a metadata-only operation.
        * Compressed-tier blocks: the payload is decoded host-side through
          ``tier.peek`` — no device hop, and the spill stays resident.
        * Host-valid blocks are snapshotted from the host buffer; dirty
          device-resident blocks take the ordinary synchronized D2H first.

        Returns per-save reuse stats (also accumulated on the manager).
        File layout and manifest match :meth:`save`, so
        :meth:`restore_managed` / :meth:`latest_step` / ``keep``-GC all
        apply unchanged."""
        from ..core.element import dep_key
        self.wait()                          # one in-flight save at a time
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        stats = {"leaves": 0, "spill_links": 0, "spill_link_bytes": 0,
                 "tier_reads": 0, "copied": 0}
        manifest = {}
        pending = []                         # (file, np.ndarray) to np.save
        for name, ma in dict(arrays).items():
            fn = name.replace("/", "__") + ".npy"
            stats["leaves"] += 1
            entry = {"file": fn, "dtype": str(ma.dtype),
                     "shape": list(ma.shape)}
            tier = self._tier_of(ma)
            path = None
            if tier is not None and hasattr(tier, "path_for"):
                path = tier.path_for(dep_key(ma))
            if path is not None:
                try:
                    # Hard-link the published spool payload: copy-on-write
                    # snapshot, zero data movement.  Links are taken
                    # synchronously — an async deferral could race the
                    # block's reload (which removes the spool file).
                    os.link(path, os.path.join(tmp, fn))
                    stats["spill_links"] += 1
                    stats["spill_link_bytes"] += ma.nbytes
                    entry["via"] = "spill-link"
                except OSError:              # cross-device link etc.
                    shutil.copyfile(path, os.path.join(tmp, fn))
                    stats["tier_reads"] += 1
                    entry["via"] = "spill-copy"
                manifest[name] = entry
                continue
            if tier is not None:
                val = tier.peek(ma)
                if val is not None:
                    stats["tier_reads"] += 1
                    entry["via"] = "tier-read"
                    pending.append((fn, np.array(val)))
                    manifest[name] = entry
                    continue
            # Ordinary path: synchronized host snapshot (D2H if the device
            # copy is the only valid one).
            if not getattr(ma, "host_valid", True):
                ma.read()
            stats["copied"] += 1
            pending.append((fn, np.array(ma.host)))
            manifest[name] = entry
        self.spill_links += stats["spill_links"]
        self.spill_link_bytes += stats["spill_link_bytes"]
        self.tier_reads += stats["tier_reads"]
        self._start(lambda: self._publish(step, tmp, final, manifest,
                                          pending, extra))
        return stats

    @staticmethod
    def _tier_of(ma) -> Optional[Any]:
        tname = getattr(ma, "backing_tier", None)
        if tname is None:
            return None
        sched = getattr(ma, "_scheduler", None)
        mem = getattr(sched, "memory", None)
        return mem.tier_named(tname) if mem is not None else None

    def restore_managed(self, arrays, step: Optional[int] = None) -> None:
        """Load a checkpoint written by :meth:`save_managed` back into a
        ``{name: ManagedArray}`` mapping (host writes through the managed
        API, so location bits and DAG ordering stay correct)."""
        self.wait()
        d, manifest = self._manifest(step)
        for name, ma in dict(arrays).items():
            ma.write(np.load(os.path.join(d, manifest[name]["file"])))

    def wait(self) -> None:
        """Waits for the save in flight; raises what its writer raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        # Exact-resume correctness: an async save still in flight must be
        # visible to the caller deciding which step to resume from.
        self.wait()
        steps = []
        for d in os.listdir(self.dir):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def _manifest(self, step: Optional[int]) -> Tuple[str, dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            return d, json.load(f)["leaves"]

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``like``.  A train state is
        written in place and returned; any other tree comes back as a new
        tree whose leaves are numpy arrays, or tensors on the device of the
        tensor they replace.

        Callers resuming training should pin ``step`` to the value they got
        from :meth:`latest_step` so the loop counter and the restored state
        can never disagree (see :meth:`restore_latest`).
        """
        self.wait()
        d, manifest = self._manifest(step)

        def load(name):
            return np.load(os.path.join(d, manifest[name]["file"]),
                           mmap_mode="r")

        if _is_train_state(like):
            from_jax_layout({n: load(n) for n in manifest}, like)
            return like

        def leaf(name, ref):
            arr = np.array(load(name))
            if isinstance(ref, torch.Tensor):  # a DTensor: ref's layout
                return placed_like(torch.from_numpy(arr), ref)
            return arr
        return _rebuild(like, leaf)

    def restore_latest(self, like: Any):
        """Atomically resolve (step, state, extra) for exact resume.

        Returns ``(None, like, {})`` when no checkpoint exists.  The returned
        step is the one actually restored — callers must resume the loop from
        it rather than re-deriving it with a second ``latest_step()`` call.
        """
        step = self.latest_step()
        if step is None:
            return None, like, {}
        return step, self.restore(like, step=step), self._read_extra(step)

    def load_extra(self, step: Optional[int] = None) -> dict:
        """The ``extra`` metadata dict saved alongside ``step`` (``{}`` for
        checkpoints written before this field existed)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return self._read_extra(step)

    def _read_extra(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f).get("extra", {})

    def _gc(self) -> None:
        steps = []
        for d in os.listdir(self.dir):
            m = _STEP_RE.match(d)
            if m:
                steps.append(int(m.group(1)))
        steps.sort()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
