"""Runtime sanitizer: shadow version-vectors + const digest canaries.

``GrScheduler(sanitize=True)`` installs a :class:`Sanitizer` on the
executor's element-boundary hooks (``pre_exec``/``post_exec``, called
around every element body on both executors).  It shadow-tracks, per
``dep_key``:

* the **in-flight access set** — which elements currently hold the array
  for reading/writing.  A write beginning while another access is in
  flight, or a read beginning while a write is in flight, is an observed
  race (a conflicting pair the DAG failed to order) and raises
  :class:`SanitizerError` immediately, attributing both elements;
* a **version counter**, bumped at each write completion.  Readers record
  the version at element start and re-check it at completion;
* on the real executor, a **digest canary** over ``const`` operands: the
  operand's bytes are digested before and after the kernel body, so a
  kernel that mutates a const-declared operand in place (a write the DAG
  cannot see) is caught at the element boundary.

The digest (:func:`digest`) is taken where the value lives — on the card
for a CUDA tensor, over an int8 view of its bytes (bf16 included), with no
copy to the host — and equal bytes give equal digests whether they sit in
a host buffer or in a device tensor.  The real executor calls
``pre_exec`` with the lane's stream current, so the first digest is
issued on that stream before the kernel, and ``post_exec`` once the
kernel has completed.  Digests are taken and compared outside the
sanitizer's lock (the comparison waits for the lane's stream), so one
lane's wait never holds up another lane's element boundary.  A value the
canary cannot digest raises; the canary is never silently off.

Temporary device memory: about 1/26 of the operand's bytes (eight row
sums per 4 KiB of operand, in int32 and then int64), plus per device 160
KiB of column weights and 8 bytes of row weight per 4 KiB of the largest
operand digested, made once.

The tracking is purely observational: it never blocks, reorders or
copies, so ``sanitize=False`` (the default — no hooks installed) is
bit-identical, and sim-executor timelines are unchanged even when it is
on (the hooks run outside the simulated clock).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.element import AccessMode, ComputationalElement


class SanitizerError(RuntimeError):
    """An observed race or write-through-const at an element boundary."""


class _KeyState:
    __slots__ = ("version", "writer", "writer_name", "readers")

    def __init__(self) -> None:
        self.version = 0
        self.writer: Optional[int] = None       # uid of in-flight writer
        self.writer_name = ""
        self.readers: Dict[int, str] = {}       # uid -> name, in-flight reads


def _array_name(e: ComputationalElement, key) -> str:
    for a in e.args:
        if a.key == key:
            return getattr(a.array, "name", None) or str(key)
    return str(key)


# ----------------------------------------------------------------------
# digests
# ----------------------------------------------------------------------
# A value's N bytes b_0 .. b_{N-1}, read as signed int8 and cut into rows
# of DIGEST_ROW bytes (the last row padded with zeros), digest to
#
#     (N, D_0 .. D_7),   D_c = sum_r q_r * sum_k b_{r,k} * w_{k,c}
#
# with fixed nonzero int8 column weights w and row weights q_r in
# [1, 32749].  Every sum is exact in int32/int64 (up to 16 GiB of bytes),
# so the host's and the card's digests of equal bytes are equal, and any
# change confined to one row shows unless it is orthogonal to all eight
# weight columns.  The row products are one int8 matrix product (tensor
# cores on the card): the operand is read once, and the temporaries (the
# row sums in int32, then int64) take about N / 26 bytes.

DIGEST_ROW = 4096
_COLUMNS = 8
_MM_MIN_ROWS = 17           # torch._int_mm on CUDA wants more than 16 rows


def _column_weights() -> np.ndarray:
    """(8, DIGEST_ROW) int8, nonzero, with nonzero column sums."""
    rng = np.random.RandomState(0x5A17)
    w = rng.randint(1, 128, size=(_COLUMNS, DIGEST_ROW))
    w *= rng.choice((-1, 1), size=w.shape)
    assert (w.sum(axis=1) != 0).all()
    return w.astype(np.int8)


class _Digester:
    """Per device, made once and shared by every lane: the column weights
    (int8 for the matrix product, int32 for the elementwise route) and the
    row weights, grown on demand.  Row weights that larger ones replace
    are kept: another lane's stream may still read them, and a freed block
    would go back to the stream that made it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._columns: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._rows: Dict[Any, torch.Tensor] = {}
        self._retired: List[torch.Tensor] = []

    def _weights(self, device, rows: int):
        cols, q = self._columns.get(device), self._rows.get(device)
        if cols is not None and q is not None and len(q) >= rows:
            return cols, q
        with self._lock:
            cols = self._columns.get(device)
            if cols is None:
                w = torch.from_numpy(_column_weights()).to(device)
                cols = self._columns[device] = (w, w.to(torch.int32))
            q = self._rows.get(device)
            if q is None or len(q) < rows:
                if q is not None:
                    self._retired.append(q)
                n = max(rows, 2 * len(q) if q is not None else 1024)
                q = torch.arange(n, dtype=torch.int64, device=device)
                q = self._rows[device] = q * 2654435761 % 32749 + 1
            if q.is_cuda:       # complete before another lane reads them
                torch.cuda.current_stream(device).synchronize()
            return cols, q

    def bytes(self, b: torch.Tensor) -> Tuple[int, torch.Tensor]:
        """Digest of a flat int8 tensor, on its device, issued on the
        current stream: ``(N, int64 (8,) tensor)``, not yet synchronized."""
        n = b.numel()
        rows, tail = divmod(n, DIGEST_ROW)
        (wt, wt32), q = self._weights(b.device, rows + 1)   # wt: (8, ROW)
        full = b[:rows * DIGEST_ROW]
        if rows >= _MM_MIN_ROWS:
            if full.data_ptr() % 16:
                full = full.clone()
            m = torch._int_mm(full.view(rows, DIGEST_ROW), wt.t())
        else:
            m = (full.view(rows, DIGEST_ROW, 1).to(torch.int32)
                 * wt32.t()).sum(1)
        if tail:        # the last row, zero-padded: a few KiB at most
            last = (b[rows * DIGEST_ROW:].to(torch.int32)
                    * wt32[:, :tail]).sum(1)
            m, rows = torch.cat((m, last[None])), rows + 1
        return n, (m.to(torch.int64) * q[:rows, None]).sum(0)

    def pending(self, value: Any, what: str) -> Any:
        """The digest of ``value``, possibly still running on a device:
        tensors and host arrays are digested where they live; containers
        and modules leaf by leaf; immutable scalars stand for themselves."""
        if isinstance(value, torch.Tensor):
            flat = value.detach().reshape(-1)
            if flat.dtype == torch.bool:
                flat = flat.view(torch.uint8)
            return self.bytes(flat.view(torch.int8))
        if isinstance(value, np.ndarray):
            if value.dtype.hasobject:
                raise SanitizerError(f"const canary: cannot digest {what}, "
                                     f"an object array")
            flat = np.ascontiguousarray(value).reshape(-1).view(np.int8)
            if not flat.flags.writeable:    # torch.from_numpy wants writable
                flat = flat.copy()
            return self.bytes(torch.from_numpy(flat))
        if isinstance(value, (bool, int, float, complex, str, bytes,
                              type(None), np.generic)):
            return value
        if isinstance(value, torch.nn.Module):
            return [self.pending(v, what) for v in
                    value.state_dict(keep_vars=True).values()]
        if isinstance(value, dict):
            return [(k, self.pending(v, what)) for k, v in value.items()]
        if isinstance(value, (list, tuple)):
            return [self.pending(v, what) for v in value]
        raise SanitizerError(f"const canary: cannot digest {what}, a "
                             f"{type(value).__name__}")


def resolve(pending: Any) -> Any:
    """Finish a pending digest: wait for the device's sums and bring them
    to the host as Python ints."""
    if isinstance(pending, tuple) and len(pending) == 2 \
            and isinstance(pending[1], torch.Tensor):
        return (pending[0], tuple(pending[1].tolist()))
    if isinstance(pending, list):
        return [resolve(p) for p in pending]
    if isinstance(pending, tuple):
        return tuple(resolve(p) for p in pending)
    return pending


def digest(value: Any) -> Any:
    """Digest of a tensor, host array or container of them (synchronous)."""
    return resolve(_Digester().pending(value, "value"))


def _operand(e: ComputationalElement, key) -> Any:
    """The value the kernel reads for the operand behind ``key``: the
    device copy when one is materialized, else the host buffer."""
    for a in e.args:
        if a.key == key:
            return a.array.device_value()
    raise SanitizerError(f"const canary: {e.name}(uid {e.uid}) has no "
                         f"operand {key}")


class Sanitizer:
    """Thread-safe shadow tracker; see the module docstring."""

    def __init__(self, checksums: bool = False) -> None:
        self.checksums = bool(checksums)
        self._lock = threading.Lock()
        self._state: Dict[object, _KeyState] = {}
        self._modes: Dict[int, Dict[object, AccessMode]] = {}
        self._observed: Dict[int, List[Tuple[object, int]]] = {}
        self._canaries: Dict[int, List[Tuple[object, Any]]] = {}
        self._digester = _Digester()
        self.elements_checked = 0
        self.races_detected = 0
        self.digests = 0            # const canary digests issued

    # ------------------------------------------------------------------
    def on_schedule(self, e: ComputationalElement) -> None:
        """Snapshot the declared access set at submission time (args can
        be rebound later on replay paths; the declaration is the claim
        being audited)."""
        with self._lock:
            self._modes[e.uid] = dict(e.arg_modes())

    def _modes_of(self, e: ComputationalElement) -> Dict[object, AccessMode]:
        return self._modes.get(e.uid) or dict(e.arg_modes())

    def _digest(self, e: ComputationalElement, key) -> Any:
        with self._lock:
            self.digests += 1
        return self._digester.pending(
            _operand(e, key), f"operand {_array_name(e, key)!r} of "
                              f"{e.name}(uid {e.uid})")

    # ------------------------------------------------------------------
    def pre_exec(self, e: ComputationalElement) -> None:
        """Element body is about to run: claim its declared accesses and
        raise on any conflicting in-flight access; then issue the const
        operands' first digests (on the caller's current stream)."""
        const_keys: List[object] = []
        with self._lock:
            modes = self._modes_of(e)
            observed: List[Tuple[object, int]] = []
            for key, mode in modes.items():
                st = self._state.setdefault(key, _KeyState())
                aname = _array_name(e, key)
                if mode.writes:
                    if st.writer is not None and st.writer != e.uid:
                        self.races_detected += 1
                        raise SanitizerError(
                            f"write-write race on array {aname!r}: "
                            f"{e.name}(uid {e.uid}) began while "
                            f"{st.writer_name}(uid {st.writer}) is still "
                            f"writing — the DAG never ordered this WAW "
                            f"pair")
                    if st.readers:
                        ruid, rname = next(iter(st.readers.items()))
                        self.races_detected += 1
                        raise SanitizerError(
                            f"read-write race on array {aname!r}: writer "
                            f"{e.name}(uid {e.uid}) began while "
                            f"{rname}(uid {ruid}) is still reading — the "
                            f"DAG never ordered this WAR pair")
                    st.writer, st.writer_name = e.uid, e.name
                else:
                    if st.writer is not None:
                        self.races_detected += 1
                        raise SanitizerError(
                            f"write-read race on array {aname!r}: reader "
                            f"{e.name}(uid {e.uid}) began while "
                            f"{st.writer_name}(uid {st.writer}) is still "
                            f"writing — the DAG never ordered this RAW "
                            f"pair")
                    st.readers[e.uid] = e.name
                    observed.append((key, st.version))
                    if self.checksums and mode is AccessMode.CONST:
                        const_keys.append(key)
            if observed:
                self._observed[e.uid] = observed
        if const_keys:
            canaries = [(key, self._digest(e, key)) for key in const_keys]
            with self._lock:
                self._canaries[e.uid] = canaries

    def post_exec(self, e: ComputationalElement) -> None:
        """Element body finished: re-digest the const operands (outside the
        lock), then release claims, bump write versions, re-check read
        versions and const digests."""
        with self._lock:
            canaries = self._canaries.pop(e.uid, ())
        changed = {key for key, d0 in canaries
                   if resolve(d0) != resolve(self._digest(e, key))}
        with self._lock:
            modes = self._modes_of(e)
            observed = dict(self._observed.pop(e.uid, ()))
            self._modes.pop(e.uid, None)
            self.elements_checked += 1
            for key, mode in modes.items():
                st = self._state.get(key)
                if st is None:
                    continue
                aname = _array_name(e, key)
                if mode.writes:
                    if st.writer == e.uid:
                        st.writer, st.writer_name = None, ""
                    st.version += 1
                else:
                    st.readers.pop(e.uid, None)
                    v0 = observed.get(key)
                    if v0 is not None and st.version != v0:
                        self.races_detected += 1
                        raise SanitizerError(
                            f"torn read on array {aname!r}: {e.name}"
                            f"(uid {e.uid}) observed version {v0} at start "
                            f"but {st.version} at completion — a writer "
                            f"ran mid-read without a DAG edge")
                    if key in changed:
                        self.races_detected += 1
                        raise SanitizerError(
                            f"write through const on array {aname!r}: "
                            f"checksum changed across {e.name}"
                            f"(uid {e.uid}) — the kernel (or a "
                            f"concurrent element) mutated a "
                            f"const-declared operand in place")
                if st.writer is None and not st.readers and st.version == 0:
                    self._state.pop(key, None)

    # ------------------------------------------------------------------
    def in_flight(self) -> Set[int]:
        with self._lock:
            uids: Set[int] = set()
            for st in self._state.values():
                if st.writer is not None:
                    uids.add(st.writer)
                uids.update(st.readers)
            return uids

    def stats(self) -> dict:
        with self._lock:
            return {"sanitizer_elements_checked": self.elements_checked,
                    "sanitizer_races_detected": self.races_detected,
                    "sanitizer_tracked_keys": len(self._state),
                    "sanitizer_digests": self.digests}
