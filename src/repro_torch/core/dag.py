"""Incremental computation DAG + dependency sets (paper §IV-A, Fig. 3).

The DAG is built **at run time**: elements are appended as the host program
issues them, and only the *frontier* of active computations is consulted.
Dependency inference follows the paper's rules exactly:

* each element starts with a dependency set containing all its arguments;
* a **reader** (``const`` argument) depends on the *last writer* of that
  argument only — it never depends on other readers, and it does **not**
  consume the writer's dependency-set entry (Fig. 3 case C: "the dependency
  set of the parent kernel K1 is not updated");
* a **writer** depends on *all readers since the last write* (write-after-read
  anti-dependencies, Fig. 3 case B) — transitively covering the previous
  writer — or, if there are no readers, on the last writer directly
  (write-after-write).  The write *consumes* the entry: the argument is
  removed from the dependency sets of the previous writer and all readers
  ("all dependency sets will be updated");
* an element whose dependency set is empty can no longer introduce
  dependencies (§IV-B) and leaves the frontier;
* elements also leave the frontier when the host observes their completion
  (§IV-B: "active until the CPU requires their result or one of their
  children").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Dict, List, Mapping, Optional, Set, Tuple

from .element import AccessMode, ComputationalElement

# Prune a state's reader list once it grows past this many entries (a
# long-lived const array — e.g. serving weights — otherwise accumulates
# every retired reader ever issued).
_READER_PRUNE = 64


@dataclass
class _ArrayState:
    """Frontier bookkeeping for one managed array (keyed by handle id)."""

    last_writer: Optional[ComputationalElement] = None
    readers: List[ComputationalElement] = field(default_factory=list)


@dataclass(frozen=True)
class DAGSnapshot:
    """Immutable point-in-time view of the DAG frontier.

    ``writers``/``readers`` map argument keys to the *live* (active) elements
    that could still introduce a dependency on that array; retired elements
    are excluded.  A debugging/introspection surface (the replay fast path
    itself uses the targeted :meth:`ComputationDAG.live_deps`) — mutating
    the returned mappings raises."""

    writers: Mapping[int, ComputationalElement]
    readers: Mapping[int, Tuple[ComputationalElement, ...]]
    frontier: frozenset
    num_elements: int
    num_edges: int


class ComputationDAG:
    """Runtime-built dependency DAG over computational elements."""

    def __init__(self) -> None:
        self._state: Dict[int, _ArrayState] = {}
        self.frontier: Set[ComputationalElement] = set()
        self.num_elements = 0
        self.num_edges = 0
        # Amortized eviction threshold for dead per-array state (see _sweep).
        self._sweep_at = 256

    # ------------------------------------------------------------------
    def _eligible(self, e: Optional[ComputationalElement], key: int) -> bool:
        """An element can be a parent only while it is active *and* the
        argument is still in its dependency set."""
        return e is not None and e.active and key in e.dep_set

    def add(self, element: ComputationalElement) -> List[ComputationalElement]:
        """Insert ``element``, inferring parents.  Returns the parent list."""
        parents: List[ComputationalElement] = []
        seen: Set[int] = set()

        def add_parent(p: ComputationalElement) -> None:
            if p.uid not in seen and p is not element:
                seen.add(p.uid)
                parents.append(p)

        for key, mode in element.arg_modes():
            st = self._state.get(key)
            if st is not None:
                if mode.writes:
                    # WAR: depend on every active reader since the last
                    # write; they transitively cover the last writer
                    # (Fig. 3 case B).
                    live_readers = [r for r in st.readers
                                    if self._eligible(r, key)]
                    if live_readers:
                        for r in live_readers:
                            add_parent(r)
                    elif self._eligible(st.last_writer, key):
                        add_parent(st.last_writer)  # WAW / RAW for inout
                elif self._eligible(st.last_writer, key):
                    add_parent(st.last_writer)  # RAW; writer's set NOT updated
            self._transition(key, mode, element)

        element.parents = parents
        self._install(element)
        return parents

    # ------------------------------------------------------------------
    def _transition(self, key: int, mode: AccessMode,
                    element: ComputationalElement) -> None:
        """Per-array frontier transition shared by :meth:`add` and
        :meth:`adopt`: a write consumes the previous frontier's
        dependency-set entries for this argument ("all dependency sets will
        be updated") and becomes the last writer; a read joins the reader
        list (the writer's set is NOT updated, Fig. 3 case C)."""
        st = self._state.get(key)
        if st is None:
            st = self._state[key] = _ArrayState()
        if mode.writes:
            if st.last_writer is not None:
                st.last_writer.dep_set.discard(key)
                self._maybe_retire(st.last_writer)
            for r in st.readers:
                r.dep_set.discard(key)
                self._maybe_retire(r)
            st.last_writer = element
            st.readers = []
        else:
            if len(st.readers) >= _READER_PRUNE:
                st.readers = [r for r in st.readers if r.active]
            st.readers.append(element)

    def _install(self, element: ComputationalElement) -> None:
        """Common bookkeeping once parents are final: edges, counters,
        frontier membership and the dependency-set emptiness rule."""
        for p in element.parents:
            p.children.append(element)
        self.num_edges += len(element.parents)
        self.num_elements += 1
        element.active = True
        self.frontier.add(element)
        self._maybe_retire(element)

    # ------------------------------------------------------------------
    def adopt(self, element: ComputationalElement) -> None:
        """Fast-path insert for a replayed element with **pre-resolved**
        parents (``element.parents`` set by the caller from an
        :class:`~repro.core.capture.ExecutionPlan`).

        Per-array frontier state is transitioned exactly as :meth:`add` would
        (writes consume the previous frontier's dependency-set entries, reads
        join the reader list) but the O(frontier) parent inference is
        skipped — that is the capture/replay fast path."""
        for key, mode in element.arg_modes():
            self._transition(key, mode, element)
        self._install(element)

    def live_deps(self, key: int, writes: bool) -> List[ComputationalElement]:
        """Elements the host (or a replayed episode) must order against
        before accessing the array ``key``: for a write, every active reader
        since the last write (WAR) or, failing that, the live writer; for a
        read, the live writer only (RAW)."""
        st = self._state.get(key)
        if st is None:
            return []
        if writes:
            deps = [r for r in st.readers if self._eligible(r, key)]
            if not deps and st.last_writer is not None and st.last_writer.active:
                deps = [st.last_writer]
            return deps
        if st.last_writer is not None and st.last_writer.active:
            return [st.last_writer]
        return []

    def has_device_frontier(self, key: int, writes: bool = True) -> bool:
        """Whether any live *device-side* element could still order against
        the array — the one definition of "in-flight" shared by host-access
        re-validation and evict victim selection."""
        return any(not d.is_host for d in self.live_deps(key, writes))

    def snapshot(self) -> DAGSnapshot:
        """Frozen view of the live frontier state (read-only mappings)."""
        writers = {k: st.last_writer for k, st in self._state.items()
                   if st.last_writer is not None and st.last_writer.active}
        readers = {k: tuple(r for r in st.readers if r.active)
                   for k, st in self._state.items()
                   if any(r.active for r in st.readers)}
        return DAGSnapshot(writers=MappingProxyType(writers),
                           readers=MappingProxyType(readers),
                           frontier=frozenset(self.frontier),
                           num_elements=self.num_elements,
                           num_edges=self.num_edges)

    # ------------------------------------------------------------------
    def _sweep(self) -> None:
        """Amortized eviction of dead per-array state.

        Long-running loops (serving) create fresh arrays per episode; their
        ``_ArrayState`` entries outlive the arrays and — before aid-based
        keying — a recycled ``id()`` could even alias a dead entry.  Once the
        table grows past the high-water mark, drop every entry with no active
        element and prune retired readers/writers from the survivors.  The
        threshold doubles with the live size, so the cost is O(1) amortized."""
        if len(self._state) < self._sweep_at:
            return
        alive: Dict[int, _ArrayState] = {}
        for k, st in self._state.items():
            w = st.last_writer
            if w is not None and not w.active:
                w = None
            rs = [r for r in st.readers if r.active]
            if w is not None or rs:
                st.last_writer, st.readers = w, rs
                alive[k] = st
        self._state = alive
        self._sweep_at = max(256, 2 * len(alive))

    def _maybe_retire(self, e: ComputationalElement) -> None:
        """Drop an element from the frontier once its dependency set is empty
        — it can no longer be a parent (§IV-B)."""
        if e.active and not e.dep_set:
            e.active = False
            self.frontier.discard(e)

    def retire(self, e: ComputationalElement) -> None:
        """Host observed completion of ``e`` (and hence of its ancestors)."""
        stack = [e]
        while stack:
            cur = stack.pop()
            if not cur.active:
                continue
            cur.active = False
            self.frontier.discard(cur)
            stack.extend(cur.parents)
        self._sweep()

    def retire_all(self) -> None:
        for e in list(self.frontier):
            e.active = False
        self.frontier.clear()
        # A full barrier retires *everything*: sweep unconditionally so no
        # dead ``_ArrayState`` pins retired elements (and through their args,
        # the arrays — a tier-spilled block must become collectable here for
        # its GC finalizer to release the spool payload).
        self._sweep_at = 0
        self._sweep()

    # ------------------------------------------------------------------
    def validate(self) -> List[str]:
        """Structural invariant check used by ``repro.analysis``: returns
        human-readable problems (empty = consistent).

        Invariants: frontier membership equals the ``active`` flag with a
        non-empty dependency set; dependency sets never grow beyond the
        element's own argument keys (writes only ever *consume* entries);
        per-array frontier state points only at elements that could still
        legally become parents under :meth:`_eligible`."""
        problems: List[str] = []
        for e in self.frontier:
            if not e.active:
                problems.append(
                    f"retired element {e.name}(uid {e.uid}) still on the "
                    f"frontier")
            elif not e.dep_set:
                problems.append(
                    f"frontier element {e.name}(uid {e.uid}) has an empty "
                    f"dependency set — §IV-B says it must retire")
        for key, st in self._state.items():
            for r in st.readers:
                if r.active and key not in r.dep_set:
                    problems.append(
                        f"active reader {r.name}(uid {r.uid}) listed for "
                        f"key {key} without a dependency-set entry")
        for e in self.frontier:
            keys = {a.key for a in e.args}
            extra = set(e.dep_set) - keys
            if extra:
                problems.append(
                    f"element {e.name}(uid {e.uid}) tracks dependency keys "
                    f"{sorted(extra)} outside its argument list")
        return problems

    # ------------------------------------------------------------------
    def ancestors(self, e: ComputationalElement) -> Set[ComputationalElement]:
        out: Set[ComputationalElement] = set()
        stack = list(e.parents)
        while stack:
            cur = stack.pop()
            if cur not in out:
                out.add(cur)
                stack.extend(cur.parents)
        return out

    def writers_of(self, key: int) -> Optional[ComputationalElement]:
        st = self._state.get(key)
        return st.last_writer if st else None

    def readers_of(self, key: int) -> List[ComputationalElement]:
        st = self._state.get(key)
        return list(st.readers) if st else []
