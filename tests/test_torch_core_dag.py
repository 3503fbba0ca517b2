"""DAG dependency inference (Fig. 3) in the port, the suite of
``tests/test_core_dag.py`` run on ``repro_torch.core``.

Every case builds the same program in both packages and asserts, besides
the reference's own checks on the port, that the port infers the same
parents (by name), the same active flags and the same dependency-set
entries as ``repro.core``.  The property tests hold the port's edges, for
every generated program, equal to the reference's.
"""
import pytest
from _hypothesis_fallback import given, settings, st

from _torch_memory_check import _verify_torch_memory_accounting  # noqa: F401

import repro.core as J
import repro_torch.core as T


class FakeArray:
    def __init__(self, name):
        self.name = name


def ce(c, *args, name=""):
    return c.ComputationalElement(fn=None, args=tuple(args), name=name)


def view(arrays, *elements):
    """Package-free view of elements: name, parents by name, active flag,
    and the arrays left in the dependency set, by name."""
    names = {id(a): a.name for a in arrays}
    return [(e.name, sorted(p.name for p in e.parents), e.active,
             sorted(names[k] for k in e.dep_set)) for e in elements]


def both(run):
    """Runs one scenario on the port and on the reference; their views
    must be equal.  Returns the port's."""
    got, want = run(T), run(J)
    assert got == want
    return got


def test_raw_dependency():
    def run(c):
        dag, A = c.ComputationDAG(), FakeArray("A")
        k1 = ce(c, c.inout(A), name="K1")
        dag.add(k1)
        k2 = ce(c, c.const(A), name="K2")
        dag.add(k2)
        assert k2.parents == [k1]
        return view([A], k1, k2)
    both(run)


def test_fig3_reader_does_not_consume_writer_entry():
    """Fig. 3 case C: consecutive readers all depend on the writer."""
    def run(c):
        dag, A = c.ComputationDAG(), FakeArray("A")
        k1 = ce(c, c.inout(A), name="K1")
        dag.add(k1)
        k2 = ce(c, c.const(A), name="K2")
        dag.add(k2)
        k3 = ce(c, c.const(A), name="K3")
        dag.add(k3)
        assert k2.parents == [k1]
        assert k3.parents == [k1]
        assert id(A) in k1.dep_set
        return view([A], k1, k2, k3)
    both(run)


def test_fig3_war_antidependency_through_readers():
    """Fig. 3 case B: a writer after readers depends on the readers only."""
    def run(c):
        dag, A = c.ComputationDAG(), FakeArray("A")
        ks = [ce(c, c.inout(A), name="K1"), ce(c, c.const(A), name="K2"),
              ce(c, c.const(A), name="K3"), ce(c, c.inout(A), name="K4")]
        for k in ks:
            dag.add(k)
        k1, k2, k3, k4 = ks
        assert set(k4.parents) == {k2, k3}
        assert all(id(A) not in k.dep_set for k in (k1, k2, k3))
        return view([A], *ks)
    both(run)


def test_waw_dependency_without_readers():
    def run(c):
        dag, A = c.ComputationDAG(), FakeArray("A")
        k1, k2 = ce(c, c.out(A), name="K1"), ce(c, c.out(A), name="K2")
        dag.add(k1)
        dag.add(k2)
        assert k2.parents == [k1]
        return view([A], k1, k2)
    both(run)


def test_independent_kernels_share_readonly_input():
    """Two kernels reading the same const array are independent (§IV-A)."""
    def run(c):
        dag = c.ComputationDAG()
        X, Y, Z = FakeArray("X"), FakeArray("Y"), FakeArray("Z")
        k1 = ce(c, c.const(X), c.out(Y), name="K1")
        k2 = ce(c, c.const(X), c.out(Z), name="K2")
        dag.add(k1)
        dag.add(k2)
        assert k2.parents == []
        return view([X, Y, Z], k1, k2)
    both(run)


def test_empty_dep_set_retires_from_frontier():
    def run(c):
        dag, A = c.ComputationDAG(), FakeArray("A")
        k1, k2 = ce(c, c.inout(A), name="K1"), ce(c, c.inout(A), name="K2")
        dag.add(k1)
        dag.add(k2)
        assert not k1.active and k1 not in dag.frontier
        assert k2.active
        return view([A], k1, k2), [e.name for e in dag.frontier]
    both(run)


def test_retire_propagates_to_ancestors():
    def run(c):
        dag, A, B = c.ComputationDAG(), FakeArray("A"), FakeArray("B")
        k1 = ce(c, c.out(A), name="K1")
        k2 = ce(c, c.const(A), c.out(B), name="K2")
        dag.add(k1)
        dag.add(k2)
        dag.retire(k2)
        assert not k1.active and not k2.active
        return view([A, B], k1, k2), [e.name for e in dag.frontier]
    both(run)


def test_diamond():
    def run(c):
        dag = c.ComputationDAG()
        A, B, C = FakeArray("A"), FakeArray("B"), FakeArray("C")
        ks = [ce(c, c.out(A), name="K0"),
              ce(c, c.const(A), c.out(B), name="K1"),
              ce(c, c.const(A), c.out(C), name="K2"),
              ce(c, c.const(B), c.const(C), name="K3")]
        for k in ks:
            dag.add(k)
        k0, k1, k2, k3 = ks
        assert k1.parents == [k0] and k2.parents == [k0]
        assert set(k3.parents) == {k1, k2}
        return view([A, B, C], *ks)
    both(run)


def test_duplicate_array_in_args_uses_strongest_mode():
    def run(c):
        dag, A = c.ComputationDAG(), FakeArray("A")
        k1 = ce(c, c.out(A), name="K1")
        k2 = ce(c, c.const(A), c.inout(A), name="K2")
        k3 = ce(c, c.const(A), name="K3")
        for k in (k1, k2, k3):
            dag.add(k)
        assert k3.parents == [k2]
        return view([A], k1, k2, k3)
    both(run)


def test_war_after_retire_introduces_no_dependency():
    """A writer issued after the host retired the readers starts a fresh
    frontier: no stale WAR edges."""
    def run(c):
        dag, A = c.ComputationDAG(), FakeArray("A")
        k1, k2 = ce(c, c.inout(A), name="K1"), ce(c, c.const(A), name="K2")
        dag.add(k1)
        dag.add(k2)
        dag.retire(k2)
        k3 = ce(c, c.inout(A), name="K3")
        dag.add(k3)
        assert k3.parents == []
        assert k3.active and k3 in dag.frontier
        return view([A], k1, k2, k3)
    both(run)


def test_inout_self_dependency_is_impossible():
    def run(c):
        dag, A = c.ComputationDAG(), FakeArray("A")
        k1 = ce(c, c.const(A), c.inout(A), name="K1")
        dag.add(k1)
        assert k1 not in k1.parents and k1.parents == []
        k2 = ce(c, c.inout(A), c.const(A), name="K2")
        dag.add(k2)
        assert k2 not in k2.parents and k2.parents == [k1]
        return view([A], k1, k2)
    both(run)


def test_reader_then_writer_arg_order_on_same_element():
    """const(A) before out(A) on one element merges to the writing mode."""
    def run(c):
        dag, A = c.ComputationDAG(), FakeArray("A")
        k1 = ce(c, c.out(A), name="K1")
        dag.add(k1)
        rw = ce(c, c.const(A), c.out(A), name="RW")
        dag.add(rw)
        assert rw.parents == [k1]
        assert id(A) not in k1.dep_set
        k3 = ce(c, c.const(A), name="K3")
        dag.add(k3)
        assert k3.parents == [rw]
        return view([A], k1, rw, k3)
    both(run)


def test_dead_state_is_evicted_in_long_loops():
    """Per-array frontier state stays bounded when a loop touches a fresh
    array each time."""
    def run(c):
        dag = c.ComputationDAG()
        for i in range(5000):
            e = ce(c, c.inout(FakeArray(f"t{i}")), name=f"K{i}")
            dag.add(e)
            dag.retire(e)
        assert len(dag._state) < 1024
        return len(dag._state), dag.num_elements
    both(run)


def test_managed_keys_are_id_reuse_proof():
    """Managed handles key the frontier by a monotonic aid mapped into a
    namespace disjoint from id(); the port maps aids exactly as the
    reference does."""
    class Managed:
        def __init__(self, aid):
            self.aid = aid

    def run(c):
        a, b = Managed(0), Managed(1)
        assert c.dep_key(a) != c.dep_key(b)
        assert c.dep_key(a) < 0 and c.dep_key(b) < 0
        plain = FakeArray("p")
        assert c.dep_key(plain) == id(plain) >= 0
        return [c.dep_key(Managed(i)) for i in (0, 1, 7, 1 << 40)]
    both(run)


def test_snapshot_is_frozen_and_reflects_live_frontier():
    def run(c):
        dag, A, B = c.ComputationDAG(), FakeArray("A"), FakeArray("B")
        k1 = ce(c, c.inout(A), name="K1")
        k2 = ce(c, c.const(A), c.out(B), name="K2")
        dag.add(k1)
        dag.add(k2)
        snap = dag.snapshot()
        assert snap.writers[id(A)] is k1
        assert snap.readers[id(A)] == (k2,)
        with pytest.raises(TypeError):
            snap.writers[id(B)] = k1
        names = {id(A): "A", id(B): "B"}
        seen = ({names[k]: e.name for k, e in snap.writers.items()},
                {names[k]: [e.name for e in v]
                 for k, v in snap.readers.items()},
                sorted(e.name for e in snap.frontier))
        dag.retire_all()
        snap2 = dag.snapshot()
        assert not snap2.writers and not snap2.frontier
        assert snap.frontier
        return seen
    both(run)


# ----------------------------------------------------------------------
# Property tests: the same random programs through both packages.
# ----------------------------------------------------------------------

@st.composite
def programs(draw):
    n_arrays = draw(st.integers(2, 5))
    n_ops = draw(st.integers(1, 24))
    ops = []
    for _ in range(n_ops):
        n_args = draw(st.integers(1, min(3, n_arrays)))
        idxs = draw(st.lists(st.integers(0, n_arrays - 1),
                             min_size=n_args, max_size=n_args, unique=True))
        modes = [draw(st.sampled_from(["const", "inout", "out"]))
                 for _ in idxs]
        ops.append(list(zip(idxs, modes)))
    return n_arrays, ops


def build(c, prog):
    """The program on a fresh DAG of package ``c``: its elements, each
    with its spec, and the edges as (child, parent) indices."""
    n_arrays, ops = prog
    arrays = [FakeArray(f"a{i}") for i in range(n_arrays)]
    mode = {"const": c.const, "inout": c.inout, "out": c.out}
    dag = c.ComputationDAG()
    elements = []
    for spec in ops:
        e = c.ComputationalElement(
            fn=None, args=tuple(mode[m](arrays[i]) for i, m in spec))
        dag.add(e)
        elements.append((e, spec))
    index = {e.uid: i for i, (e, _) in enumerate(elements)}
    edges = [(index[e.uid], index[p.uid])
             for e, _ in elements for p in e.parents]
    return dag, arrays, elements, edges


def hazard(spec_a, spec_b):
    """True if b must be ordered after a (RAW/WAR/WAW on a shared array)."""
    return any(ia == ib and (ma != "const" or mb != "const")
               for ia, ma in spec_a for ib, mb in spec_b)


@settings(max_examples=200, deadline=None)
@given(programs())
def test_dependency_closure_matches_hazard_oracle(prog):
    """The closure of the port's edges contains every hazard pair, no
    direct edge joins two hazard-free elements, and the edges equal the
    reference's."""
    _, _, elements, edges = build(T, prog)
    assert edges == build(J, prog)[3]
    reach = {i: set() for i in range(len(elements))}
    for child, parent in edges:     # parents precede children
        reach[child] |= {parent} | reach[parent]
    for i, (_, sa) in enumerate(elements):
        for j in range(i + 1, len(elements)):
            sb = elements[j][1]
            if hazard(sa, sb):
                assert i in reach[j], f"missing hazard edge {i}->{j}"
            if (j, i) in edges:
                assert hazard(sa, sb), "spurious direct edge"


@settings(max_examples=60, deadline=None)
@given(programs())
def test_frontier_empty_after_retire_all(prog):
    """After retire_all nothing is active, the frontier is empty and a
    new element inherits no dependency, in both packages."""
    def run(c):
        dag, arrays, elements, edges = build(c, prog)
        dag.retire_all()
        assert not dag.frontier
        assert all(not e.active for e, _ in elements)
        probe = ce(c, *[c.inout(a) for a in arrays], name="probe")
        dag.add(probe)
        assert probe.parents == []
        return edges, dag.num_elements
    both(run)
