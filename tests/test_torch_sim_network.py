"""The port's flow network (``repro_torch/sim/network.py``) against the JAX
package's ``repro/sim/network.py`` on the CPU: the scan fill, the heap
fill and the dense fill rate for rate, and both flow managers through
seeded add / remove / node-fail / join / advance streams, flat and on
hierarchical topologies (after tests/test_flow_fill.py and
tests/test_topology.py).  The dense fill runs at small sizes with the
port's ``_VEC_MIN_MEMBERS`` patched to 0, as tests/test_topology.py does to
the reference's.  Every seed is fixed; nothing is drawn by hypothesis.

Where the dense fill could lose bit-identity on a card, a case here pins
it: several frozen memberships of one link in one round (the residual's
repeated ``index_add_``), equal shares (the tie-break on each link's first
membership, a ``scatter_reduce_`` "amin"), and a zero capacity."""
from __future__ import annotations

import math
import random

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.sim as R  # noqa: E402
import repro.sim.network as RN  # noqa: E402
import repro_torch.sim as P  # noqa: E402
import repro_torch.sim.network as PN  # noqa: E402

CPU = "cpu"


def _random_instance(rng):
    """tests/test_flow_fill.py::_random_instance: shared links, zero-byte
    flows and capacity ties."""
    n_nodes = rng.randint(1, 10)
    caps = {}
    for n in range(n_nodes):
        for kind in ("up", "down", "dr", "dw"):
            caps[(kind, n)] = rng.choice([1.0, 2.0, 5.0, 100.0])
    link_ids = list(caps)
    flows = []
    for i in range(rng.randint(0, 25)):
        links = tuple(rng.sample(link_ids, rng.randint(1, 4)))
        flows.append((i, links, rng.uniform(0.0, 1e6)))
    return caps, flows


def _rates(fill, flow_cls, caps, flows):
    fl = [flow_cls(i, links, nbytes, tag=i) for i, links, nbytes in flows]
    fill(fl, caps)
    return [f.rate for f in fl]


@pytest.mark.parametrize("seed", range(12))
def test_scan_and_heap_fills_equal_the_reference(seed):
    caps, flows = _random_instance(random.Random(seed))
    want = _rates(RN._progressive_fill, RN.Flow, caps, flows)
    assert _rates(PN._progressive_fill, PN.Flow, caps, flows) == want
    assert _rates(PN._heap_fill, PN.Flow, caps, flows) == want
    assert _rates(RN._heap_fill, RN.Flow, caps, flows) == want


def _random_topology(pkg, rng, n_nodes):
    """tests/test_topology.py::_random_topology for either package."""
    spec = pkg.TopologySpec(
        rack_size=rng.randint(1, max(2, n_nodes // 2)),
        racks_per_site=rng.randint(0, 3),
        oversubscription=rng.choice([1.0, 2.0, 4.0, 8.0]),
        core_oversubscription=rng.choice([1.0, 2.0]),
        wan_bw=rng.choice([None, 37.0]))
    return pkg.Topology(spec, n_nodes, 100.0)


def _managers(caps, dense):
    """The port's heap manager (dense path forced when ``dense``), the
    reference's heap manager (its numpy dense path forced alike) and the
    reference's scan manager, on one link table."""
    fms = {"port": P.FlowManager(dict(caps), fill="heap", device=CPU),
           "ref": R.FlowManager(dict(caps), fill="heap"),
           "scan": R.FlowManager(dict(caps), fill="scan")}
    if dense:
        fms["port"]._has_shared = True
        fms["ref"]._has_shared = True
    return fms


def _assert_same(fms):
    want = fms["scan"]
    for name, fm in fms.items():
        assert set(fm.flows) == set(want.flows), name
        for fid, f in want.flows.items():
            g = fm.flows[fid]
            assert repr(g.rate) == repr(f.rate), (name, fid)
            assert type(g.rate) is float
            assert repr(g.remaining) == repr(f.remaining), (name, fid)
        dt, _ = fm.next_completion()
        assert repr(dt) == repr(want.next_completion()[0]), name


def _stream(rng, fms, n_nodes, new_links, n_ops=50):
    """tests/test_flow_fill.py::test_fill_stream_parity_add_remove_fail's
    op mix on every manager in ``fms`` at once."""
    nodes = list(range(n_nodes))
    live: list[int] = []
    next_node = n_nodes
    done = {name: [] for name in fms}
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.5 or not live:
            links = new_links(rng, nodes)
            if links is not None:
                nbytes = rng.choice([0.0, 1.0, 500.0, 12_345.6789,
                                     rng.uniform(1.0, 1e6)])
                ids = {fm.add(links, nbytes, "t").id for fm in fms.values()}
                assert len(ids) == 1
                live.append(ids.pop())
        elif op < 0.62:
            fid = live.pop(rng.randrange(len(live)))
            for fm in fms.values():
                fm.remove(fid)
        elif op < 0.70 and len(nodes) > 2:
            node = rng.choice(nodes)
            nodes.remove(node)
            on = {name: fm.flows_on_node(node) for name, fm in fms.items()}
            assert on["port"] == on["ref"] == on["scan"]
            for fid in on["scan"]:
                assert len({repr(fm.unsent(fid)) for fm in fms.values()}) == 1
                for fm in fms.values():
                    fm.remove(fid)
                if fid in live:
                    live.remove(fid)
        elif op < 0.76:
            for fm in fms.values():
                for kind, bw in (("up", 100.0), ("down", 100.0),
                                 ("dr", 537.0), ("dw", 402.0)):
                    fm.capacities[(kind, next_node)] = bw
            nodes.append(next_node)
            next_node += 1
        else:
            for fm in fms.values():
                fm.recompute()
            dt, _ = fms["scan"].next_completion()
            if dt != math.inf:
                step = dt * rng.choice([0.5, 1.0, 1.0])
                for name, fm in fms.items():
                    done[name].extend(f.id for f in fm.advance(step))
                assert done["port"] == done["ref"] == done["scan"]
                live = [i for i in live if i in fms["scan"].flows]
        for fm in fms.values():
            fm.recompute()
        _assert_same(fms)
    while fms["scan"].flows:
        dt, _ = fms["scan"].next_completion()
        if dt == math.inf:
            break
        for name, fm in fms.items():
            done[name].extend(f.id for f in fm.advance(dt))
            fm.recompute()
        _assert_same(fms)
    assert done["port"] == done["ref"] == done["scan"]


@pytest.mark.parametrize("seed", range(8))
def test_flat_manager_streams_equal_the_reference(seed):
    rng = random.Random(3000 + seed)
    n_nodes = rng.randint(2, 6)
    caps = R.build_links(n_nodes, 100.0, 537.0, 402.0)
    assert P.build_links(n_nodes, 100.0, 537.0, 402.0) == caps
    fms = _managers(caps, dense=False)

    def new_links(rng, nodes):
        if len(nodes) < 2:
            return None
        src, dst = rng.sample(nodes, 2)
        return (("dr", src), ("up", src), ("down", dst), ("dw", dst))

    _stream(rng, fms, n_nodes, new_links)
    assert fms["port"].dense_fills == 0
    assert fms["port"].health() == fms["ref"].health()


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_topology_manager_streams_equal_the_reference(seed, dense,
                                                      monkeypatch):
    """Path-constrained flows; with ``dense`` every recompute takes the
    dense fill, the port's on torch tensors, the reference's on numpy."""
    if dense:
        monkeypatch.setattr(PN, "_VEC_MIN_MEMBERS", 0)
        monkeypatch.setattr(RN, "_VEC_MIN_MEMBERS", 0)
    rng = random.Random(7000 + seed)
    n_nodes = rng.randint(4, 12)
    state = rng.getstate()
    topo = _random_topology(R, rng, n_nodes)
    rng.setstate(state)
    ptopo = _random_topology(P, rng, n_nodes)
    caps = R.build_links(n_nodes, 100.0, 200.0, 150.0,
                         topology=topo if topo.nonuniform else None)
    assert P.build_links(n_nodes, 100.0, 200.0, 150.0,
                         topology=ptopo if ptopo.nonuniform else None) == caps
    fms = _managers(caps, dense)

    def new_links(rng, nodes):
        # joined nodes carry no hierarchy links in this table
        pool = [n for n in nodes if n < n_nodes]
        if len(pool) < 2:
            return None
        src, dst = rng.sample(pool, 2)
        return topo.expand((("dr", src), ("up", src), ("down", dst),
                            ("dw", dst)))

    _stream(rng, fms, n_nodes, new_links)
    if dense:
        assert fms["port"].dense_fills == fms["port"].recomputes > 0
    else:
        assert fms["port"].dense_fills == 0
    assert fms["port"].health() == fms["ref"].health()


def _dense_vs_scan(caps, paths, monkeypatch):
    """One recompute of ``paths`` (links, bytes) through the port's dense
    fill, against the reference's scan fill and dense fill."""
    monkeypatch.setattr(PN, "_VEC_MIN_MEMBERS", 0)
    monkeypatch.setattr(RN, "_VEC_MIN_MEMBERS", 0)
    fms = _managers(caps, dense=True)
    for links, nbytes in paths:
        for fm in fms.values():
            fm.add(links, nbytes, "t")
    for fm in fms.values():
        fm.recompute()
    assert fms["port"].dense_fills == 1
    _assert_same(fms)
    return [fms["port"].flows[i].rate for i in sorted(fms["port"].flows)]


def test_dense_fill_repeated_memberships_of_one_link(monkeypatch):
    """Many flows on one rack uplink and core freeze in one round: each
    link's residual takes one subtraction per frozen membership, in any
    order the same bits (0.1 is not a power of two, so a product or a sum
    of the shares first would differ)."""
    topo = P.Topology(P.TopologySpec(rack_size=2, racks_per_site=2,
                                     oversubscription=3.0), 8, 0.1)
    caps = P.build_links(8, 0.1, 0.7, 0.3, topology=topo)
    paths = []
    for k in range(23):
        src, dst = k % 2, 2 + (k % 6)
        paths.append((topo.expand((("dr", src), ("up", src), ("down", dst),
                                   ("dw", dst))), 1e6 + k))
    paths += [(topo.expand((("up", 4), ("down", 7))), 5e5)] * 5
    rates = _dense_vs_scan(caps, paths, monkeypatch)
    assert len(set(rates)) > 1


def test_dense_fill_equal_shares_take_the_first_link(monkeypatch):
    """Disjoint links with equal shares: the bottleneck is the link whose
    first membership comes first, as the scan's first-strictly-smaller
    rule picks it (tests/test_flow_fill.py's tie case, densely)."""
    caps = {("up", 0): 10.0, ("down", 1): 10.0, ("up", 2): 10.0,
            ("down", 3): 10.0, ("core", 0): 30.0}
    paths = [((("up", 0), ("core", 0), ("down", 1)), 100.0),
             ((("up", 2), ("core", 0), ("down", 3)), 100.0),
             ((("up", 0), ("core", 0), ("down", 1)), 100.0),
             ((("up", 2), ("down", 3)), 100.0)]
    assert _dense_vs_scan(caps, paths, monkeypatch) == [5.0, 5.0, 5.0, 5.0]


def test_dense_fill_zero_capacity_and_zero_bytes(monkeypatch):
    caps = {("up", 0): 0.0, ("down", 1): 5.0, ("rku", 0): 3.0}
    paths = [((("up", 0), ("rku", 0), ("down", 1)), 10.0),
             ((("rku", 0), ("down", 1)), 0.0),
             ((("rku", 0), ("down", 1)), 7.0)]
    assert _dense_vs_scan(caps, paths, monkeypatch) == [0.0, 1.5, 1.5]


def test_dense_fill_tensors_lie_on_the_managers_device(monkeypatch):
    monkeypatch.setattr(PN, "_VEC_MIN_MEMBERS", 0)
    fm = P.FlowManager({("core", 0): 4.0, ("up", 1): 3.0}, device=CPU)
    fm.add((("up", 1), ("core", 0)), 10.0, "a")
    fm.add((("core", 0),), 10.0, "b")
    assert fm.flows[0].slots == (0, 1) and fm.flows[1].slots == (1,)
    fm.recompute()
    assert fm.dense_fills == 1 and fm._caps_t.device.type == "cpu"
    assert fm._caps_t.dtype == torch.float64
    assert [fm.flows[i].rate for i in (0, 1)] == [2.0, 2.0]


def test_reference_flow_manager_equals_the_reference():
    rng = random.Random(11)
    caps = R.build_links(5, 100.0, 537.0, 402.0)
    fp, fr = P.ReferenceFlowManager(dict(caps)), R.ReferenceFlowManager(
        dict(caps))
    for _ in range(60):
        if rng.random() < 0.6 or not fr.flows:
            src, dst = rng.sample(range(5), 2)
            links = (("dr", src), ("up", src), ("down", dst), ("dw", dst))
            n = rng.uniform(0.0, 1e4)
            assert fp.add(links, n, "t").id == fr.add(links, n, "t").id
        else:
            fid = rng.choice(sorted(fr.flows))
            fp.remove(fid)
            fr.remove(fid)
        fp.recompute()
        fr.recompute()
        dp, fdp = fp.next_completion()
        dr, fdr = fr.next_completion()
        assert repr(dp) == repr(dr)
        if dr != math.inf and rng.random() < 0.5:
            assert [f.id for f in fp.advance(dr)] == \
                [f.id for f in fr.advance(dr)]
        assert {i: (f.rate, f.remaining) for i, f in fp.flows.items()} == \
            {i: (f.rate, f.remaining) for i, f in fr.flows.items()}
        assert fp.flows_on_node(2) == fr.flows_on_node(2)


def test_flow_manager_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.FlowManager({("up", 0): 1.0})
    with pytest.raises(ValueError, match="unknown fill"):
        P.FlowManager({("up", 0): 1.0}, fill="nope", device=CPU)
