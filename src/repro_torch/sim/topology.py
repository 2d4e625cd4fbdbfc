"""Hierarchical cluster topology: nodes -> racks -> sites.

The flow-level network model (sim/network.py) prices every transfer over a
set of links.  A flat cluster gives each node an uplink/downlink pair and
nothing else, so any two nodes enjoy full NIC-to-NIC bandwidth -- the one
regime where workflow-aware data movement matters least.  This module adds
the shared infrastructure real clusters contend on:

* ``("rku", r)`` / ``("rkd", r)`` -- rack r's uplink/downlink into the site
  fabric.  Capacity ``rack_size * net_bw / oversubscription``: with
  oversubscription > 1 the rack's nodes cannot all burst off-rack at once.
* ``("core", s)``  -- site s's shared core fabric, crossed by every
  inter-rack byte of the site (in either direction).  Capacity
  ``racks_per_site * rack_uplink / core_oversubscription``.
* ``("wanu", s)`` / ``("wand", s)`` -- site s's WAN egress/ingress.  An
  inter-site transfer crosses the source site's egress and the destination
  site's ingress (plus both cores), so WAN paths are the longest and the
  most contended.

Path construction: a transfer src -> dst already crosses ``("up", src)``
and ``("down", dst)``; :meth:`Topology.expand` splices the hierarchy links
between every such adjacent pair:

    same rack:   up(src) . down(dst)                        (unchanged)
    same site:   up . rku(r_src) . core(s) . rkd(r_dst) . down
    inter-site:  up . rku . core(s_src) . wanu(s_src)
                    . wand(s_dst) . core(s_dst) . rkd . down

A *flat* spec (``rack_size`` 0, or >= the node count: a single rack, no
oversubscription possible) inserts no links anywhere -- every pair is
same-rack -- so flat-topology runs are bit-identical to the pre-topology
engine by construction, not by tolerance (golden-tested in
tests/test_topology.py).  The engine therefore drops the topology object
entirely when ``nonuniform`` is False and no code path changes.

Locality cost model: ``distance`` classifies a node pair as local (0) /
intra-rack (1) / intra-site (2) / WAN (3) and ``weight`` maps the class to
a byte-cost multiplier (``w_rack``/``w_site``/``w_wan``).  The DPS prices
COP transfers with it and prefers minimum-distance sources; the scheduler's
step-2 candidate order uses the weighted missing-byte cost (see DESIGN.md
"Hierarchical topology").

This is the reference's ``repro/sim/topology.py``.
"""
from __future__ import annotations

import dataclasses

from .network import LinkId


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Declarative topology shape; ``SimConfig.topology`` carries one.

    ``rack_size`` <= 0 (or >= the node count) collapses to a single rack:
    the flat default.  ``racks_per_site`` <= 0 collapses all racks into one
    site (a 2-level topology).  ``oversubscription`` divides the rack
    uplink/downlink capacity; ``core_oversubscription`` the site core.
    ``wan_bw`` is the per-site WAN egress/ingress capacity in bytes/s
    (``None`` = one rack-uplink's worth).  ``w_rack``/``w_site``/``w_wan``
    are the scheduler's byte-cost multipliers per locality tier."""

    rack_size: int = 0
    racks_per_site: int = 0
    oversubscription: float = 1.0
    core_oversubscription: float = 1.0
    wan_bw: float | None = None
    w_rack: float = 1.0
    w_site: float = 4.0
    w_wan: float = 16.0

    def __post_init__(self) -> None:
        if self.oversubscription <= 0 or self.core_oversubscription <= 0:
            raise ValueError("oversubscription factors must be positive")
        if self.wan_bw is not None and self.wan_bw <= 0:
            raise ValueError("wan_bw must be positive")


class Topology:
    """Runtime topology bound to a cluster size and per-node NIC speed.

    Node -> rack -> site assignment is positional (``node // rack_size``),
    so it extends deterministically to elastic-join nodes and the NFS
    server node without any registration step; :meth:`ensure_node` lazily
    materialises the rack/site link capacities a node's flows may cross.
    """

    # locality tier names, index == distance class (tier 0 never carries
    # network bytes; it is the disk-only class)
    TIERS = ("local", "rack", "site", "wan")

    def __init__(self, spec: TopologySpec, n_nodes: int,
                 net_bw: float) -> None:
        self.spec = spec
        self.n_nodes = n_nodes
        self.net_bw = net_bw
        rs = spec.rack_size
        self.rack_size = rs if 0 < rs < n_nodes else 0   # 0 => single rack
        rps = spec.racks_per_site
        self.racks_per_site = rps if rps > 0 else 0      # 0 => single site
        # a single rack has no shared infrastructure to contend on: the
        # engine treats the topology as absent (bit-identical runs)
        self.nonuniform = self.rack_size > 0
        self.rack_up_bw = ((self.rack_size or n_nodes) * net_bw
                           / spec.oversubscription)
        rp = self.racks_per_site
        self.core_bw = ((rp if rp else max(self.n_racks, 1)) * self.rack_up_bw
                        / spec.core_oversubscription)
        self.wan_bw = spec.wan_bw if spec.wan_bw is not None \
            else self.rack_up_bw
        # (src rack, dst rack) -> hierarchy-path segment (see `path`)
        self._path_cache: dict[tuple[int, int], tuple[LinkId, ...]] = {}

    # ------------------------------------------------------------ hierarchy
    @property
    def n_racks(self) -> int:
        if self.rack_size <= 0:
            return 1
        return -(-self.n_nodes // self.rack_size)

    @property
    def n_sites(self) -> int:
        if self.racks_per_site <= 0:
            return 1
        return -(-self.n_racks // self.racks_per_site)

    def rack_of(self, node: int) -> int:
        return node // self.rack_size if self.rack_size > 0 else 0

    def site_of_rack(self, rack: int) -> int:
        return rack // self.racks_per_site if self.racks_per_site > 0 else 0

    def site_of(self, node: int) -> int:
        return self.site_of_rack(self.rack_of(node))

    def distance(self, a: int, b: int) -> int:
        """0 same node, 1 same rack, 2 same site, 3 inter-site (WAN)."""
        if a == b:
            return 0
        ra, rb = self.rack_of(a), self.rack_of(b)
        if ra == rb:
            return 1
        if self.site_of_rack(ra) == self.site_of_rack(rb):
            return 2
        return 3

    def weight(self, a: int, b: int) -> float:
        """Byte-cost multiplier of moving data a -> b (0.0 when a == b)."""
        d = self.distance(a, b)
        if d == 0:
            return 0.0
        if d == 1:
            return self.spec.w_rack
        if d == 2:
            return self.spec.w_site
        return self.spec.w_wan

    @property
    def max_weight(self) -> float:
        """Cost multiplier charged when a file has no replica anywhere
        admissible (worst-case placement assumption)."""
        return self.spec.w_wan

    # ----------------------------------------------------------------- links
    def path(self, src: int, dst: int) -> tuple[LinkId, ...]:
        """Hierarchy links between ``("up", src)`` and ``("down", dst)``.

        Memoized per (src rack, dst rack) pair -- the segment is a pure
        function of the two rack coordinates, but ``expand`` calls this
        once per up->down hop of every flow the engine builds, so without
        the cache the splice tuple is re-derived on every ``_add_flow``.
        The cache is unbounded but tiny: at most ``n_racks ** 2`` entries
        (elastic joins only add racks).  ``_path_uncached`` is the retained
        oracle the cache is asserted against in tests/test_topology.py."""
        key = (self.rack_of(src), self.rack_of(dst))
        hit = self._path_cache.get(key)
        if hit is None:
            hit = self._path_uncached(src, dst)
            self._path_cache[key] = hit
        return hit

    def _path_uncached(self, src: int, dst: int) -> tuple[LinkId, ...]:
        r_src, r_dst = self.rack_of(src), self.rack_of(dst)
        if r_src == r_dst:
            return ()
        s_src = self.site_of_rack(r_src)
        s_dst = self.site_of_rack(r_dst)
        if s_src == s_dst:
            return (("rku", r_src), ("core", s_src), ("rkd", r_dst))
        return (("rku", r_src), ("core", s_src), ("wanu", s_src),
                ("wand", s_dst), ("core", s_dst), ("rkd", r_dst))

    def expand(self, links: tuple[LinkId, ...]) -> tuple[LinkId, ...]:
        """Splice hierarchy links into every adjacent up->down hop.

        All flow paths the engine and DFS models build place a transfer's
        ``("up", src)`` immediately before its ``("down", dst)``, so this
        is a complete (and order-preserving) path rewrite."""
        out: list[LinkId] = []
        prev: LinkId | None = None
        for l in links:
            if prev is not None and prev[0] == "up" and l[0] == "down":
                out.extend(self.path(prev[1], l[1]))
            out.append(l)
            prev = l
        return tuple(out)

    def tier(self, links: tuple[LinkId, ...]) -> str:
        """Traffic tier of an (expanded) flow path, for per-tier byte
        accounting: the deepest shared layer the flow crosses."""
        deepest = 0
        for kind, _ in links:
            if kind == "wanu":
                return "wan"
            if kind == "core":
                deepest = max(deepest, 2)
            elif kind == "up":
                deepest = max(deepest, 1)
        return self.TIERS[deepest]

    def ensure_node(self, node: int,
                    capacities: dict[LinkId, float]) -> None:
        """Materialise the rack/site link capacities ``node``'s flows may
        cross (idempotent; called for initial nodes, the NFS server, and
        every elastic join)."""
        if not self.nonuniform:
            return
        r = self.rack_of(node)
        s = self.site_of_rack(r)
        capacities.setdefault(("rku", r), self.rack_up_bw)
        capacities.setdefault(("rkd", r), self.rack_up_bw)
        capacities.setdefault(("core", s), self.core_bw)
        if self.racks_per_site > 0:
            # multi-site capable: register the WAN pair even while every
            # live node still sits in one site -- an elastic join may land
            # in a later site and paths must find both endpoints' links
            capacities.setdefault(("wanu", s), self.wan_bw)
            capacities.setdefault(("wand", s), self.wan_bw)
