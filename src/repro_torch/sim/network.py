"""Flow-level network + storage model with max-min fair bandwidth sharing.

Every shared resource is a *link* with a byte/s capacity:

    ("up", n)   -- node n NIC egress          ("down", n) -- NIC ingress
    ("dr", n)   -- node n disk read           ("dw", n)   -- disk write

and, under a hierarchical topology (sim/topology.py), the shared
infrastructure layers those NIC hops traverse:

    ("rku", r) / ("rkd", r)   -- rack r uplink/downlink (oversubscribable)
    ("core", s)               -- site s shared core fabric
    ("wanu", s) / ("wand", s) -- site s WAN egress/ingress

A *flow* is a byte stream traversing a set of links (e.g. a COP transfer
src->dst uses [dr src, up src, down dst, dw dst]; with a topology the
engine splices the rack/core/WAN path links between the up and down hop).
Both fills below are agnostic to path length -- per-link bookkeeping is
keyed by LinkId, so path-constrained flows share rack/core links exactly
like node links.  Rates follow the classic
progressive-filling max-min fair allocation: the most contended link fixes
the fair share of its flows, capacities shrink, repeat.  This captures the
paper's central network effects -- the NFS single-link saturation, COP
bandwidth splitting under c_node, and disk-vs-network asymmetry -- without
packet-level detail (see DESIGN.md "Flow-level network model").

Incremental engine (DESIGN.md "Heap-driven flow simulation"):

``FlowManager`` keeps its own virtual clock and settles each flow's byte
count lazily -- a flow's remaining bytes are only materialised when its rate
changes.  Completions come from a min-heap keyed by the virtual-time ETA;
each recompute bumps the affected flows' *rate epoch* so stale heap entries
are recognised and discarded on pop.  ``recompute`` re-runs progressive
filling only over the connected component of links reachable from flows
added/removed since the last call: max-min allocations of link-disjoint
components are independent, so untouched flows keep both their rate and
their heap entries.  ``ReferenceFlowManager`` below retains the original
scan-everything implementation as the equivalence-test oracle.

Within one fill, bottleneck selection itself is incremental (DESIGN.md
"Incremental rate allocation"): ``_heap_fill`` replaces the reference
``_progressive_fill``'s per-round scan over every link (O(rounds x links)
per recompute, near-global under congestion) with a share-ordered heap over
links and per-link version counters for lazy invalidation, so a recompute
costs O((F_comp + rounds) log L) while producing bit-identical rates (the
heap key carries the link's first-flow insertion index, which is exactly
the reference's tie-break).  Hierarchical topologies add a third regime:
shared rack/core links weld most flows into one component and collapse the
fill into few rounds with huge freeze batches, where the link heap's
per-freeze bookkeeping stops amortising -- once a shared hierarchy link has
been seen and a component exceeds ``_VEC_MIN_MEMBERS`` link memberships the
heap path switches to ``FlowManager._fill_vectorized``, a
dense-round fill over per-flow link slots with the same (share, insertion
order) bottleneck rule.  The scan fill is retained as the ``fill="scan"``
reference path (``SimConfig.flow_fill``) -- it *is* the pre-heap engine --
and all paths are property- and golden-tested against each other.

This is the reference's ``repro/sim/network.py`` with one change: the
dense fill's residual capacities, counts, shares and membership arrays are
float64 / int64 torch tensors on the ``FlowManager``'s device (CUDA unless
the caller names another) instead of numpy arrays, bit for bit the scan
fill's rates.  The heap fill and the scan fill stay pure Python.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Hashable

import torch

from ..models.common import require_device

LinkId = tuple[str, int]

# < 1 byte left => complete (sub-byte remainders are float dust, not data)
_DUST = 0.5

# ETA-heap compaction thresholds: rebuild a heap once it holds more than
# _COMPACT_FACTOR entries per live flow (and is past the _COMPACT_MIN floor
# where compaction cost would exceed the garbage).  Stale entries otherwise
# accumulate until popped -- long-lived flows rescheduled many times (rate
# epoch bumps) can grow the heaps without bound in very long simulations.
_COMPACT_MIN = 64
_COMPACT_FACTOR = 4


@dataclasses.dataclass
class Flow:
    id: int
    links: tuple[LinkId, ...]
    remaining: float               # bytes, as of `settled` virtual time
    tag: Hashable                  # owner handle (task phase / COP)
    rate: float = 0.0
    settled: float = 0.0           # virtual time `remaining` refers to
    epoch: int = 0                 # bumped whenever `rate` is reassigned
    # link-slot ids for the dense fill (FlowManager.add), kept on the host;
    # None under the pure-python paths / ReferenceFlowManager
    slots: tuple[int, ...] | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def eta(self) -> float:
        if self.remaining <= _DUST:
            return 0.0
        if self.rate <= 0:
            return math.inf
        return self.remaining / self.rate


def _progressive_fill(flows: list[Flow],
                      capacities: dict[LinkId, float]) -> None:
    """Classic progressive filling over ``flows``; sets ``f.rate``.

    Bottleneck selection order matches the reference implementation: the
    first strictly-smaller fair share wins, links iterated in first-flow
    insertion order, so allocations are bit-identical to a full recompute.
    """
    remaining_cap: dict[LinkId, float] = {}
    link_flows: dict[LinkId, set[int]] = {}
    for f in flows:
        for l in f.links:
            link_flows.setdefault(l, set()).add(f.id)
            remaining_cap.setdefault(l, capacities[l])
    unfrozen = {f.id for f in flows}
    by_id = {f.id: f for f in flows}
    while unfrozen:
        best_share = math.inf
        best_link: LinkId | None = None
        for l, fids in link_flows.items():
            n = len(fids)
            if n == 0:
                continue
            share = remaining_cap[l] / n
            if share < best_share:
                best_share = share
                best_link = l
        if best_link is None:
            break
        for fid in list(link_flows[best_link]):
            f = by_id[fid]
            f.rate = best_share
            unfrozen.discard(fid)
            for l in f.links:
                link_flows[l].discard(fid)
                remaining_cap[l] -= best_share
                if remaining_cap[l] < 0:
                    remaining_cap[l] = 0.0
        link_flows[best_link].clear()


def _heap_fill(flows: list[Flow], capacities: dict[LinkId, float]) -> None:
    """Progressive filling with incremental bottleneck selection.

    Rate-identical to :func:`_progressive_fill` (property- and
    equivalence-tested): the same per-link residual capacities evolve
    through the same arithmetic, and each round's bottleneck is the link
    with the minimal fair share, ties broken by first-flow insertion order
    -- exactly the reference's first-strictly-smaller-wins scan.  Instead
    of rescanning every link per round (O(rounds x links)), links live in a
    min-heap keyed by ``(share, insertion index)``; entries are lazily
    invalidated through a per-link version counter and only the links a
    frozen flow crosses are re-keyed, so a fill costs
    O((flows + rounds) log links).

    Identity argument, in brief: a link's share only changes when one of
    its flows is frozen (capacity and flow count are both touched then and
    only then), so an un-popped heap entry with a current version carries
    the share the reference scan would recompute; the subtractions applied
    to a link within one round all use the same ``best_share`` value, so
    their (set-iteration) order cannot change the float result; and the
    clamp at zero commutes with equal-value subtraction the same way it
    does in the reference.
    """
    remaining_cap: dict[LinkId, float] = {}
    link_flows: dict[LinkId, set[int]] = {}
    link_order: dict[LinkId, int] = {}      # first-flow insertion index
    links_by_order: list[LinkId] = []
    for f in flows:
        for l in f.links:
            if l not in link_flows:
                link_flows[l] = set()
                remaining_cap[l] = capacities[l]
                link_order[l] = len(links_by_order)
                links_by_order.append(l)
            link_flows[l].add(f.id)
    by_id = {f.id: f for f in flows}
    version = dict.fromkeys(link_flows, 0)
    # heap entries: (share, insertion index, version); the index is unique
    # per link so the version is never reached by tuple comparison, and
    # equal shares resolve to the earliest-inserted link like the scan does
    heap = [(remaining_cap[l] / len(link_flows[l]), link_order[l], 0)
            for l in links_by_order]
    heapq.heapify(heap)
    n_unfrozen = sum(1 for f in flows if f.links)
    touched: set[LinkId] = set()
    while n_unfrozen and heap:
        best_share, order, ver = heapq.heappop(heap)
        best_link = links_by_order[order]
        if ver != version[best_link]:
            continue                        # stale: link was re-keyed
        fids = link_flows[best_link]
        if not fids:
            continue
        touched.clear()
        for fid in list(fids):
            f = by_id[fid]
            f.rate = best_share
            n_unfrozen -= 1
            for l in f.links:
                link_flows[l].discard(fid)
                remaining_cap[l] -= best_share
                if remaining_cap[l] < 0:
                    remaining_cap[l] = 0.0
                touched.add(l)
        for l in touched:
            version[l] += 1
            n = len(link_flows[l])
            if n:
                heapq.heappush(
                    heap, (remaining_cap[l] / n, link_order[l], version[l]))


_FILLS = {"heap": _heap_fill, "scan": _progressive_fill}

# The share-ordered link heap amortises when components stay small (flat
# topology: a handful of flows per recompute).  Under a hierarchical
# topology the shared rack/core links weld most flows into one component
# and collapse the fill into few rounds with huge freeze batches -- there
# the heap's per-freeze bookkeeping stops paying for itself, so past this
# many link memberships (sum of path lengths over the component) the heap
# path switches to the vectorized dense-round fill below (bit-identical;
# see FlowManager._fill_vectorized).  The switch additionally requires a
# shared hierarchy link to have been seen (_has_shared): flat components
# can also grow large, but they freeze in many small rounds where the
# dense per-round scans cost O(rounds * links) and the heap stays ahead.
_VEC_MIN_MEMBERS = 512

# link kinds private to a single node; anything else (rku/rkd/core/
# wanu/wand) is shared infrastructure that can weld components
_NODE_KINDS = frozenset(("up", "down", "dr", "dw"))


class FlowManager:
    """Holds active flows and computes max-min fair rates incrementally.

    The engine batches adds/removes per event step and calls ``recompute``
    once, then asks for ``next_completion`` and ``advance``s virtual time;
    a quiescent step (no flow added or removed since the last call) skips
    allocation entirely because the dirty-link set is empty.

    ``fill`` selects the per-recompute allocator: ``"heap"`` (default) is
    the incremental bottleneck-selection fill, ``"scan"`` the retained
    pre-heap ``_progressive_fill`` -- rate-identical, kept as the reference
    path for equivalence tests and as the benchmark baseline.  ``device``
    is where the dense fill's tensors lie (CUDA unless the caller names
    another; raises without a card).
    """

    def __init__(self, capacities: dict[LinkId, float],
                 fill: str = "heap", device="cuda") -> None:
        if fill not in _FILLS:
            raise ValueError(f"unknown fill {fill!r}")
        self.fill = fill
        self._fill = _FILLS[fill]
        self.device = require_device(device)
        # dense fast path for the heap fill on welded components; the scan
        # fill stays the untouched pure-python reference
        self._vec = fill == "heap"
        self._slot: dict[LinkId, int] = {}      # link -> dense slot index
        self._slot_links: list[LinkId] = []     # slot -> link
        # slot -> capacity, snapshotted at slot creation.  Safe to cache:
        # the engine only ever (re)writes a link's capacity with the same
        # config-derived constant (_join_node / Topology.ensure_node).
        self._slot_caps: list[float] = []
        self._caps_t = None                     # lazily rebuilt, on device
        self._has_shared = False    # saw a non-node (hierarchy) link kind
        self.capacities = capacities
        self.flows: dict[int, Flow] = {}
        self._next_id = 0
        self.now = 0.0                              # internal virtual clock
        self._dirty_links: set[LinkId] = set()
        self._link_flows: dict[LinkId, set[int]] = {}  # persistent index
        # heap entries: (eta, flow id, epoch); entries go stale when the
        # flow is removed or its epoch moved on -- skipped on pop.
        self._completions: list[tuple[float, int, int]] = []  # half-byte ETA
        self._horizon: list[tuple[float, int, int]] = []      # full ETA
        # health counters (surfaced in SimResult / bench rows)
        self.compactions = 0                        # heap rebuilds
        self.recomputes = 0                         # non-trivial fills
        self.comp_flows_total = 0                   # Σ component sizes
        # fills that took the dense path (not in SimResult, which stays
        # the reference's field for field)
        self.dense_fills = 0

    # ------------------------------------------------------------------ API
    def add(self, links: tuple[LinkId, ...], nbytes: float,
            tag: Hashable) -> Flow:
        for l in links:
            if l not in self.capacities:
                raise KeyError(f"unknown link {l}")
        f = Flow(self._next_id, links, max(float(nbytes), 0.0), tag,
                 settled=self.now)
        self._next_id += 1
        self.flows[f.id] = f
        for l in links:
            self._link_flows.setdefault(l, set()).add(f.id)
        self._dirty_links.update(links)
        if self._vec:
            slot = self._slot
            idxs = []
            for l in links:
                s = slot.get(l)
                if s is None:
                    slot[l] = s = len(self._slot_links)
                    self._slot_links.append(l)
                    self._slot_caps.append(self.capacities[l])
                    if l[0] not in _NODE_KINDS:
                        self._has_shared = True
                idxs.append(s)
            f.slots = tuple(idxs)
        return f

    def remove(self, flow_id: int) -> None:
        f = self.flows.pop(flow_id, None)
        if f is None:
            return
        for l in f.links:
            fids = self._link_flows.get(l)
            if fids is not None:
                fids.discard(flow_id)
                if not fids:
                    self._link_flows.pop(l, None)
        self._dirty_links.update(f.links)

    def flows_on_node(self, node: int) -> list[int]:
        """Ids of flows crossing any of the node's four links, ascending
        (deterministic iteration order for the engine's failure redirect).
        O(answer) via the persistent link index."""
        ids: set[int] = set()
        for kind in ("up", "down", "dr", "dw"):
            ids |= self._link_flows.get((kind, node), set())
        return sorted(ids)

    def unsent(self, flow_id: int) -> float:
        """Bytes the flow has not yet moved as of the current virtual time
        (settling the lazily-advanced count), for abort accounting."""
        f = self.flows.get(flow_id)
        if f is None:
            return 0.0
        rem = f.remaining
        if f.rate > 0 and self.now > f.settled:
            rem -= f.rate * (self.now - f.settled)
        return max(rem, 0.0)

    def _component(self) -> list[Flow]:
        """Flows transitively sharing a link with any dirty link."""
        flows = self.flows
        link_flows = self._link_flows
        n_all = len(flows)
        comp_ids: set[int] = set()
        frontier: set[LinkId] = set(self._dirty_links)
        seen_links: set[LinkId] = set(frontier)
        # alternating bulk expansion (links -> flows -> links) instead of a
        # per-membership stack walk: the set unions run at C speed, which
        # matters once a hierarchical topology welds most flows into one
        # component and the flood covers nearly everything every recompute
        while frontier:
            new_ids: set[int] = set()
            for l in frontier:
                s = link_flows.get(l)
                if s:
                    new_ids |= s
            new_ids -= comp_ids
            if not new_ids:
                break
            comp_ids |= new_ids
            if len(comp_ids) == n_all:
                break   # welded regime: the component already spans every
                        # flow, so the rest of the flood cannot add any
            next_links: set[LinkId] = set()
            for fid in new_ids:
                next_links.update(flows[fid].links)
            next_links -= seen_links
            seen_links |= next_links
            frontier = next_links
        # ascending id == insertion order of the reference full recompute
        return [flows[fid] for fid in sorted(comp_ids)]

    def _fill_vectorized(self, comp: list[Flow]) -> None:
        """Dense-round progressive filling over a welded component.

        Bit-identical to :func:`_progressive_fill` / :func:`_heap_fill`
        but built for the regime a hierarchical topology creates: shared
        rack/core links weld most flows into one component and freeze them
        in few rounds with huge batches, where the share-ordered link heap's
        per-freeze bookkeeping costs more than it saves.  Per-link state
        lives in dense tensors on ``self.device`` -- residual capacity,
        unfrozen-flow count and the first-encounter order key -- and each
        round is a handful of tensor passes: recompute fair shares, pick the
        lexicographic minimum of (share, insertion order) exactly like the
        reference scan's first-strictly-smaller-wins iteration, then apply
        the freeze to every membership of the frozen flows.

        Float identity: shares are the same IEEE-754 float64 division; a
        link's residual takes one subtraction of ``best_share`` per frozen
        membership, as the scan's, by an ``index_add_`` of ``-best_share``
        (x + (-s) is x - s bit for bit, and equal addends give the same
        sum in any order, so the device's atomics cannot change it);
        clamping the whole residual vector at zero once per round equals
        the reference's per-step clamp because subtraction of a
        non-negative share is monotone.  Order-free everywhere else: each
        link's first membership is a ``scatter_reduce_`` "amin" (not a
        last-write-wins scatter, which CUDA does not order), counts move by
        integer ``index_add_``, and the CSR transpose is a stable argsort.
        Each flow's slot ids stay on the host (assigned once in ``add``);
        the component's index tensor is built once per fill.  A round
        reads the share, the bottleneck and the frozen flows back to the
        host (three synchronizations).
        """
        self.dense_fills += 1
        dev = self.device
        i64, f64 = torch.int64, torch.float64
        n_slots = len(self._slot_links)
        if self._caps_t is None or self._caps_t.numel() != n_slots:
            self._caps_t = torch.tensor(self._slot_caps, dtype=f64,
                                        device=dev)
        cat_h: list[int] = []
        lens: list[int] = []
        for f in comp:
            cat_h.extend(f.slots)
            lens.append(len(f.slots))
        n_members = len(cat_h)
        cat = torch.tensor(cat_h, dtype=i64, device=dev)
        lens_arr = torch.tensor(lens, dtype=i64, device=dev)
        # slots_u: the component's links (closure => exactly the links its
        # flows cross); counts: flows per link; inv: per-membership compact
        # link index; first: position of each link's first membership in
        # `cat`, i.e. the reference fills' insertion-order tie-break key.
        # (A flow's links tuple never repeats a link -- engine invariant --
        # so membership counts equal the reference's per-link set sizes.)
        dense = torch.zeros(n_slots, dtype=i64, device=dev)
        dense.index_add_(0, cat, torch.ones_like(cat))
        slots_u = torch.nonzero(dense).flatten()
        n_u = slots_u.numel()
        counts = dense[slots_u]
        lut = torch.empty(n_slots, dtype=i64, device=dev)
        lut[slots_u] = torch.arange(n_u, dtype=i64, device=dev)
        inv = lut[cat]
        big = torch.iinfo(i64).max
        first = torch.full((n_u,), big, dtype=i64, device=dev)
        first.scatter_reduce_(0, inv, torch.arange(n_members, dtype=i64,
                                                   device=dev), "amin")
        n_flows = len(comp)
        offs = torch.zeros(n_flows + 1, dtype=i64, device=dev)
        offs[1:] = torch.cumsum(lens_arr, 0)
        # CSR transpose of the membership matrix: for each compact link,
        # the component positions of the flows that cross it -- freezing a
        # bottleneck's flows is then one mask-and-gather
        flowpos = torch.repeat_interleave(
            torch.arange(n_flows, dtype=i64, device=dev), lens_arr,
            output_size=n_members)
        members = flowpos[torch.argsort(inv, stable=True)]
        bounds = [0] + torch.cumsum(counts, 0).tolist()
        rcap = self._caps_t[slots_u]            # fresh gather => owned copy
        count = counts.clone()                  # live (unfrozen) counts
        frozen = torch.zeros(n_flows, dtype=torch.bool, device=dev)
        n_unfrozen = n_flows
        while n_unfrozen:
            shares = torch.where(count > 0, rcap / count, math.inf)
            best = shares.min()
            pick = torch.where(shares == best, first, big).argmin()
            best_share, i = torch.stack((best, pick.to(f64))).tolist()
            if best_share == math.inf:
                break
            i = int(i)
            mem = members[bounds[i]:bounds[i + 1]]
            new = mem[~frozen[mem]]
            frozen[new] = True
            new_h = new.tolist()
            n_unfrozen -= len(new_h)
            for p in new_h:
                comp[p].rate = best_share
            # membership indices of every newly-frozen flow (multi-range
            # gather over the flows' segments of `inv`)
            cnt = lens_arr[new]
            total = sum(lens[p] for p in new_h)
            base = torch.repeat_interleave(offs[new], cnt, output_size=total)
            step = torch.arange(total, dtype=i64, device=dev) \
                - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt,
                                          output_size=total)
            seg = inv[base + step]
            count.index_add_(0, seg, torch.full_like(seg, -1))
            rcap.index_add_(0, seg, torch.full((total,), -best_share,
                                               dtype=f64, device=dev))
            rcap.clamp_(min=0.0)

    def _push(self, f: Flow) -> None:
        if f.remaining <= _DUST:
            heapq.heappush(self._completions, (self.now, f.id, f.epoch))
            heapq.heappush(self._horizon, (self.now, f.id, f.epoch))
        elif f.rate > 0:
            half = f.settled + (f.remaining - _DUST) / f.rate
            full = f.settled + f.remaining / f.rate
            heapq.heappush(self._completions, (half, f.id, f.epoch))
            heapq.heappush(self._horizon, (full, f.id, f.epoch))
        # rate == 0: no ETA; the flow re-enters a heap when its component
        # is recomputed with capacity to give

    def _maybe_compact(self) -> None:
        """Drop stale heap entries once they outnumber live flows 4:1.

        An entry is live when its flow still exists *and* carries the
        entry's rate epoch; every flow has at most one live entry per heap,
        so a compacted heap is bounded by the active-flow count.  Amortised
        O(1): a rebuild is linear but removes >= 3/4 of the entries."""
        n_live = len(self.flows)
        for attr in ("_completions", "_horizon"):
            heap = getattr(self, attr)
            if len(heap) > _COMPACT_MIN and len(heap) > _COMPACT_FACTOR * n_live:
                fresh = [e for e in heap
                         if (f := self.flows.get(e[1])) is not None
                         and f.epoch == e[2]]
                heapq.heapify(fresh)
                setattr(self, attr, fresh)
                self.compactions += 1

    def recompute(self) -> None:
        """Progressive filling over the dirty connected component only."""
        if not self._dirty_links:
            return
        comp = self._component()
        self._dirty_links.clear()
        if not comp:
            return
        self.recomputes += 1
        self.comp_flows_total += len(comp)
        members = 0
        for f in comp:
            members += len(f.links)
            # settle lazily-advanced byte counts before the rate changes
            if f.rate > 0 and self.now > f.settled:
                f.remaining = max(f.remaining - f.rate * (self.now - f.settled),
                                  0.0)
            f.settled = self.now
        if self._vec and self._has_shared and members >= _VEC_MIN_MEMBERS:
            self._fill_vectorized(comp)
        else:
            self._fill(comp, self.capacities)
        if len(comp) == len(self.flows):
            # the component spans every live flow, so every existing heap
            # entry is about to go stale: rebuild both ETA heaps from the
            # fresh entries instead of pushing per flow and compacting the
            # garbage later.  Observable behavior is identical -- the heaps
            # hold the same live-entry multiset a push-per-flow would leave
            # (pops always return the tuple minimum), just no dead weight.
            now = self.now
            completions: list[tuple[float, int, int]] = []
            horizon: list[tuple[float, int, int]] = []
            for f in comp:
                f.epoch += 1
                rem = f.remaining
                if rem <= _DUST:
                    completions.append((now, f.id, f.epoch))
                    horizon.append((now, f.id, f.epoch))
                elif f.rate > 0:
                    settled = f.settled
                    rate = f.rate
                    completions.append(
                        (settled + (rem - _DUST) / rate, f.id, f.epoch))
                    horizon.append((settled + rem / rate, f.id, f.epoch))
            heapq.heapify(completions)
            heapq.heapify(horizon)
            self._completions = completions
            self._horizon = horizon
        else:
            for f in comp:
                f.epoch += 1
                self._push(f)
            self._maybe_compact()

    def next_completion(self) -> tuple[float, Flow | None]:
        """(dt, flow) of the earliest finishing flow at current rates."""
        while self._horizon:
            eta, fid, epoch = self._horizon[0]
            f = self.flows.get(fid)
            if f is None or f.epoch != epoch:
                heapq.heappop(self._horizon)
                continue
            return max(eta - self.now, 0.0), f
        return math.inf, None

    def advance(self, dt: float) -> list[Flow]:
        """Progress virtual time by ``dt``; returns completed flows
        (removed).  Untouched flows advance lazily -- O(completions)."""
        self.now += dt
        done: list[Flow] = []
        while self._completions:
            eta, fid, epoch = self._completions[0]
            if eta > self.now:
                break
            heapq.heappop(self._completions)
            f = self.flows.get(fid)
            if f is None or f.epoch != epoch:
                continue
            f.remaining = 0.0
            f.settled = self.now
            done.append(f)
        # reference completion order == flow insertion order (ascending id)
        done.sort(key=lambda f: f.id)
        for f in done:
            self.remove(f.id)
        return done

    @property
    def active(self) -> int:
        return len(self.flows)

    @property
    def mean_component(self) -> float:
        """Mean flows per non-trivial recompute (fill-regression signal:
        a drift toward the active-flow count means components are welding
        together and the incremental recompute is going global)."""
        return self.comp_flows_total / self.recomputes if self.recomputes \
            else 0.0

    def health(self) -> dict[str, float]:
        """Counters for SimResult / benchmark rows."""
        return {"recomputes": self.recomputes,
                "compactions": self.compactions,
                "mean_component": self.mean_component}


class ReferenceFlowManager:
    """Pre-refactor FlowManager: full recompute + O(flows) scans per event.

    Frozen on purpose -- this is the oracle the incremental implementation
    is equivalence-tested against (tests/test_incremental.py).
    """

    def __init__(self, capacities: dict[LinkId, float]) -> None:
        self.capacities = capacities
        self.flows: dict[int, Flow] = {}
        self._next_id = 0
        self._dirty = False

    def add(self, links: tuple[LinkId, ...], nbytes: float,
            tag: Hashable) -> Flow:
        for l in links:
            if l not in self.capacities:
                raise KeyError(f"unknown link {l}")
        f = Flow(self._next_id, links, max(float(nbytes), 0.0), tag)
        self._next_id += 1
        self.flows[f.id] = f
        self._dirty = True
        return f

    def remove(self, flow_id: int) -> None:
        self.flows.pop(flow_id, None)
        self._dirty = True

    def flows_on_node(self, node: int) -> list[int]:
        # kind guard: rack/site link ids (("rku", r), ...) share the int
        # namespace with node ids; only the four per-node kinds count.
        # Behaviour-identical on every flat-topology input (the only kinds
        # that existed when this reference was frozen).
        return sorted(f.id for f in self.flows.values()
                      if any(l[0] in ("up", "down", "dr", "dw")
                             and l[1] == node for l in f.links))

    def unsent(self, flow_id: int) -> float:
        f = self.flows.get(flow_id)
        return max(f.remaining, 0.0) if f is not None else 0.0

    def recompute(self) -> None:
        if not self._dirty:
            return
        self._dirty = False
        flows = list(self.flows.values())
        if not flows:
            return
        _progressive_fill(flows, self.capacities)

    def next_completion(self) -> tuple[float, Flow | None]:
        best_dt, best = math.inf, None
        for f in self.flows.values():
            dt = f.eta()
            if dt < best_dt:
                best_dt, best = dt, f
        return best_dt, best

    def advance(self, dt: float) -> list[Flow]:
        done: list[Flow] = []
        for f in self.flows.values():
            f.remaining -= f.rate * dt
            if f.remaining <= _DUST:
                f.remaining = 0.0
                done.append(f)
        for f in done:
            self.remove(f.id)
        return done

    @property
    def active(self) -> int:
        return len(self.flows)


def build_links(
    n_nodes: int,
    net_bw: float,
    disk_read_bw: float,
    disk_write_bw: float,
    extra_nodes: tuple[int, ...] = (),
    extra_net_bw: float | None = None,
    extra_disk_read_bw: float | None = None,
    extra_disk_write_bw: float | None = None,
    topology=None,
) -> dict[LinkId, float]:
    """Standard link table: n compute nodes + optional extra (DFS server)
    nodes with their own capacities.  ``topology`` (a
    ``sim.topology.Topology``) additionally registers the rack/core/WAN
    link capacities every listed node's flows may cross; a flat topology
    (or None) registers nothing and the table is byte-identical to the
    pre-topology one."""
    caps: dict[LinkId, float] = {}
    for n in range(n_nodes):
        caps[("up", n)] = net_bw
        caps[("down", n)] = net_bw
        caps[("dr", n)] = disk_read_bw
        caps[("dw", n)] = disk_write_bw
    for n in extra_nodes:
        caps[("up", n)] = extra_net_bw or net_bw
        caps[("down", n)] = extra_net_bw or net_bw
        caps[("dr", n)] = extra_disk_read_bw or disk_read_bw
        caps[("dw", n)] = extra_disk_write_bw or disk_write_bw
    if topology is not None:
        for n in range(n_nodes):
            topology.ensure_node(n, caps)
        for n in extra_nodes:
            topology.ensure_node(n, caps)
    return caps
