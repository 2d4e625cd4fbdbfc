"""Indexed ready-set subsystem: canonical node order, capacity classes and
the priority-indexed step-2/3 ready structure.

Three small, allocation-light containers that turn the scheduler's per-event
O(backlog) rescans into O(dirty)-shaped index maintenance (DESIGN.md
"Indexed ready set"):

* :class:`NodeOrder` -- the **canonical node enumeration order**, owned by
  the environment (the simulator's ``Simulation`` or the runtime adapter)
  and threaded through scheduler, DPS and solver.  It is defined to match
  the enumeration order of the environment's ``nodes`` dict -- exactly what
  the frozen ``ReferenceWowScheduler`` iterates via ``list(self.nodes)`` --
  so reference equivalence no longer rests on the repo-wide "node ids
  ascend" convention: a node may re-join under its old (lower) id and both
  implementations still agree, because both enumerate it *last*.

* :class:`CapacityClasses` -- nodes grouped by identical
  ``(free_mem, free_cores)``.  Input-less ready tasks are prepared
  everywhere, so their step-1 candidates are purely a capacity question;
  grouping makes "all nodes fitting shape (m, c)" an O(classes) query
  instead of an O(nodes)-per-task scan, which is what lets the scheduler
  drop input-less tasks from the DPS/component machinery entirely.

* :class:`ShapeIndex` -- input-less ready tasks bucketed by resource shape
  ``(mem, cores)``, each bucket pre-sorted in the greedy visit order
  ``(-priority, id)`` and maintained in O(log R) under submit/start.
  Together with :class:`CapacityClasses` it makes the scheduler's
  capacity-only step-1 path O(shapes + assigned) per stale event instead of
  an O(backlog) regroup-and-rebuild (DESIGN.md "Incremental input-less
  placement").

* :class:`ReadySet` -- the priority-indexed ready structure for steps 2-3.
  A bucket queue over ``|N_prep|`` (the leading component of the step-2
  sort key) holds, per bucket, a bisect-maintained list sorted by the
  remaining key ``(running COPs, -priority, task id)``; a second flat
  sorted list holds the step-3 order ``(-priority, task id)``.  Tasks whose
  COP is provably infeasible under the current free-COP-slot set (the DPS's
  ``cop_blocked``) are parked in a *blocked* side-set and excluded from
  both orders, so step-2/3 iteration touches only tasks that could actually
  start a COP.  Every mutation is O(log R) search + a small memmove;
  iteration is a flat walk of pre-sorted lists with no key computation.

The structures are plain data containers: the scheduler decides *when* keys
change (DPS dirty drains, COP start/finish, task start) and pushes the new
values in.  ``tests/test_readyset.py`` property-tests both orders against
from-scratch sorts of every snapshot.

The reference's ``repro/core/readyset.py``, copied as it is: plain Python
containers, which the scheduler keeps on the host on every device.
"""
from __future__ import annotations

from bisect import bisect_left, insort

from .types import NodeId, NodeState


class NodeOrder:
    """Canonical node enumeration order (environment-owned).

    Semantically this is ``list(nodes)`` of the environment's node dict,
    kept as an explicit object so every layer orders node collections the
    same way without re-deriving (or re-sorting) it.  ``add`` appends --
    like a dict insertion -- and ``discard`` removes; both are idempotent
    so the environment and a standalone scheduler may maintain a shared
    instance without double-counting.  Membership changes are rare (elastic
    join / node failure), so the O(n) position rebuild on ``discard`` is
    irrelevant next to the per-event hot path it serves.
    """

    def __init__(self, nodes=()) -> None:
        self._ids: list[NodeId] = []
        self._pos: dict[NodeId, int] = {}
        for n in nodes:
            self.add(n)

    def add(self, node: NodeId) -> None:
        if node not in self._pos:
            self._pos[node] = len(self._ids)
            self._ids.append(node)

    def discard(self, node: NodeId) -> None:
        if node in self._pos:
            self._ids.remove(node)
            self._pos = {n: i for i, n in enumerate(self._ids)}

    def position(self, node: NodeId) -> int:
        return self._pos[node]

    def sort(self, nodes) -> list[NodeId]:
        """``nodes`` (any iterable of known ids) in canonical order."""
        return sorted(nodes, key=self._pos.__getitem__)

    def __iter__(self):
        return iter(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, node: NodeId) -> bool:
        return node in self._pos

    def ids(self) -> list[NodeId]:
        return list(self._ids)


class CapacityClasses:
    """Nodes grouped by identical ``(free_mem, free_cores)``.

    The scheduler refreshes exactly the dirty nodes (whose free resources
    changed) per event; queries then cost O(distinct capacity classes),
    which in steady state is bounded by the distinct task shapes in
    flight, not the cluster size.
    """

    def __init__(self, nodes: dict[int, NodeState],
                 order: NodeOrder) -> None:
        self._nodes = nodes
        self._order = order
        self._members: dict[tuple, set[NodeId]] = {}
        self._class_of: dict[NodeId, tuple] = {}
        for n in nodes:
            self.refresh(n)

    def refresh(self, node: NodeId) -> None:
        """(Re-)classify ``node`` from its live free resources."""
        state = self._nodes.get(node)
        if state is None:
            self.drop(node)
            return
        key = (state.free_mem, state.free_cores)
        old = self._class_of.get(node)
        if old == key:
            return
        if old is not None:
            self._evict(node, old)
        self._class_of[node] = key
        self._members.setdefault(key, set()).add(node)

    def refresh_many(self, nodes) -> None:
        """Batch form of :meth:`refresh` (one call per dirty-node drain;
        the array-backed twin answers it in a single pass)."""
        for n in nodes:
            self.refresh(n)

    def drop(self, node: NodeId) -> None:
        old = self._class_of.pop(node, None)
        if old is not None:
            self._evict(node, old)

    def _evict(self, node: NodeId, key: tuple) -> None:
        members = self._members.get(key)
        if members is not None:
            members.discard(node)
            if not members:
                del self._members[key]

    def fitting(self, mem: int, cores: float) -> list[NodeId]:
        """All nodes whose free resources fit ``(mem, cores)``, in
        canonical order -- the candidate list an input-less task's step-1
        assignment sees."""
        out: list[NodeId] = []
        for (fm, fc), members in self._members.items():
            if fm >= mem and fc >= cores:
                out.extend(members)
        return self._order.sort(out)

    def any_fit(self, mem: int, cores: float) -> bool:
        return any(fm >= mem and fc >= cores
                   for fm, fc in self._members)


class ShapeIndex:
    """Input-less ready tasks bucketed by resource shape ``(mem, cores)``.

    Each bucket is a bisect-maintained list of ``(-priority, task id)`` --
    the exact visit order of ``ilp.solve_greedy`` -- so the scheduler's
    capacity fast path can walk just the assignable prefix of a shape
    instead of re-sorting the whole input-less backlog per event.  Shape
    iteration order is bucket creation order (dict insertion), which the
    consumers never depend on: the union-find over shapes keys on shared
    fitting nodes and the merged per-component assignments are
    order-insensitive.
    """

    def __init__(self) -> None:
        self._groups: dict[tuple[int, float], list[tuple[float, int]]] = {}
        self._shape_of: dict[int, tuple[int, float]] = {}
        self._negprio: dict[int, float] = {}

    def add(self, tid: int, mem: int, cores: float,
            priority: float) -> None:
        if tid in self._shape_of:       # resubmission: replace cleanly
            self.discard(tid)
        shape = (mem, cores)
        self._shape_of[tid] = shape
        self._negprio[tid] = -priority
        insort(self._groups.setdefault(shape, []), (-priority, tid))

    def discard(self, tid: int) -> None:
        shape = self._shape_of.pop(tid, None)
        if shape is None:
            return
        group = self._groups[shape]
        group.pop(bisect_left(group, (self._negprio.pop(tid), tid)))
        if not group:
            del self._groups[shape]

    def shapes(self) -> list[tuple[int, float]]:
        """Shapes with at least one task (bucket creation order)."""
        return list(self._groups)

    def group(self, shape: tuple[int, float]) -> list[tuple[float, int]]:
        """The shape's live ``(-priority, id)``-sorted bucket (read-only:
        callers must not mutate it)."""
        return self._groups[shape]

    def tasks_of(self, shape: tuple[int, float]) -> list[int]:
        """Task ids of the shape in the greedy visit order."""
        return [tid for _, tid in self._groups[shape]]

    def shape_of(self, tid: int) -> tuple[int, float]:
        return self._shape_of[tid]

    def __contains__(self, tid: int) -> bool:
        return tid in self._shape_of

    def __len__(self) -> int:
        return len(self._shape_of)


class ReadySet:
    """Priority-indexed ready structure for the scheduler's steps 2-3.

    Holds every *data-bound* ready task (input-less tasks never receive
    COPs) under two orders:

    * **step 2**: ascending ``(|N_prep|, running COPs, -priority, id)`` --
      a bucket per prepared-node count (``_buckets``/``_bucket_keys``),
      each bucket a sorted list of ``(cops, -priority, id)``;
    * **step 3**: ascending ``(-priority, id)`` (``_order3``) -- static per
      task, maintained as one flat sorted list.

    Tasks flagged *blocked* (no admissible COP source under the current
    free-slot set; see ``DataPlacementService.cop_blocked``) are excluded
    from both orders but keep their key fields, so unblocking is a plain
    re-insert.  ``step2_order``/``step3_order`` materialize the current
    order into a list: the scheduler iterates the snapshot while freely
    mutating the structure (COP starts bump a visited task's COP count and
    may block later tasks), exactly mirroring the reference's
    sort-once-then-scan semantics.
    """

    def __init__(self) -> None:
        # tid -> [prep, cops, -priority, blocked]
        self._info: dict[int, list] = {}
        self._buckets: dict[int, list[tuple]] = {}
        self._bucket_keys: list[int] = []
        self._order3: list[tuple] = []

    # ------------------------------------------------------------ plumbing
    def _insert(self, tid: int, info: list) -> None:
        prep, cops, negprio, _ = info
        bucket = self._buckets.get(prep)
        if bucket is None:
            bucket = self._buckets[prep] = []
            insort(self._bucket_keys, prep)
        insort(bucket, (cops, negprio, tid))
        insort(self._order3, (negprio, tid))

    def _remove(self, tid: int, info: list) -> None:
        prep, cops, negprio, _ = info
        bucket = self._buckets[prep]
        bucket.pop(bisect_left(bucket, (cops, negprio, tid)))
        if not bucket:
            del self._buckets[prep]
            self._bucket_keys.pop(bisect_left(self._bucket_keys, prep))
        self._order3.pop(bisect_left(self._order3, (negprio, tid)))

    # ------------------------------------------------------------ mutators
    def add(self, tid: int, priority: float, prep: int, cops: int,
            blocked: bool = False) -> None:
        if tid in self._info:
            self.discard(tid)
        info = [prep, cops, -priority, blocked]
        self._info[tid] = info
        if not blocked:
            self._insert(tid, info)

    def discard(self, tid: int) -> None:
        info = self._info.pop(tid, None)
        if info is not None and not info[3]:
            self._remove(tid, info)

    def update_prep(self, tid: int, prep: int) -> None:
        info = self._info.get(tid)
        if info is None or info[0] == prep:
            return
        if info[3]:
            info[0] = prep
            return
        self._remove(tid, info)
        info[0] = prep
        self._insert(tid, info)

    def update_cops(self, tid: int, cops: int) -> None:
        info = self._info.get(tid)
        if info is None or info[1] == cops:
            return
        if info[3]:
            info[1] = cops
            return
        self._remove(tid, info)
        info[1] = cops
        self._insert(tid, info)

    def set_blocked(self, tid: int, blocked: bool) -> None:
        info = self._info.get(tid)
        if info is None or info[3] == blocked:
            return
        if blocked:
            self._remove(tid, info)
        info[3] = blocked
        if not blocked:
            self._insert(tid, info)

    # ------------------------------------------------------------- queries
    def __contains__(self, tid: int) -> bool:
        return tid in self._info

    def __len__(self) -> int:
        return len(self._info)

    def is_blocked(self, tid: int) -> bool:
        return self._info[tid][3]

    def step2_order(self) -> list[int]:
        """Unblocked task ids in ascending
        ``(|N_prep|, cops, -priority, id)`` -- the step-2 visit order."""
        out: list[int] = []
        for prep in self._bucket_keys:
            out.extend(e[2] for e in self._buckets[prep])
        return out

    def step3_order(self) -> list[int]:
        """Unblocked task ids in ascending ``(-priority, id)`` -- the
        step-3 visit order."""
        return [tid for _, tid in self._order3]
