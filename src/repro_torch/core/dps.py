"""Data Placement Service (paper §III-C), incremental edition.

The DPS owns every intermediate file: sizes, producer, and the set of nodes
holding a *valid* replica.  Replicas are created exclusively through COPs.
For a (task, target-node) request it plans the cheapest COP:

  1. list the task's input files missing on the target, sorted by size
     (largest first),
  2. for each file pick the source replica on the node with the lowest load
     *already assigned within this COP* (first file: all ties, resolved by a
     seeded RNG, exactly like the paper's random tie-break),
  3. price = w_t * total_traffic + w_l * max participating-node load, with
     equal weights (paper: "we give equal weight to both aspects").

The DPS is deliberately environment-free: the scheduler, the mock resource
manager and the data and checkpoint planners all drive it through this
interface.  This is the reference's ``repro/core/dps.py``: every index, every
query and the tie-break stream are its own.  The port adds one argument, to
:meth:`enable_matrix`: the device of the dense COP matrix the scheduler's
blocked drain reads (``core/copmatrix.py``), which is the scheduler's own.
The DPS itself keeps no tensor.  The seeded tie-break generator stays a
``random.Random``, drawn where the reference draws it, so COP plans are the
reference's draw for draw.

Incremental indices (DESIGN.md "Index invariants"):

Beyond the authoritative ``file -> replica nodes`` map, the DPS maintains
reverse indices so the scheduler's hot-loop queries are O(1)/O(inputs)
lookups instead of set intersections over all replica sets:

  * ``_node_files``       node  -> files with a valid replica on the node
  * ``_waiting``          file  -> tracked tasks consuming the file
  * ``_present_cnt``      task  -> {node: #inputs with a replica on node}
  * ``_present_bytes``    task  -> {node: bytes of inputs present on node}
  * ``_prep``             task  -> nodes where *all* inputs are present
  * ``_node_prep_tasks``  node  -> tasks fully prepared on the node

Tasks are registered with :meth:`track_task` (the scheduler does this on
submit) and dropped with :meth:`untrack_task` (on start).  Every replica
mutation funnels through ``_idx_add`` / ``_idx_remove`` which keep all six
indices consistent and record tasks whose prepared-node set changed in a
dirty set the scheduler drains via :meth:`drain_dirty_tasks`.

Source-feasibility index (DESIGN.md "Indexed ready set"): when the owning
scheduler activates it via :meth:`sync_free_sources` and then mirrors every
free-COP-slot transition through :meth:`note_source_freed` /
:meth:`note_source_busy`, the DPS additionally maintains, per file, the
number of replicas on free-slot nodes (``_free_rep``) and, per tracked
task, the number of distinct inputs with *no* free-slot replica
(``_unsourced``).  :meth:`cop_blocked` then answers "is a COP for this task
provably infeasible right now?" in O(1): with any unsourced input the only
feasible targets are free-slot nodes already holding *all* unsourced
inputs (:meth:`cop_feasible_targets`) -- and a free-slot node holding one
would have made it sourced, so no such target exists, every probe would
fail, and steps 2-3 may skip the task without changing any decision.  Tasks whose blocked state may have flipped land in a dirty set
drained via :meth:`drain_blocked_dirty`.  The index is inert (and free)
until ``sync_free_sources`` is called; the reference scheduler never calls
it.

The original from-scratch queries (``is_prepared``, ``prepared_nodes``,
``missing_files``, ``missing_bytes``) are retained both as the generic API
for untracked input tuples and as the reference implementations the
equivalence tests check the indices against.
"""
from __future__ import annotations

import random

from ..models.common import same_device
from .types import CopPlan, FileSpec, NodeId, Transfer

# Equal weights for the two price components (§III-C).
W_TRAFFIC = 0.5
W_MAXLOAD = 0.5

_EMPTY: frozenset = frozenset()

# sentinel: plan_cop computes cop_feasible_targets itself unless the caller
# hands over a precomputed constraint (None is a valid value: unconstrained)
_UNCHECKED = object()


class DataPlacementService:
    def __init__(self, seed: int = 0, node_order=None) -> None:
        self._files: dict[int, FileSpec] = {}
        self._locations: dict[int, set[NodeId]] = {}
        self._rng = random.Random(seed)
        # hierarchical topology (sim/topology.py); None (or flat) keeps the
        # original byte-count cost model and the exact pre-topology RNG
        # stream -- see set_topology
        self._topo = None
        self._next_cop_id = 0
        # canonical node enumeration order (core.readyset.NodeOrder) shared
        # with the environment/scheduler; None falls back to ascending ids
        # (the historical repo convention, still right for standalone use)
        self._node_order = node_order
        # total bytes moved through COPs, for the Fig.4 overhead metric
        self.cop_bytes_total = 0
        # ----- reverse indices (see module docstring)
        self._node_files: dict[NodeId, set[int]] = {}
        self._waiting: dict[int, set[int]] = {}
        self._task_inputs: dict[int, tuple[int, ...]] = {}
        # per-task input multiplicity: duplicated input ids count per
        # occurrence, matching the reference missing_bytes semantics
        self._task_mult: dict[int, dict[int, int]] = {}
        self._task_bytes: dict[int, int] = {}
        self._present_cnt: dict[int, dict[NodeId, int]] = {}
        self._present_bytes: dict[int, dict[NodeId, int]] = {}
        self._prep: dict[int, set[NodeId]] = {}
        self._node_prep_tasks: dict[NodeId, set[int]] = {}
        self._dirty_tasks: set[int] = set()
        # ----- source-feasibility index (inert until sync_free_sources)
        self._src_active = False
        self._free_src: set[NodeId] = set()            # free-COP-slot mirror
        self._free_rep: dict[int, int] = {}            # file -> free replicas
        self._unsourced: dict[int, int] = {}           # task -> sourceless inputs
        self._blocked_dirty: set[int] = set()
        # ----- batched-drain matrix (core/copmatrix.py): array mirrors of
        # _present_cnt/_present_bytes, inert until enable_matrix() -- the
        # owning scheduler calls it when its blocked step-2/3 kernel is on
        self._mx = None

    # -------------------------------------------------- batched-drain matrix
    def enable_matrix(self, device):
        """Attach (or rebuild) the :class:`~.copmatrix.CopMatrix` mirror of
        the per-(task, node) present indices, on ``device`` (the owning
        scheduler's).  Idempotent; every replica/tracking mutation below
        keeps it cell-exact with the dicts once enabled.  A matrix already
        on another device is refused: the DPS has one."""
        from .copmatrix import CopMatrix
        if self._mx is None:
            self._mx = CopMatrix(device)
        elif not same_device(self._mx.device, device):
            raise ValueError(f"the DPS keeps its COP matrix on "
                             f"{self._mx.device}; asked for {device}")
        self._mx.rebuild(self)
        return self._mx

    @property
    def matrix(self):
        return self._mx

    # -------------------------------------------------------------- topology
    def set_topology(self, topology) -> None:
        """Attach a hierarchical :class:`~..sim.topology.Topology`.

        With a non-uniform topology attached, :meth:`plan_cop` prefers
        minimum-distance sources (rack before site before WAN) and prices
        traffic by locality-weighted bytes, and
        :meth:`locality_missing_cost` becomes the scheduler's step-2/3
        candidate metric.  ``None`` or a flat topology detaches: every code
        path and RNG draw is then bit-identical to the pre-topology DPS
        (golden-tested)."""
        self._topo = topology if (topology is not None
                                  and topology.nonuniform) else None

    def locality_missing_cost(self, task_id: int, node: NodeId) -> float:
        """Topology-weighted cost of the bytes a (tracked) task still
        misses on ``node``: each missing input contributes
        ``size * multiplicity * weight`` where weight is the cheapest
        locality tier any replica holder offers (``max_weight`` when the
        file has no holder at all -- worst-case placement assumption).
        Without a topology this is plain ``missing_bytes_task``."""
        topo = self._topo
        if topo is None:
            return float(self.missing_bytes_task(task_id, node))
        cost = 0.0
        for f, m in self._task_mult[task_id].items():
            locs = self._locations.get(f, _EMPTY)
            if node in locs:
                continue
            spec = self._files.get(f)
            size = spec.size if spec is not None else 0
            w = min(topo.weight(s, node) for s in locs) if locs \
                else topo.max_weight
            cost += size * m * w
        return cost

    def locality_missing_cost_reference(self, input_ids: tuple[int, ...],
                                        node: NodeId) -> float:
        """From-scratch :meth:`locality_missing_cost` over a raw input
        tuple (per-occurrence, like ``missing_bytes``) -- the reference
        scheduler's form, and the equivalence oracle for the tracked one."""
        topo = self._topo
        if topo is None:
            return float(self.missing_bytes(input_ids, node))
        cost = 0.0
        for f in input_ids:
            locs = self._locations.get(f, _EMPTY)
            if node in locs:
                continue
            spec = self._files.get(f)
            size = spec.size if spec is not None else 0
            w = min(topo.weight(s, node) for s in locs) if locs \
                else topo.max_weight
            cost += size * w
        return cost

    @property
    def topology(self):
        return self._topo

    # ------------------------------------------------------- index plumbing
    def _free_rep_up(self, file_id: int) -> None:
        c = self._free_rep.get(file_id, 0) + 1
        self._free_rep[file_id] = c
        if c == 1:
            for tid in self._waiting.get(file_id, _EMPTY):
                self._unsourced[tid] -= 1
                self._blocked_dirty.add(tid)

    def _free_rep_down(self, file_id: int) -> None:
        c = self._free_rep.get(file_id, 0) - 1
        if c <= 0:
            self._free_rep.pop(file_id, None)
            for tid in self._waiting.get(file_id, _EMPTY):
                self._unsourced[tid] += 1
                self._blocked_dirty.add(tid)
        else:
            self._free_rep[file_id] = c

    def _idx_add(self, file_id: int, node: NodeId) -> None:
        locs = self._locations.setdefault(file_id, set())
        if node in locs:
            return
        locs.add(node)
        self._node_files.setdefault(node, set()).add(file_id)
        if self._src_active and node in self._free_src:
            self._free_rep_up(file_id)
        spec = self._files.get(file_id)
        size = spec.size if spec is not None else 0
        mx = self._mx
        for tid in self._waiting.get(file_id, _EMPTY):
            mult = self._task_mult[tid][file_id]
            cnt = self._present_cnt[tid]
            c = cnt.get(node, 0) + mult
            cnt[node] = c
            pbytes = self._present_bytes[tid]
            pbytes[node] = pbytes.get(node, 0) + size * mult
            if mx is not None:
                mx.cell_add(tid, node, mult, size * mult)
            if c == len(self._task_inputs[tid]):
                self._prep.setdefault(tid, set()).add(node)
                self._node_prep_tasks.setdefault(node, set()).add(tid)
                self._dirty_tasks.add(tid)

    def _idx_remove(self, file_id: int, node: NodeId,
                    drop_empty: bool = True) -> None:
        locs = self._locations.get(file_id)
        if locs is None or node not in locs:
            return
        locs.discard(node)
        held = self._node_files.get(node)
        if held is not None:
            held.discard(file_id)
        if self._src_active and node in self._free_src:
            self._free_rep_down(file_id)
        spec = self._files.get(file_id)
        size = spec.size if spec is not None else 0
        mx = self._mx
        for tid in self._waiting.get(file_id, _EMPTY):
            mult = self._task_mult[tid][file_id]
            cnt = self._present_cnt[tid]
            was_prep = cnt.get(node, 0) == len(self._task_inputs[tid])
            c = cnt.get(node, 0) - mult
            pbytes = self._present_bytes[tid]
            if c <= 0:
                cnt.pop(node, None)
                pbytes.pop(node, None)
            else:
                cnt[node] = c
                pbytes[node] = pbytes.get(node, 0) - size * mult
            if mx is not None:
                # same delta the dict applies; the pop above corresponds to
                # the cell reaching exactly 0 (a removed file was added
                # with the same mult), so cells stay == dict.get(node, 0)
                mx.cell_sub(tid, node, mult, size * mult)
            if was_prep:
                prep = self._prep.get(tid)
                if prep is not None:
                    prep.discard(node)
                npt = self._node_prep_tasks.get(node)
                if npt is not None:
                    npt.discard(tid)
                self._dirty_tasks.add(tid)
        if drop_empty and not locs:
            self._locations.pop(file_id, None)

    # --------------------------------------------------------- task tracking
    def track_task(self, task_id: int, input_ids: tuple[int, ...]) -> None:
        """Register a (ready) task so its prepared-node set is maintained
        incrementally.  Input file sizes must be known (all inputs produced,
        which is exactly when a dynamic engine submits the task)."""
        if task_id in self._task_inputs:
            self.untrack_task(task_id)
        inputs = tuple(input_ids)
        mult: dict[int, int] = {}
        for f in inputs:
            mult[f] = mult.get(f, 0) + 1
        self._task_inputs[task_id] = inputs
        self._task_mult[task_id] = mult
        self._task_bytes[task_id] = sum(
            self._files[f].size for f in inputs if f in self._files)
        cnt: dict[NodeId, int] = {}
        pbytes: dict[NodeId, int] = {}
        for f, m in mult.items():
            self._waiting.setdefault(f, set()).add(task_id)
            size = self._files[f].size if f in self._files else 0
            for n in self._locations.get(f, _EMPTY):
                cnt[n] = cnt.get(n, 0) + m
                pbytes[n] = pbytes.get(n, 0) + size * m
        self._present_cnt[task_id] = cnt
        self._present_bytes[task_id] = pbytes
        if self._mx is not None:
            self._mx.track(task_id, cnt, pbytes)
        prep = {n for n, c in cnt.items() if c == len(inputs)}
        self._prep[task_id] = prep
        for n in prep:
            self._node_prep_tasks.setdefault(n, set()).add(task_id)
        self._dirty_tasks.add(task_id)
        if self._src_active:
            self._unsourced[task_id] = sum(
                1 for f in mult if self._free_rep.get(f, 0) == 0)
            self._blocked_dirty.add(task_id)

    def untrack_task(self, task_id: int) -> None:
        if self._mx is not None:
            self._mx.untrack(task_id)
        self._unsourced.pop(task_id, None)
        self._blocked_dirty.discard(task_id)
        self._task_inputs.pop(task_id, ())
        for f in self._task_mult.pop(task_id, {}):
            waiting = self._waiting.get(f)
            if waiting is not None:
                waiting.discard(task_id)
                if not waiting:
                    self._waiting.pop(f, None)
        self._present_cnt.pop(task_id, None)
        self._present_bytes.pop(task_id, None)
        self._task_bytes.pop(task_id, None)
        for n in self._prep.pop(task_id, _EMPTY):
            npt = self._node_prep_tasks.get(n)
            if npt is not None:
                npt.discard(task_id)
        self._dirty_tasks.discard(task_id)

    def tracked(self, task_id: int) -> bool:
        return task_id in self._task_inputs

    def drain_dirty_tasks(self) -> set[int]:
        """Tasks whose prepared-node set changed since the last drain."""
        dirty = self._dirty_tasks
        self._dirty_tasks = set()
        return dirty

    # ------------------------------------------- source-feasibility index
    def sync_free_sources(self, free_nodes) -> None:
        """Activate (or rebuild) the source-feasibility index against the
        scheduler's current free-COP-slot set.  The owner must afterwards
        mirror every slot transition via :meth:`note_source_freed` /
        :meth:`note_source_busy`."""
        self._src_active = True
        self._free_src = set(free_nodes)
        self._free_rep = {}
        for f, locs in self._locations.items():
            c = sum(1 for n in locs if n in self._free_src)
            if c:
                self._free_rep[f] = c
        for tid, mult in self._task_mult.items():
            self._unsourced[tid] = sum(
                1 for f in mult if self._free_rep.get(f, 0) == 0)
            self._blocked_dirty.add(tid)

    def note_source_freed(self, node: NodeId) -> None:
        """Node gained a free COP slot: its replicas became admissible."""
        if not self._src_active or node in self._free_src:
            return
        self._free_src.add(node)
        for f in self._node_files.get(node, _EMPTY):
            self._free_rep_up(f)

    def note_source_busy(self, node: NodeId) -> None:
        """Node lost its last free COP slot (or left the cluster)."""
        if not self._src_active or node not in self._free_src:
            return
        self._free_src.discard(node)
        for f in self._node_files.get(node, _EMPTY):
            self._free_rep_down(f)

    def cop_blocked(self, task_id: int) -> bool:
        """True iff every COP probe for the (tracked) task is provably
        infeasible under the mirrored free-slot set: some input has no
        replica on any free-slot node.  A feasible COP needs a free-slot
        *target* already holding every such unsourced input
        (:meth:`cop_feasible_targets`) -- but a free-slot node holding one
        would have made it sourced, a contradiction, so the candidate pool
        is empty whenever ``_unsourced > 0``.  With 0 every input is
        sourceable and the task must be probed."""
        return self._unsourced.get(task_id, 0) > 0

    def drain_blocked_dirty(self) -> set[int]:
        """Tracked tasks whose :meth:`cop_blocked` answer may have changed
        since the last drain."""
        dirty = self._blocked_dirty
        self._blocked_dirty = set()
        return dirty

    # ------------------------------------------------ indexed (fast) queries
    def is_prepared_task(self, task_id: int, node: NodeId) -> bool:
        return node in self._prep.get(task_id, _EMPTY)

    def prepared_nodes_task(self, task_id: int) -> list[NodeId]:
        """Nodes where every input of the (tracked) task is present, in
        canonical node order -- the order the reference scheduler's node
        scans produce, so candidate lists built from this match it."""
        prep = self._prep.get(task_id, _EMPTY)
        if self._node_order is None:
            return sorted(prep)
        return self._node_order.sort(prep)

    def prep_count(self, task_id: int) -> int:
        return len(self._prep.get(task_id, _EMPTY))

    def missing_bytes_task(self, task_id: int, node: NodeId) -> int:
        return (self._task_bytes[task_id]
                - self._present_bytes[task_id].get(node, 0))

    def prepared_node_set(self, task_id: int) -> frozenset | set:
        """Live prepared-node set of the (tracked) task -- the hot-path set
        form of :meth:`is_prepared_task` for callers filtering many nodes
        at once.  Read-only: callers must not mutate it."""
        return self._prep.get(task_id, _EMPTY)

    def task_input_bytes(self, task_id: int) -> int:
        """Total input bytes of the (tracked) task."""
        return self._task_bytes[task_id]

    def present_bytes_map(self, task_id: int) -> dict:
        """Live ``{node: bytes already present}`` of the (tracked) task
        (empty for tasks with no replica anywhere; with it and
        :meth:`task_input_bytes` callers batch-compute missing bytes
        without a method call per node).  Read-only."""
        return self._present_bytes[task_id]

    def tasks_prepared_on(self, node: NodeId) -> set[int]:
        # copy: handing out the live index would let callers corrupt it
        return set(self._node_prep_tasks.get(node, _EMPTY))

    def iter_tasks_prepared_on(self, node: NodeId):
        """Non-copying iteration over the tasks fully prepared on ``node``
        (hot-path variant of :meth:`tasks_prepared_on`; callers must not
        mutate the DPS while iterating)."""
        return iter(self._node_prep_tasks.get(node, _EMPTY))

    # ------------------------------------------------------------------ files
    def register_file(self, f: FileSpec, location: NodeId) -> None:
        """Called when a task finishes and its output stays on the producing
        node (§III-B: data is left where it was produced).  Re-registering a
        file (failure recovery re-runs the producer) resets its replica set
        to the new producing node."""
        for n in list(self._locations.get(f.id, _EMPTY)):
            self._idx_remove(f.id, n, drop_empty=False)
        self._files[f.id] = f
        self._locations.setdefault(f.id, set())
        self._idx_add(f.id, location)

    def file(self, file_id: int) -> FileSpec:
        return self._files[file_id]

    def has_file(self, file_id: int) -> bool:
        return file_id in self._files

    def file_ids(self) -> list[int]:
        """All registered file ids (registration order)."""
        return list(self._files)

    def locations(self, file_id: int) -> set[NodeId]:
        return set(self._locations.get(file_id, ()))

    def add_replica(self, file_id: int, node: NodeId) -> None:
        """Record one more valid replica (index-safe public mutator)."""
        self._idx_add(file_id, node)

    def remove_replica(self, file_id: int, node: NodeId,
                       drop_empty: bool = True) -> None:
        """Forget one replica (index-safe public mutator)."""
        self._idx_remove(file_id, node, drop_empty=drop_empty)

    def clear_replicas(self, file_id: int) -> None:
        """Remove every replica but keep an (empty) location entry -- the
        file exists in some external store only (e.g. the blob store)."""
        for n in list(self._locations.get(file_id, _EMPTY)):
            self._idx_remove(file_id, n, drop_empty=False)
        self._locations.setdefault(file_id, set())

    def drop_node(self, node: NodeId) -> list[int]:
        """A node left the cluster: forget all of its replicas.  Returns the
        (sorted) registered files whose *last* replica was lost."""
        lost: list[int] = []
        for fid in sorted(self._node_files.get(node, _EMPTY)):
            self._idx_remove(fid, node, drop_empty=False)
            if not self._locations.get(fid):
                self._locations.pop(fid, None)
                if fid in self._files:
                    lost.append(fid)
        self._node_files.pop(node, None)
        self._node_prep_tasks.pop(node, None)
        if self._mx is not None:
            self._mx.drop_node(node)
        return lost

    def invalidate(self, file_id: int, only_valid: NodeId) -> None:
        """File manipulated in place (§IV-B): one valid location remains."""
        self._idx_add(file_id, only_valid)
        for n in list(self._locations.get(file_id, _EMPTY)):
            if n != only_valid:
                self._idx_remove(file_id, n, drop_empty=False)

    def delete_replicas(self, file_id: int, keep: int = 0) -> int:
        """GC once all consumers are done; returns bytes reclaimed."""
        locs = self._locations.get(file_id)
        if not locs:
            return 0
        size = self._files[file_id].size
        drop = max(0, len(locs) - keep)
        for n in sorted(locs)[keep:]:
            self._idx_remove(file_id, n, drop_empty=False)
        if keep == 0:
            self._locations.pop(file_id, None)
        return drop * size

    def replica_count(self, file_id: int) -> int:
        return len(self._locations.get(file_id, ()))

    # ------------------------------------------- status (reference queries)
    # From-scratch recomputation over the replica sets.  These remain the
    # behavioural reference for the indexed fast path (equivalence-tested)
    # and the generic API for input tuples that are not tracked as a task.
    def is_prepared(self, input_ids: tuple[int, ...], node: NodeId) -> bool:
        """A node is *prepared* when every intermediate input has a valid
        replica on it (workflow inputs in the DFS are readable anywhere)."""
        return all(node in self._locations.get(f, ()) for f in input_ids)

    def prepared_nodes(self, input_ids: tuple[int, ...],
                       nodes: list[NodeId]) -> list[NodeId]:
        if not input_ids:
            return list(nodes)
        # intersect replica sets, iterating over the rarest file first
        sets = sorted((self._locations.get(f, set()) for f in input_ids),
                      key=len)
        inter = set(sets[0])
        for s in sets[1:]:
            inter &= s
            if not inter:
                return []
        return [n for n in nodes if n in inter]

    def missing_files(self, input_ids: tuple[int, ...],
                      node: NodeId) -> list[FileSpec]:
        return [self._files[f] for f in input_ids
                if node not in self._locations.get(f, ())]

    def missing_bytes(self, input_ids: tuple[int, ...], node: NodeId) -> int:
        return sum(f.size for f in self.missing_files(input_ids, node))

    # explicit aliases used by the equivalence tests / reference scheduler
    is_prepared_reference = is_prepared
    prepared_nodes_reference = prepared_nodes
    missing_bytes_reference = missing_bytes

    # ------------------------------------------------------------------- COPs
    def cop_feasible_targets(
        self,
        input_ids: tuple[int, ...],
        allowed_sources: set[NodeId] | None = None,
    ) -> set[NodeId] | None:
        """Prune the COP target search space for a given source restriction.

        Returns ``None`` when every input has at least one admissible source
        (no target constraint), otherwise the only nodes a feasible COP
        could target: nodes already holding *every* source-less input (a
        missing input with no admissible replica makes any other target
        infeasible).  ``allowed_sources=None`` means any replica is
        admissible, like in :meth:`plan_cop`.

        This is the single definition of COP source admissibility:
        ``plan_cop(task, inputs, n, allowed)`` returns a plan iff ``n`` is
        unconstrained here (a source that *is* the target cannot help,
        because then the file is not missing on the target).  Infeasible
        ``plan_cop`` calls are therefore side-effect-free and callers may
        skip them wholesale -- steps 2-3 use this to probe a handful of
        nodes instead of every free-slot node.
        """
        constraint: set[NodeId] | None = None
        for f in set(input_ids):
            srcs = self._locations.get(f, _EMPTY)
            if allowed_sources is None:
                if srcs:
                    continue
            elif any(s in allowed_sources for s in srcs):
                continue
            constraint = (set(srcs) if constraint is None
                          else constraint & srcs)
            if not constraint:
                return constraint            # empty: no feasible target
        return constraint

    def plan_cop(
        self,
        task_id: int,
        input_ids: tuple[int, ...],
        target: NodeId,
        allowed_sources: set[NodeId] | None = None,
        feasible_targets: set[NodeId] | None | object = _UNCHECKED,
    ) -> CopPlan | None:
        """Greedy COP construction for preparing ``task_id`` on ``target``.

        ``allowed_sources`` restricts source nodes (the scheduler passes the
        set of nodes with spare COP slots so c_node holds for sources too).
        Returns None when some missing file has no admissible replica.

        Infeasible requests are rejected *before* any transfer is built
        (via :meth:`cop_feasible_targets`, the one definition of source
        admissibility), so they consume neither a COP id nor tie-break
        randomness.  Steps 2-3 probe far more (task, target) pairs than
        they start COPs -- at 1024 nodes the probes dominate the whole
        scheduler iteration -- and this early exit makes a failed probe a
        few set lookups.  Callers that already computed the constraint for
        this (inputs, allowed_sources) pair can pass it as
        ``feasible_targets`` to skip the recomputation.  (Both scheduler
        implementations share this method, so their RNG streams stay
        identical and equivalence is preserved.)
        """
        feas = (self.cop_feasible_targets(input_ids, allowed_sources)
                if feasible_targets is _UNCHECKED else feasible_targets)
        if feas is not None and target not in feas:
            return None
        missing = sorted(self.missing_files(input_ids, target),
                         key=lambda f: (-f.size, f.id))
        topo = self._topo
        transfers: list[Transfer] = []
        load: dict[NodeId, int] = {}
        total = 0
        wtotal = 0.0
        for f in missing:
            srcs = self._locations.get(f.id, set())
            if allowed_sources is not None:
                srcs = {s for s in srcs if s in allowed_sources or s == target}
            else:
                srcs = set(srcs)
            srcs.discard(target)
            if not srcs:
                return None
            if topo is not None:
                # locality first: only minimum-distance replicas compete on
                # load (rack beats site beats WAN regardless of load)
                wbest = min(topo.weight(s, target) for s in srcs)
                srcs = {s for s in srcs if topo.weight(s, target) == wbest}
                wtotal += f.size * wbest
            lo = min(load.get(s, 0) for s in srcs)
            pool = [s for s in sorted(srcs) if load.get(s, 0) == lo]
            src = pool[self._rng.randrange(len(pool))] if len(pool) > 1 else pool[0]
            transfers.append(Transfer(f.id, f.size, src, target))
            load[src] = load.get(src, 0) + f.size
            total += f.size
        load[target] = total  # the target receives everything
        traffic = wtotal if topo is not None else total
        price = W_TRAFFIC * traffic + W_MAXLOAD * (max(load.values()) if load else 0)
        plan = CopPlan(id=self._next_cop_id, task_id=task_id, target=target,
                       transfers=transfers, price=price)
        self._next_cop_id += 1
        return plan

    def commit_cop(self, plan: CopPlan) -> None:
        """All-or-nothing replica registration on COP success (§IV-C)."""
        for t in plan.transfers:
            self._idx_add(t.file_id, t.dst)
        self.cop_bytes_total += plan.total_bytes

    # --------------------------------------------------------------- metrics
    def total_replica_bytes(self) -> int:
        return sum(self._files[f].size * len(locs)
                   for f, locs in self._locations.items()
                   if f in self._files)

    def unique_bytes(self) -> int:
        return sum(f.size for f in self._files.values())
