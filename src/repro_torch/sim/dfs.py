"""Distributed file system models (paper §II-C, §V-B): the reference's
``repro/sim/dfs.py``.  Placement draws stay a ``random.Random(seed)``, so a
run places every replica where the reference places it.

Two backends, matching the paper's evaluation:

* ``NfsModel``  -- one dedicated server node (the paper's 9th node with the
  NVMe SSD); every DFS byte crosses the server's NIC -> the single-point
  bottleneck the paper observes.
* ``CephModel`` -- object store striped over the compute nodes with a
  replication factor (paper: 2).  Writes push to ``replication`` pseudo-
  randomly chosen nodes; reads pull from the closest replica (local if
  possible, else a random replica).

Both expose the *link paths* a read/write of a file needs, so the flow-level
network model prices them.

Replica lifecycle under churn (DESIGN.md "Failure-aware DFS replication"):

``CephModel`` is failure-aware.  The placement universe is the *live* node
list (``fail_node`` shrinks it, ``add_node`` -- elastic join -- extends it),
so new writes never land on dead nodes.  Reads are served from a surviving
replica; a read of an under-replicated object (a replica lost, repair not
yet committed) is counted as *degraded*.  ``fail_node`` returns repair plans
(survivor -> new holder) for every under-replicated object; the engine
prices them through the ``FlowManager`` so re-replication traffic contends
with workflow COPs and task I/O, and calls ``commit_repair`` when the bytes
have actually moved -- only then does the new holder serve reads.  All RNG
draws on the failure/repair path happen strictly after the first failure, so
failure-free runs consume the exact same ``random.Random`` stream as the
pre-churn model (bit-identical placements, equivalence-tested against
goldens in ``tests/test_dfs_churn.py``).

The NFS server is never a failure target in this model (matching the paper's
setup, where the dedicated NVMe server is not part of the compute pool), so
``NfsModel`` keeps the no-op lifecycle of the base class.
"""
from __future__ import annotations

import random

from .network import LinkId

# (file_id, src, dst, size): move one replica from a surviving holder to a
# new holder; the engine turns it into a priced repair flow
RepairSpec = tuple[int, int, int, int]


class DfsModel:
    name = "dfs"

    # churn counters (overridden per-instance by failure-aware backends)
    degraded_reads: int = 0
    degraded_read_bytes: float = 0.0
    lost_files: frozenset[int] = frozenset()

    def write_paths(self, file_id: int, size: int,
                    writer: int) -> list[tuple[tuple[LinkId, ...], float]]:
        raise NotImplementedError

    def read_paths(self, file_id: int, size: int,
                   reader: int) -> list[tuple[tuple[LinkId, ...], float]]:
        raise NotImplementedError

    def input_read_paths(self, size: int,
                         reader: int) -> list[tuple[tuple[LinkId, ...], float]]:
        """Workflow *input* data (pre-loaded into the DFS)."""
        raise NotImplementedError

    def stored_bytes_per_node(self) -> dict[int, int]:
        return {}

    # ------------------------------------------------------ replica lifecycle
    def fail_node(self, node: int) -> tuple[list[RepairSpec], list[int]]:
        """Node left the cluster.  Returns ``(repairs, aborted)``:
        ``repairs`` are new re-replication transfers to launch and
        ``aborted`` the file ids of in-flight repairs that touched the dead
        node (their flows must be cancelled; replacements, if any, appear in
        ``repairs``).  Default: placement is node-independent, nothing to do.
        """
        return [], []

    def add_node(self, node: int) -> None:
        """Elastic join: extend the placement universe for new writes."""

    def commit_repair(self, file_id: int, dst: int) -> list[RepairSpec]:
        """A repair transfer finished; ``dst`` now serves reads.  Returns
        follow-up repairs if the object is still under-replicated."""
        return []

    def reroute_read(self, size: float,
                     reader: int) -> list[tuple[tuple[LinkId, ...], float]]:
        """Re-issue an in-flight read whose source node died (the engine
        restarts the transfer from scratch on a surviving source)."""
        return []


class NfsModel(DfsModel):
    name = "nfs"

    def __init__(self, server: int) -> None:
        self.server = server
        self._sizes: dict[int, int] = {}

    def write_paths(self, file_id, size, writer):
        self._sizes[file_id] = size
        return [((("up", writer), ("down", self.server), ("dw", self.server)),
                 float(size))]

    def read_paths(self, file_id, size, reader):
        return [((("dr", self.server), ("up", self.server), ("down", reader)),
                 float(size))]

    def input_read_paths(self, size, reader):
        if size <= 0:
            return []
        return [((("dr", self.server), ("up", self.server), ("down", reader)),
                 float(size))]

    def stored_bytes_per_node(self):
        return {self.server: sum(self._sizes.values())}

    def reroute_read(self, size, reader):
        # the server never fails; a re-issued read takes the same path
        return self.read_paths(-1, size, reader)


class CephModel(DfsModel):
    name = "ceph"

    def __init__(self, n_nodes: int, replication: int = 2,
                 seed: int = 0, topology=None) -> None:
        self.n_nodes = n_nodes
        self.replication = min(replication, n_nodes)
        self._rng = random.Random(seed)
        # hierarchical topology (sim/topology.py): replicas spread across
        # racks (CRUSH-style failure domains) and reads pick the nearest
        # replica.  None -- or a flat topology -- keeps every code path and
        # RNG draw bit-identical to the pre-topology model (golden-tested).
        self._topo = topology if (topology is not None
                                  and topology.nonuniform) else None
        # live placement universe, in join order; failure-free it is exactly
        # [0..n_nodes) so rng.sample draws the pre-churn bit stream
        self._nodes: list[int] = list(range(n_nodes))
        self._placement: dict[int, tuple[int, ...]] = {}
        self._sizes: dict[int, int] = {}
        # replica count the file was placed with; the repair target.  A
        # later elastic join must not retroactively mark old files
        # under-replicated, nor a shrink below `replication` strand repairs.
        self._intended: dict[int, int] = {}
        # file -> (src, dst) of its single in-flight repair
        self._pending_repair: dict[int, tuple[int, int]] = {}
        # files whose every replica died before a repair could run; reads
        # are served best-effort (see read_paths) and counted
        self.lost_files: set[int] = set()
        self.degraded_reads = 0
        self.degraded_read_bytes = 0.0

    # -------------------------------------------------------------- placement
    def _place_spread(self, k: int) -> tuple[int, ...]:
        """Rack-aware placement: each successive replica prefers a rack not
        already holding one (CRUSH-style failure-domain spreading), with a
        uniform seeded draw inside the candidate pool."""
        topo = self._topo
        chosen: list[int] = []
        used_racks: set[int] = set()
        pool = list(self._nodes)
        for _ in range(k):
            cands = [n for n in pool if topo.rack_of(n) not in used_racks]
            if not cands:
                cands = pool
            n = cands[self._rng.randrange(len(cands))]
            chosen.append(n)
            pool.remove(n)
            used_racks.add(topo.rack_of(n))
        return tuple(chosen)

    def _place(self, file_id: int) -> tuple[int, ...]:
        reps = self._placement.get(file_id)
        if reps is None:
            k = min(self.replication, len(self._nodes))
            if self._topo is None:
                reps = tuple(self._rng.sample(self._nodes, k))
            else:
                reps = self._place_spread(k)
            self._placement[file_id] = reps
            self._intended[file_id] = k
        return reps

    def _target(self, file_id: int) -> int:
        """Replica count a repair restores: the placement-time intent,
        capped by the current live-node count."""
        return min(self._intended.get(file_id, self.replication),
                   len(self._nodes))

    def _under_replicated(self, file_id: int) -> bool:
        return len(self._placement.get(file_id, ())) < self._target(file_id)

    @staticmethod
    def _read_path(src: int, reader: int,
                   size: float) -> tuple[tuple[LinkId, ...], float]:
        if src == reader:
            return ((("dr", reader),), float(size))
        return ((("dr", src), ("up", src), ("down", reader)), float(size))

    def _pick_live_source(self, reader: int) -> int:
        """A live node to read from, avoiding the reader when another
        exists (same rejection-sampling RNG pattern the pre-churn
        input_read_paths used, so failure-free draws are bit-identical)."""
        n = len(self._nodes)
        r = self._nodes[self._rng.randrange(n)]
        while r == reader and n > 1:
            r = self._nodes[self._rng.randrange(n)]
        return r

    def write_paths(self, file_id, size, writer):
        self._sizes[file_id] = size
        if self._placement.get(file_id) == ():
            # every replica died: the re-write re-places the object fresh
            del self._placement[file_id]
        self.lost_files.discard(file_id)
        paths = []
        for r in self._place(file_id):
            if r == writer:
                paths.append(((("dw", r),), float(size)))
            else:
                paths.append(((("up", writer), ("down", r), ("dw", r)),
                              float(size)))
        return paths

    def read_paths(self, file_id, size, reader):
        replicas = self._place(file_id)
        if self._under_replicated(file_id):
            # a replica died and its repair has not committed yet (or the
            # object was lost outright): the read is degraded
            self.degraded_reads += 1
            self.degraded_read_bytes += size
        if not replicas:
            # every replica died before re-replication could run.  The data
            # is gone; serve the read from an arbitrary live node so the
            # simulation can proceed, and record the loss.
            self.lost_files.add(file_id)
            return [self._read_path(self._pick_live_source(reader), reader,
                                    size)]
        if reader in replicas:
            r = reader
        elif self._topo is not None:
            # nearest-replica read: among minimum-distance replicas, seeded
            # uniform tie-break (no draw when the choice is forced)
            topo = self._topo
            best = min(topo.distance(s, reader) for s in replicas)
            pool = [s for s in replicas if topo.distance(s, reader) == best]
            r = pool[self._rng.randrange(len(pool))] if len(pool) > 1 \
                else pool[0]
        else:
            r = replicas[self._rng.randrange(len(replicas))]
        return [self._read_path(r, reader, size)]

    def input_read_paths(self, size, reader):
        # workflow inputs are striped across the cluster; on average a
        # replication/n fraction is local
        if size <= 0:
            return []
        n = len(self._nodes)
        local = size * min(1.0, self.replication / n)
        remote = size - local
        paths: list[tuple[tuple[LinkId, ...], float]] = []
        if local > 0:
            paths.append(((("dr", reader),), local))
        if remote > 0:
            paths.append(self._read_path(self._pick_live_source(reader),
                                         reader, remote))
        return paths

    def reroute_read(self, size, reader):
        self.degraded_reads += 1
        self.degraded_read_bytes += size
        return [self._read_path(self._pick_live_source(reader), reader,
                                size)]

    def stored_bytes_per_node(self):
        out: dict[int, int] = {}
        for fid, replicas in self._placement.items():
            size = self._sizes.get(fid, 0)
            for r in replicas:
                out[r] = out.get(r, 0) + size
        return out

    # ------------------------------------------------------ replica lifecycle
    def _plan_repair(self, file_id: int) -> RepairSpec | None:
        """One survivor -> new-holder transfer for an under-replicated
        object; at most one repair is in flight per object."""
        reps = self._placement.get(file_id, ())
        if not reps or file_id in self._pending_repair:
            return None
        if len(reps) >= self._target(file_id):
            return None
        holders = set(reps)
        cands = [n for n in self._nodes if n not in holders]
        if not cands:
            return None
        if self._topo is None:
            src = reps[self._rng.randrange(len(reps))]
            dst = cands[self._rng.randrange(len(cands))]
        else:
            # restore the failure-domain spread: land the new replica in a
            # rack not already holding one (when possible), then serve it
            # from the closest surviving holder
            topo = self._topo
            holder_racks = {topo.rack_of(r) for r in reps}
            dpool = [n for n in cands
                     if topo.rack_of(n) not in holder_racks] or cands
            dst = dpool[self._rng.randrange(len(dpool))]
            best = min(topo.distance(s, dst) for s in reps)
            spool = [s for s in reps if topo.distance(s, dst) == best]
            src = spool[self._rng.randrange(len(spool))] if len(spool) > 1 \
                else spool[0]
        self._pending_repair[file_id] = (src, dst)
        return (file_id, src, dst, self._sizes.get(file_id, 0))

    def fail_node(self, node):
        if node not in self._nodes:
            return [], []
        self._nodes.remove(node)
        aborted: list[int] = []
        for fid, (src, dst) in list(self._pending_repair.items()):
            if src == node or dst == node:
                del self._pending_repair[fid]
                aborted.append(fid)
        affected: list[int] = []
        for fid, reps in self._placement.items():
            if node in reps:
                survivors = tuple(r for r in reps if r != node)
                self._placement[fid] = survivors
                affected.append(fid)
                if not survivors and fid not in self._pending_repair:
                    self.lost_files.add(fid)
        repairs: list[RepairSpec] = []
        for fid in affected + aborted:
            spec = self._plan_repair(fid)
            if spec is not None:
                repairs.append(spec)
        return repairs, aborted

    def add_node(self, node):
        if node not in self._nodes:
            self._nodes.append(node)

    def commit_repair(self, file_id, dst):
        self._pending_repair.pop(file_id, None)
        reps = self._placement.get(file_id, ())
        if dst not in reps:
            self._placement[file_id] = reps + (dst,)
        spec = self._plan_repair(file_id)
        return [spec] if spec is not None else []
