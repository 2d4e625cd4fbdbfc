"""Vectorized hot node state: per-node free capacity as torch tensors on the
scheduler's device.

The reference's ``repro/core/nodearray.py`` keeps these mirrors in numpy
arrays; here they are tensors on the device the scheduler was built for
(``WowScheduler(device=...)``), and every masked query runs there.  The
slot map, the write-through points and the tie-breaks are the reference's:

* **Slot order is canonical order.**  Slots are append-only: the i-th live
  slot (in slot-index order) is the i-th node of the canonical
  ``readyset.NodeOrder`` enumeration.  ``add`` appends -- exactly like
  ``NodeOrder.add`` -- and ``drop`` marks a slot dead without moving the
  others, so the nonzero entries of a mask yield node candidates already in
  canonical order with no sort.  A node that re-joins after a failure gets
  a *fresh* slot at the end, matching ``NodeOrder``'s re-append semantics.
* **Dead slots are masked, then compacted.**  ``drop`` only clears the
  ``alive`` bit; when dead slots outnumber live ones the tensors are
  compacted in slot order, which preserves the canonical-order invariant.
* **Values are written through at the scheduler's choke points**
  (``on_task_finished``, step-1 reservations, ``_start_cop`` /
  ``on_cop_finished``, ``note_node_added`` / ``note_node_removed``), plus
  an idempotent ``refresh_many`` on the dirty-node drain, so tensor values
  equal the live ``NodeState`` values whenever a consumer reads them.

Dtypes are the reference's: memory and COP counts int64, cores float64,
so every comparison and floor division sees the values the dict path
reads.  Each scalar write or read of a CUDA tensor is a launch or a sync:
the per-event cost on the card is host-bound by design, and correctness,
not speed, is what this module asks of the card.
"""
from __future__ import annotations

from typing import Iterable

import torch

from .types import NodeId, NodeState

_MIN_COMPACT = 64

_FIELDS = (("_node_of", torch.int64), ("free_mem", torch.int64),
           ("free_cores", torch.float64), ("mem", torch.int64),
           ("cores", torch.float64), ("active_cops", torch.int64),
           ("alive", torch.bool))


class NodeCapacityArray:
    """Flat tensor mirrors of per-node hot state under a dense node->slot
    map, on ``device``."""

    def __init__(self, nodes: dict[int, NodeState], order: Iterable[NodeId],
                 c_node: int = 1, device="cpu") -> None:
        self.device = torch.device(device)
        self.c_node = c_node
        self.slot_of: dict[NodeId, int] = {}
        cap = max(16, 2 * len(nodes))
        for name, dt in _FIELDS:
            setattr(self, name, torch.zeros(cap, dtype=dt,
                                            device=self.device))
        self._n = 0          # slots handed out (live + dead)
        self._dead = 0
        # bumped whenever the node->slot mapping changes shape (append or
        # compaction); consumers caching slot-indexed derived tensors
        # (copmatrix.SlotColMap, tier ids) rebuild on it
        self.version = 0
        for nid in order:    # canonical enumeration = slot order
            self.add(nid, nodes[nid])

    # ------------------------------------------------------------- slot map
    def __len__(self) -> int:
        return self._n - self._dead

    def __contains__(self, node: NodeId) -> bool:
        return node in self.slot_of

    def add(self, node: NodeId, state: NodeState) -> None:
        """Append a slot for ``node`` (idempotent: a live node is
        refreshed in place, like ``NodeOrder.add``)."""
        if node in self.slot_of:
            self.refresh_from(node, state)
            return
        if self._n == len(self.alive):
            self._grow()
        s = self._n
        self._n += 1
        self.version += 1
        self.slot_of[node] = s
        self._node_of[s] = node
        self.alive[s] = True
        self._write(s, state)

    def drop(self, node: NodeId) -> None:
        s = self.slot_of.pop(node, None)
        if s is None:
            return
        self.alive[s] = False
        self._dead += 1
        if self._dead > max(_MIN_COMPACT, self._n - self._dead):
            self._compact()

    def _grow(self) -> None:
        new = max(16, 2 * len(self.alive))
        for name, dt in _FIELDS:
            old = getattr(self, name)
            arr = torch.zeros(new, dtype=dt, device=self.device)
            arr[:len(old)] = old
            setattr(self, name, arr)

    def _compact(self) -> None:
        """Drop dead slots; live slots keep their relative (= canonical)
        order, so queries are unaffected."""
        keep = torch.nonzero(self.alive[:self._n]).flatten()
        m = len(keep)
        for name, _ in _FIELDS[:-1]:
            arr = getattr(self, name)
            arr[:m] = arr[keep]
        self.alive[:m] = True
        self.alive[m:self._n] = False
        self._n = m
        self._dead = 0
        self.version += 1
        ids = self._node_of[:m].tolist()
        self.slot_of = {nid: i for i, nid in enumerate(ids)}

    # --------------------------------------------------------- write-through
    def _write(self, slot: int, state: NodeState) -> None:
        self.free_mem[slot] = state.free_mem
        self.free_cores[slot] = state.free_cores
        self.mem[slot] = state.mem
        self.cores[slot] = state.cores
        self.active_cops[slot] = state.active_cops

    def refresh_from(self, node: NodeId, state: NodeState) -> None:
        self._write(self.slot_of[node], state)

    def refresh_many(self, nodes: Iterable[NodeId],
                     states: dict[int, NodeState]) -> None:
        """One batch pass over the dirty nodes (unknown/removed ids are
        skipped -- their ``drop`` already happened): one scatter a field."""
        so = self.slot_of
        rows = [(s, st) for n in nodes
                if (s := so.get(n)) is not None
                and (st := states.get(n)) is not None]
        if not rows:
            return
        slots = torch.tensor([s for s, _ in rows], dtype=torch.int64,
                             device=self.device)
        for name, dt in _FIELDS[1:-1]:
            vals = torch.tensor([getattr(st, name) for _, st in rows],
                                dtype=dt).to(self.device)
            getattr(self, name)[slots] = vals

    def set_free(self, node: NodeId, free_mem: int, free_cores: float) -> None:
        s = self.slot_of[node]
        self.free_mem[s] = free_mem
        self.free_cores[s] = free_cores

    def add_cops(self, node: NodeId, delta: int) -> None:
        s = self.slot_of.get(node)
        if s is not None:
            self.active_cops[s] += delta

    # --------------------------------------------------------------- queries
    def _live(self) -> torch.Tensor:
        return self.alive[:self._n]

    def _ids_of(self, mask: torch.Tensor) -> list[NodeId]:
        return self._node_of[:self._n][mask].tolist()

    def fit_mask(self, mem: int, cores: float) -> torch.Tensor:
        n = self._n
        return (self._live() & (self.free_mem[:n] >= mem)
                & (self.free_cores[:n] >= cores))

    def fitting(self, mem: int, cores: float) -> list[NodeId]:
        """All nodes whose free resources fit ``(mem, cores)``, in canonical
        order (slot order *is* canonical order -- no sort)."""
        return self._ids_of(self.fit_mask(mem, cores))

    def fitting_with_slots(self, mem: int,
                           cores: float) -> tuple[list[NodeId], torch.Tensor]:
        slots = torch.nonzero(self.fit_mask(mem, cores)).flatten()
        return self._node_of[slots].tolist(), slots

    def any_fit(self, mem: int, cores: float) -> bool:
        return bool(self.fit_mask(mem, cores).any())

    def free_slot_fit_ids(self, mem: int, cores: float) -> list[NodeId]:
        """Free-COP-slot nodes whose *free* resources fit -- the step-2
        candidate pool scan, in canonical order."""
        n = self._n
        mask = (self._live() & (self.active_cops[:n] < self.c_node)
                & (self.free_mem[:n] >= mem) & (self.free_cores[:n] >= cores))
        return self._ids_of(mask)

    def free_slot_total_fit_ids(self, mem: int, cores: float) -> list[NodeId]:
        """Free-COP-slot nodes whose *total* capacity could ever run the
        task -- the step-3 candidate pool scan, in canonical order."""
        n = self._n
        mask = (self._live() & (self.active_cops[:n] < self.c_node)
                & (self.mem[:n] >= mem) & (self.cores[:n] >= cores))
        return self._ids_of(mask)

    def filter_fitting(self, cands: list[NodeId], mem: int,
                       cores: float) -> list[NodeId]:
        """``cands`` restricted to nodes whose free resources fit -- the
        `ilp._feasible` candidate filter as one masked gather.  Returns the
        input list unchanged (no copy) when everything fits."""
        if not cands:
            return cands
        slots = self.slots_of(cands)
        keep = (self.free_mem[slots] >= mem) & (self.free_cores[slots] >= cores)
        if bool(keep.all()):
            return cands
        return [n for n, ok in zip(cands, keep.tolist()) if ok]

    def slots_of(self, nodes: list[NodeId]) -> torch.Tensor:
        so = self.slot_of
        return torch.tensor([so[n] for n in nodes], dtype=torch.int64,
                            device=self.device)

    # ------------------------------------------------------------ validation
    def snapshot(self) -> dict[int, tuple[int, float, int]]:
        """Live ``{node: (free_mem, free_cores, active_cops)}`` -- what the
        tests compare against a from-scratch rebuild."""
        fm, fc, ac = (t.tolist() for t in
                      (self.free_mem, self.free_cores, self.active_cops))
        return {nid: (fm[s], fc[s], ac[s]) for nid, s in self.slot_of.items()}

    def live_ids(self) -> list[NodeId]:
        """Live node ids in slot (= canonical) order."""
        return self._ids_of(self._live())


class ArrayCapacityClasses:
    """`readyset.CapacityClasses` facade over a :class:`NodeCapacityArray`:
    same refresh/drop/fitting/any_fit surface, answered by masked tensor
    queries instead of capacity-class dict walks."""

    def __init__(self, cap: NodeCapacityArray,
                 nodes: dict[int, NodeState]) -> None:
        self._cap = cap
        self._nodes = nodes

    def refresh(self, node: NodeId) -> None:
        state = self._nodes.get(node)
        if state is None:
            self._cap.drop(node)
        else:
            self._cap.refresh_from(node, state)

    def refresh_many(self, nodes: Iterable[NodeId]) -> None:
        self._cap.refresh_many(nodes, self._nodes)

    def drop(self, node: NodeId) -> None:
        self._cap.drop(node)

    def fitting(self, mem: int, cores: float) -> list[NodeId]:
        return self._cap.fitting(mem, cores)

    def fitting_with_slots(self, mem: int, cores: float):
        return self._cap.fitting_with_slots(mem, cores)

    def any_fit(self, mem: int, cores: float) -> bool:
        return self._cap.any_fit(mem, cores)
