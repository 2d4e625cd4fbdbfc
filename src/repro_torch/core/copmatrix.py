"""Batched COP drain on torch tensors: the step-2/3 cost state, the blocked
placement kernel of ``repro/core/copmatrix.py``, and its winner reduction.

Steps 2-3 of the WOW scheduler (paper §IV-C) pick, per ready task, the
node to prepare it on.  The reference batches that inner machinery in numpy
arrays; here every array is a tensor on the scheduler's device, and each
decision is the reference's:

* :class:`CopMatrix` -- dense ``(tracked task row) x (node column)``
  mirrors of the DPS per-(task, node) present-input counters (int32) and
  present-byte totals (int64), kept by the DPS at its replica-mutation
  choke points with the same ``+- mult`` / ``+- size * mult`` deltas the
  dicts apply.  Column 0 is a permanent all-zero *null column*: a node
  holding no tracked bytes has no column and its gathers read 0 through it,
  which is the ``dict.get(node, 0)`` the dict oracle computes.
* :class:`SlotColMap` -- the cached ``capacity slot -> matrix column``
  translation, rebuilt when either side's version counter moves.
* :class:`BlockedDrainKernel` -- per step-2 task the candidate mask (free
  COP slot x free-resource fit x not inflight x not prepared), the cost row
  (missing bytes, or the locality-weighted cost under a topology) and the
  winner, the least key then the least node id (:func:`torch_winner`), so
  float ties split as the dict path's ``(cost, node)`` tuple sort does.
  Only the winner is then probed through the scalar ``plan_cop``.  Per
  step-3 task only the candidate mask is built here: every feasible probe
  consumes a COP id and possibly an RNG draw, so the probes stay scalar and
  in canonical slot order.

Keys stay in float64 or int64 (f32 would merge ties the tuple compare keeps
apart); the sentinels are ``inf`` for float keys and int64 max for int keys
and ids.  The locality cost row adds one file's contribution at a time in
``dps._task_mult[tid]`` order, so every element sees the dict oracle's
sequence of IEEE additions; a present holder contributes an exact ``0.0``,
and the weight class is chosen by ``where``/``minimum`` over integer counts
of rack / site / WAN holders, with no float arithmetic.  A reduction over
files would add in another order, and is not used.

Each scalar read of a CUDA tensor (``bool(mask.any())``, the winner's
``int``) is a sync, and each cell write a launch: on the card the drain is
bound by the host's launches of small operations.
"""
from __future__ import annotations

import math

import torch

from ..models.common import require_device, same_device
from .types import NodeId

_MIN_COLS = 16
_MIN_ROWS = 16
_BIG = torch.iinfo(torch.int64).max
_TENSOR_KEYS = (torch.float64, torch.int64)


class CopMatrix:
    """Dense mirrors of ``dps._present_cnt`` / ``dps._present_bytes`` on
    ``device``.

    Rows are tracked tasks, columns are nodes that hold (or held) tracked
    input bytes; both are allocated from free lists and recycled zeroed.
    Column 0 is the permanent null column, so ``col_of`` returning 0 means
    "no bytes anywhere" and gathers need no membership test.
    """

    def __init__(self, device="cpu") -> None:
        self.device = torch.device(device)
        self._row_of: dict[int, int] = {}
        self._col_of: dict[NodeId, int] = {}
        self._free_rows: list[int] = []
        self._free_cols: list[int] = []
        self._nrows = 0
        self._ncols = 1                       # col 0 = null column
        self._alloc()
        # bumped whenever the node->column mapping changes (new column
        # assigned or a column freed); SlotColMap rebuilds on it
        self.col_version = 0

    def _alloc(self) -> None:
        # counts fit int32 (bounded by len(task.inputs)); bytes need int64
        self.cnt = torch.zeros((_MIN_ROWS, _MIN_COLS), dtype=torch.int32,
                               device=self.device)
        self.pbytes = torch.zeros((_MIN_ROWS, _MIN_COLS), dtype=torch.int64,
                                  device=self.device)

    # ------------------------------------------------------------- mapping
    def row_of(self, task_id: int) -> int | None:
        return self._row_of.get(task_id)

    def col_of(self, node: NodeId) -> int:
        """Matrix column of ``node`` (0 = the null column: no bytes)."""
        return self._col_of.get(node, 0)

    def _ensure_col(self, node: NodeId) -> int:
        col = self._col_of.get(node)
        if col is not None:
            return col
        if self._free_cols:
            col = self._free_cols.pop()
        else:
            col = self._ncols
            self._ncols += 1
            if col >= self.cnt.shape[1]:
                self._grow(cols=True)
        self._col_of[node] = col
        self.col_version += 1
        return col

    def _grow(self, cols: bool) -> None:
        rows, ncols = self.cnt.shape
        shape = ((rows, max(_MIN_COLS, 2 * ncols)) if cols
                 else (max(_MIN_ROWS, 2 * rows), ncols))
        for name in ("cnt", "pbytes"):
            old = getattr(self, name)
            arr = torch.zeros(shape, dtype=old.dtype, device=self.device)
            arr[:rows, :ncols] = old
            setattr(self, name, arr)

    # ------------------------------------------------------- DPS choke hooks
    def cell_add(self, task_id: int, node: NodeId, d_cnt: int,
                 d_bytes: int) -> None:
        """``_idx_add`` delta for one (waiting task, node) pair -- the same
        ``+mult`` / ``+size*mult`` the dict indices apply."""
        row = self._row_of.get(task_id)
        if row is None:
            return
        col = self._ensure_col(node)
        self.cnt[row, col].add_(d_cnt)
        self.pbytes[row, col].add_(d_bytes)

    def cell_sub(self, task_id: int, node: NodeId, d_cnt: int,
                 d_bytes: int) -> None:
        """``_idx_remove`` delta.  The dict path pops entries when the
        count reaches 0; subtracting the same deltas leaves exactly 0 here,
        so the mirror invariant is cell == ``dict.get(node, 0)``."""
        row = self._row_of.get(task_id)
        if row is None:
            return
        col = self._col_of.get(node)
        if col is None:
            return
        self.cnt[row, col].sub_(d_cnt)
        self.pbytes[row, col].sub_(d_bytes)

    def track(self, task_id: int, cnt: dict[NodeId, int],
              pbytes: dict[NodeId, int]) -> None:
        """Copy the just-built ``track_task`` dicts into a fresh row (one
        scatter a tensor)."""
        if task_id in self._row_of:
            self.untrack(task_id)
        if self._free_rows:
            row = self._free_rows.pop()     # recycled rows are zeroed
        else:
            row = self._nrows
            self._nrows += 1
            if row >= self.cnt.shape[0]:
                self._grow(cols=False)
        self._row_of[task_id] = row
        if not cnt:
            return
        cols = [self._ensure_col(n) for n in cnt]
        at = torch.tensor(cols, dtype=torch.int64, device=self.device)
        self.cnt[row, at] = torch.tensor(
            list(cnt.values()), dtype=torch.int32).to(self.device)
        self.pbytes[row, at] = torch.tensor(
            [pbytes.get(n, 0) for n in cnt], dtype=torch.int64).to(self.device)

    def untrack(self, task_id: int) -> None:
        row = self._row_of.pop(task_id, None)
        if row is None:
            return
        self.cnt[row].zero_()
        self.pbytes[row].zero_()
        self._free_rows.append(row)

    def drop_node(self, node: NodeId) -> None:
        """Node left the cluster: free its column (``dps.drop_node``
        already zeroed every tracked cell through :meth:`cell_sub`; the
        explicit column clear below is defensive)."""
        col = self._col_of.pop(node, None)
        if col is None:
            return
        self.cnt[:, col] = 0
        self.pbytes[:, col] = 0
        self._free_cols.append(col)
        self.col_version += 1

    def rebuild(self, dps) -> None:
        """Full resync from the DPS dict indices (used when the matrix is
        enabled on a DPS that already tracks tasks, and by the tests as the
        from-scratch oracle)."""
        self._row_of.clear()
        self._col_of.clear()
        self._free_rows.clear()
        self._free_cols.clear()
        self._nrows = 0
        self._ncols = 1
        self._alloc()
        self.col_version += 1
        for tid, cnt in dps._present_cnt.items():
            self.track(tid, cnt, dps._present_bytes[tid])

    # ----------------------------------------------------------- validation
    def snapshot(self, task_id: int) -> tuple[dict, dict] | None:
        """``({node: cnt}, {node: pbytes})`` of one row, nonzero-count
        cells only -- the dict-index form the tests compare against
        ``dps._present_cnt`` / ``dps._present_bytes``."""
        row = self._row_of.get(task_id)
        if row is None:
            return None
        cnt_row = self.cnt[row].tolist()
        pb_row = self.pbytes[row].tolist()
        cnt_d: dict[NodeId, int] = {}
        pb_d: dict[NodeId, int] = {}
        for n, col in self._col_of.items():
            if cnt_row[col] > 0:
                cnt_d[n] = cnt_row[col]
                pb_d[n] = pb_row[col]
        return cnt_d, pb_d

    def check_against(self, dps) -> None:
        """Assert the full mirror invariant (test helper)."""
        assert set(self._row_of) == set(dps._present_cnt), (
            set(self._row_of), set(dps._present_cnt))
        for tid in self._row_of:
            snap = self.snapshot(tid)
            assert snap is not None
            cnt_d, pb_d = snap
            assert cnt_d == dps._present_cnt[tid], (tid, cnt_d)
            assert pb_d == dps._present_bytes[tid], (tid, pb_d)


class SlotColMap:
    """Cached ``capacity slot -> matrix column`` int64 translation on the
    matrix's device, rebuilt whenever the capacity array's slot map or the
    matrix's column map changed since the last refresh.  Dead slots may
    keep stale columns -- harmless, every kernel mask is rooted in
    ``cap.alive``."""

    def __init__(self, cap, mx: CopMatrix) -> None:
        self.cap = cap
        self.mx = mx
        self._cap_version = -1
        self._col_version = -1
        self._colv = torch.zeros(0, dtype=torch.int64, device=mx.device)

    def refresh(self) -> torch.Tensor:
        cap, mx = self.cap, self.mx
        if (self._cap_version != cap.version
                or self._col_version != mx.col_version):
            colv = [0] * len(cap.alive)
            col_of = mx._col_of
            for nid, s in cap.slot_of.items():
                c = col_of.get(nid)
                if c is not None:
                    colv[s] = c
            self._colv = torch.tensor(colv, dtype=torch.int64).to(mx.device)
            self._cap_version = cap.version
            self._col_version = mx.col_version
        return self._colv


class BlockedDrainKernel:
    """The blocked step-2/3 placement kernel (see module docstring).

    Owned by one scheduler; reads the scheduler's capacity array, the DPS
    matrix and the per-task inflight-target sets the scheduler maintains,
    all on one device.  ``begin()`` must be called once per ``schedule()``
    before the step-2/3 loops: it refreshes the slot->column map and drops
    the per-shape fit masks (free resources are frozen *during* steps 2-3
    but change between events).  COP-slot occupancy does change mid-loop
    (every ``_start_cop`` bumps ``active_cops``), so the free-slot mask is
    re-read for every task.
    """

    def __init__(self, cap, mx: CopMatrix, c_node: int,
                 inflight_by_task: dict[int, set[int]]) -> None:
        self.cap = cap
        self.mx = mx
        self.device = mx.device
        self.c_node = c_node
        self._inflight = inflight_by_task
        self._slotcol = SlotColMap(cap, mx)
        self._colv: torch.Tensor = self._slotcol.refresh()
        # per-shape masks, valid for one schedule() (cleared in begin())
        self._fit2: dict[tuple[int, float], torch.Tensor] = {}
        self._fit3: dict[tuple[int, float], torch.Tensor] = {}
        # per-slot locality tier ids, keyed on (topology, cap.version)
        self._tier_key: tuple | None = None
        self._racks: torch.Tensor | None = None
        self._sites: torch.Tensor | None = None
        self._winner = torch_winner(self.device)

    # ---------------------------------------------------------- per event
    def begin(self) -> None:
        self._colv = self._slotcol.refresh()
        self._fit2.clear()
        self._fit3.clear()

    # ------------------------------------------------------------- masks
    def _free_vec(self) -> torch.Tensor:
        cap = self.cap
        return cap.active_cops[:cap._n] < self.c_node

    def _fit2_mask(self, mem: int, cores: float) -> torch.Tensor:
        m = self._fit2.get((mem, cores))
        if m is None:
            m = self.cap.fit_mask(mem, cores)
            self._fit2[(mem, cores)] = m
        return m

    def _fit3_mask(self, mem: int, cores: float) -> torch.Tensor:
        m = self._fit3.get((mem, cores))
        if m is None:
            cap = self.cap
            n = cap._n
            m = (cap.alive[:n] & (cap.mem[:n] >= mem)
                 & (cap.cores[:n] >= cores))
            self._fit3[(mem, cores)] = m
        return m

    def _slots(self, nodes) -> torch.Tensor | None:
        slot_of = self.cap.slot_of
        slots = [s for h in nodes if (s := slot_of.get(h)) is not None]
        if not slots:
            return None
        return torch.tensor(slots, dtype=torch.int64, device=self.device)

    def _candidate_mask(self, tid: int, t, fit: torch.Tensor,
                        ) -> torch.Tensor | None:
        """fit x free COP slot x not prepared x not inflight, or None when
        the task has no matrix row (untracked: dict fallback)."""
        row = self.mx.row_of(tid)
        if row is None:
            return None
        n = self.cap._n
        cntv = self.mx.cnt[row][self._colv[:n]]
        # prepared <=> per-occurrence count == len(inputs), the dict
        # invariant (`_prep` membership); tracked tasks have >= 1 input so
        # null-column zeros can never look prepared
        mask = fit & self._free_vec() & (cntv != len(t.inputs))
        infl = self._inflight.get(tid)
        if infl:
            slots = self._slots(infl)
            if slots is not None:
                mask[slots] = False
        return mask

    # ---------------------------------------------------------- cost rows
    def _locality_cost_row(self, dps, tid: int) -> torch.Tensor:
        """Length-N locality-weighted missing-byte cost, bit-identical to
        ``dps.locality_missing_cost(tid, node)`` per element (same file
        iteration order, same IEEE additions -- see module docstring)."""
        topo = dps.topology
        n = self.cap._n
        racks, sites = self._slot_tiers(topo)
        spec = topo.spec
        f64 = dict(dtype=torch.float64, device=self.device)
        w_rack, w_site, w_wan, inf = (torch.tensor(float(w), **f64) for w in
                                      (spec.w_rack, spec.w_site, spec.w_wan,
                                       math.inf))
        maxw = topo.max_weight
        rps = topo.racks_per_site
        cost = torch.zeros(n, **f64)
        files = dps._files
        locations = dps._locations
        for f, m in dps._task_mult[tid].items():
            locs = locations.get(f)
            fspec = files.get(f)
            size = fspec.size if fspec is not None else 0
            sm = float(size * m)
            if not locs:
                # no holder anywhere: worst-case placement assumption
                cost += sm * maxw
                continue
            hr = torch.tensor([h // topo.rack_size for h in locs],
                              dtype=torch.int64, device=self.device)
            hs = hr // rps if rps > 0 else torch.zeros_like(hr)
            rack_cnt = (racks[:, None] == hr[None, :]).sum(dim=1)
            site_cnt = (sites[:, None] == hs[None, :]).sum(dim=1)
            # exact weight-class selection, no float arithmetic: a class is
            # available iff some holder sits at that distance; the classes
            # partition the holder count, so at least one is available and
            # no inf survives the minimum
            w = torch.where(rack_cnt > 0, w_rack, inf)
            w = torch.minimum(w, torch.where(site_cnt > rack_cnt, w_site, inf))
            w = torch.minimum(w, torch.where(site_cnt < len(locs), w_wan,
                                             inf))
            contrib = sm * w
            # present on the candidate itself: the dict loop skips the
            # file (contributes nothing); holders outside the slot map
            # (e.g. the NFS server) still count toward the classes
            slots = self._slots(locs)
            if slots is not None:
                contrib[slots] = 0.0
            cost += contrib
        return cost

    def _slot_tiers(self, topo) -> tuple[torch.Tensor, torch.Tensor]:
        cap = self.cap
        key = (id(topo), cap.version)
        if self._tier_key != key:
            ids = cap._node_of[:cap._n]
            racks = ids // topo.rack_size      # nonuniform => rack_size > 0
            rps = topo.racks_per_site
            sites = racks // rps if rps > 0 else torch.zeros_like(racks)
            self._racks, self._sites = racks, sites
            self._tier_key = key
        n = cap._n
        return self._racks[:n], self._sites[:n]

    # ------------------------------------------------------------ queries
    def step2_winner(self, tid: int, t, dps) -> int | None:
        """Node id the dict path's step-2 sort would probe first; None when
        the candidate set is empty (the oracle would start nothing either);
        -1 when the task has no matrix row -- the caller must fall back to
        the per-task oracle, which recomputes candidates from the dicts."""
        mask = self._candidate_mask(tid, t, self._fit2_mask(t.mem, t.cores))
        if mask is None:
            return -1
        if not bool(mask.any()):
            return None
        cap = self.cap
        n = cap._n
        if dps.topology is not None:
            key = torch.where(mask, self._locality_cost_row(dps, tid),
                              math.inf)
        else:
            # missing bytes == total - present; the null column makes the
            # gather read 0 for colless nodes, like dict.get(node, 0)
            row = self.mx.row_of(tid)
            tb = dps.task_input_bytes(tid)
            key = torch.where(mask, tb - self.mx.pbytes[row][self._colv[:n]],
                              _BIG)
        return self._winner(key, cap._node_of[:n])

    def step3_candidates(self, tid: int, t) -> list[int] | None:
        """Step-3 candidate node ids in canonical (slot) order, or None
        when the task has no matrix row.  Mask construction only: the
        caller must keep probing every candidate through the scalar
        ``plan_cop``."""
        mask = self._candidate_mask(tid, t, self._fit3_mask(t.mem, t.cores))
        if mask is None:
            return None
        cap = self.cap
        return cap._node_of[:cap._n][mask].tolist()


# ------------------------------------------------------- winner reduction
def _staged(key: torch.Tensor, ids: torch.Tensor) -> int:
    """The least id among the entries of least key: min key first, then
    min id among the ties -- the dict path's ``(cost, node)`` compare."""
    tie = key == key.min()
    return int(torch.where(tie, ids, _BIG).min())


def torch_winner(device="cuda"):
    """A callable ``(key, ids) -> int``: the least id among the entries of
    least key, computed on ``device`` (CUDA unless the caller names another;
    raises if CUDA is asked for and absent).

    ``key`` is a float64 or int64 tensor, ``ids`` an int64 tensor of the
    same shape, both on ``device``; any other dtype is refused.  The
    reference's JAX twin pads its inputs to a power of two to bound its
    traces; an eager reduction has no trace to bound, and needs no pad."""
    device = require_device(device)

    def winner(key: torch.Tensor, ids: torch.Tensor) -> int:
        if key.dtype not in _TENSOR_KEYS:
            raise TypeError(f"torch_winner takes float64 or int64 keys; got "
                            f"{key.dtype}")
        if ids.dtype != torch.int64 or ids.shape != key.shape:
            raise TypeError(f"ids must be int64 of the keys' shape "
                            f"{tuple(key.shape)}; got {ids.dtype} "
                            f"{tuple(ids.shape)}")
        if not (same_device(key.device, device)
                and same_device(ids.device, device)):
            raise ValueError(f"keys on {key.device} and ids on {ids.device}; "
                             f"this winner reduces on {device}")
        return _staged(key, ids)

    return winner
