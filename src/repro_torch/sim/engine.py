"""Discrete-event cluster simulator.

Reproduces the paper's execution environment (§V-B) in virtual time: 8 nodes
x (16 cores, 128 GB, SATA SSD 537/402 MB/s), 1 or 2 Gbit network, Ceph
(rep 2) or NFS (dedicated NVMe server node), and runs a dynamic workflow
under one of the three strategies (orig / cws / wow).

Beyond the paper: node failure injection + elastic node join, exercising the
DPS's replica recovery (the paper's §VIII future work) and the DFS's
failure-aware replica lifecycle -- degraded reads off surviving replicas and
background re-replication priced through the shared flow network
(DESIGN.md "Failure-aware DFS replication").

This is the reference's ``repro/sim/engine.py`` on the port's scheduler
core.  ``Simulation``, ``run_workflow`` and ``run_traffic`` take a
``device`` (CUDA unless the caller names another; raises without a card):
the WOW scheduler's node state, COP matrix and drain, and the flow
network's dense fill, are tensors there.  Events, timers, flows and the
DFS stay plain Python, ordered as the reference orders them, so a run's
``SimResult`` and ``action_log`` are the reference's field for field.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

from ..core import (DFS_LOC, FileSpec, NodeOrder, NodeState, StartCop,
                    StartTask, TaskSpec, abstract_ranks, assign_priorities)
from ..core.types import CopPlan
from ..models.common import require_device
from .dfs import CephModel, DfsModel, NfsModel
from .metrics import SimResult, TrafficResult, compute_traffic_result, gini
from .network import FlowManager, ReferenceFlowManager, build_links
from .strategies import BaseStrategy, WowStrategy, make_strategy
from .topology import Topology, TopologySpec
from .traffic import ArrivalSpec, InstanceRecord, TrafficConfig, \
    arrival_schedule
from .workflow import Workflow

GiB = 1024 ** 3
EPS = 1e-9


@dataclasses.dataclass
class SimConfig:
    n_nodes: int = 8
    cores: float = 16.0
    mem: int = 128 * GiB
    disk_read_bw: float = 537e6          # paper's SATA SSD
    disk_write_bw: float = 402e6
    net_bw: float = 125e6                # 1 Gbit
    dfs: str = "ceph"                    # "ceph" | "nfs"
    nfs_disk_read_bw: float = 3.0e9      # paper's NVMe server
    nfs_disk_write_bw: float = 2.5e9
    ceph_replication: int = 2
    c_node: int = 1
    c_task: int = 2
    seed: int = 0
    gc_replicas: bool = False            # paper kept all replicas
    # run on the retained pre-refactor implementations (equivalence tests)
    reference_flow: bool = False         # ReferenceFlowManager
    reference_core: bool = False         # ReferenceWowScheduler inside wow
    # per-recompute allocator: "heap" (incremental bottleneck selection) or
    # "scan" (retained pre-heap progressive fill -- the pre-PR engine, kept
    # as the equivalence reference and the sim_throughput baseline)
    flow_fill: str = "heap"
    # vectorized hot node state in the wow scheduler (tensors on the
    # simulation's device); False = retained dict oracle.  Decisions are
    # bit-identical either way (DESIGN.md "Vectorized hot state").
    vectorized: bool = True
    # batched COP drain in the wow scheduler: None = auto (on exactly when
    # vectorized), False = per-task dict oracle.  Decisions are
    # bit-identical in all modes (DESIGN.md "Batched COP drain").
    batched: bool | None = None
    # hierarchical topology (sim/topology.py): nodes -> racks -> sites with
    # oversubscribed shared links.  None -- or a flat spec (single rack) --
    # keeps the engine bit-identical to the pre-topology goldens.
    topology: TopologySpec | None = None


@dataclasses.dataclass
class _TaskRun:
    task: TaskSpec
    node: int
    phase: str                  # read | compute | write
    pending: set[int]
    start: float
    flows: set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _CopRun:
    plan: CopPlan
    pending: set[int]
    flows: set[int] = dataclasses.field(default_factory=set)


class DeadlockError(RuntimeError):
    pass


class Simulation:
    def __init__(self, wf: Workflow | None, cfg: SimConfig,
                 strategy: str = "wow",
                 traffic: TrafficConfig | None = None, *,
                 device="cuda") -> None:
        # where the scheduler's and the dense fill's tensors lie; not a
        # SimConfig field, so the config stays the reference's
        self.device = require_device(device)
        # open-loop traffic mode (DESIGN.md "Open-loop traffic"): workflows
        # arrive over virtual time as seeded arrival events instead of (or
        # in addition to) one workflow submitted at t=0.  With ``traffic``
        # absent or disabled the engine is byte-for-byte the single-run
        # engine: the hooks below are no-ops, decisions are bit-identical
        # (golden-tested in tests/test_traffic.py).
        self.traffic = traffic if (traffic is not None
                                   and traffic.enabled) else None
        if wf is None:
            wf = Workflow("traffic", {}, {}, {})
        wf.validate()
        self.wf = wf
        self.cfg = cfg
        self.time = 0.0
        self.nodes: dict[int, NodeState] = {
            i: NodeState(i, cfg.mem, cfg.cores) for i in range(cfg.n_nodes)
        }
        # canonical node enumeration order, owned by the engine and shared
        # with scheduler/DPS: semantically `list(self.nodes)`, so a node
        # may re-join under its old (lower) id and every layer still
        # enumerates it last, like the reference scheduler's dict scans
        self.node_order = NodeOrder(self.nodes)
        # hierarchical topology: dropped entirely when flat (single rack),
        # the one gate that keeps every downstream layer on the pre-topology
        # code paths (and RNG streams) bit-identically
        self.topo: Topology | None = None
        if cfg.topology is not None:
            topo = Topology(cfg.topology, cfg.n_nodes, cfg.net_bw)
            if topo.nonuniform:
                self.topo = topo
        self.tier_bytes: dict[str, float] = {}
        self.strategy: BaseStrategy = make_strategy(
            strategy, self.nodes, c_node=cfg.c_node, c_task=cfg.c_task,
            seed=cfg.seed, reference_core=cfg.reference_core,
            node_order=self.node_order, vectorized=cfg.vectorized,
            topology=self.topo, batched=cfg.batched, device=self.device)

        extra: tuple[int, ...] = ()
        self.nfs_server = cfg.n_nodes
        if cfg.dfs == "nfs":
            extra = (self.nfs_server,)
            self.dfs: DfsModel = NfsModel(self.nfs_server)
        elif cfg.dfs == "ceph":
            self.dfs = CephModel(cfg.n_nodes, cfg.ceph_replication, cfg.seed,
                                 topology=self.topo)
        else:
            raise ValueError(f"unknown dfs {cfg.dfs!r}")
        caps = build_links(cfg.n_nodes, cfg.net_bw, cfg.disk_read_bw,
                           cfg.disk_write_bw, extra_nodes=extra,
                           extra_net_bw=cfg.net_bw,
                           extra_disk_read_bw=cfg.nfs_disk_read_bw,
                           extra_disk_write_bw=cfg.nfs_disk_write_bw,
                           topology=self.topo)
        if cfg.reference_flow:
            self.fm: FlowManager | ReferenceFlowManager = \
                ReferenceFlowManager(caps)
        else:
            self.fm = FlowManager(caps, fill=cfg.flow_fill,
                                  device=self.device)

        self.ranks = abstract_ranks(wf.abstract_edges)
        self.file_sizes = {f.id: f.size for f in wf.files.values()}
        self.produced: set[int] = set()
        self.remaining_inputs = {t.id: len(t.inputs)
                                 for t in wf.tasks.values()}
        self.task_runs: dict[int, _TaskRun] = {}
        self.pending: set[int] = set()      # submitted, not yet started
        self.cop_runs: dict[int, _CopRun] = {}
        self.timers: list[tuple[float, int, str, object]] = []
        self._seq = 0
        self.done_tasks: dict[int, tuple[float, float, int]] = {}  # id->(s,e,node)
        self.failed_nodes: set[int] = set()
        # DFS churn subsystem: in-flight repair flows + read-flow context
        # (task, file-or-None, size) so reads off a dead source can be
        # re-issued from a surviving replica
        self.repair_flows: dict[int, tuple[int, int, float]] = {}
        self._repair_flow_by_fid: dict[int, int] = {}
        self._read_ctx: dict[int, tuple[int, int | None, float]] = {}
        self.rereplication_bytes = 0.0
        self.repairs_completed = 0
        # stats
        self.network_bytes = 0.0
        self.storage_per_node: dict[int, float] = {}
        self.cpu_per_node: dict[int, float] = {}
        self.completed_cops: dict[int, tuple[CopPlan, float]] = {}
        self.used_cops: set[int] = set()
        self.tasks_no_cop = 0
        self._scheduled_failures: list[tuple[float, int]] = []
        self._scheduled_joins: list[tuple[float, int]] = []
        self.steps_executed = 0              # engine loop steps (events/sec)
        # (time, kind, task id, node) per applied action -- equivalence tests
        self.action_log: list[tuple[float, str, int, int]] = []
        # ------------------------------------------------ open-loop traffic
        # per-instance lifecycle bookkeeping; empty/inert without traffic
        self._instances: dict[int, InstanceRecord] = {}
        self._task_instance: dict[int, int] = {}
        self._instance_abstracts: dict[int, set[str]] = {}
        self._rejections: list[tuple[float, str]] = []
        self._depth_samples: list[tuple[float, int, int]] = []
        self._live_instances = 0
        self._retired_instances = 0
        # closed-loop retry (TenantSpec.retry): scheduled re-submissions
        self._retries: list[tuple[float, str]] = []
        self._tenant_retry = ({t.name: t.retry for t in self.traffic.tenants
                               if t.retry is not None}
                              if self.traffic else {})
        # per-arrival scheduler-churn samples (dirty sets, solver, flows)
        self._churn_samples: list[dict] = []
        # id-namespace allocation cursors: instance k's local ids are
        # rebased onto [base, base+span) so concurrent instances never
        # collide with each other or with a t=0 workflow
        self._next_task_base, self._next_file_base = wf.id_bounds()
        # first-completion aggregates that survive instance retirement
        self._tt_tasks_done = 0
        self._tt_cpu_seconds = 0.0
        self._tt_min_start = math.inf
        self._tt_max_end = 0.0
        self._arrival_specs: list[ArrivalSpec] = (
            arrival_schedule(self.traffic) if self.traffic else [])

    # ------------------------------------------------------------- plumbing
    def _push_timer(self, t: float, kind: str, payload: object) -> None:
        self._seq += 1
        heapq.heappush(self.timers, (t, self._seq, kind, payload))

    def _add_flow(self, links, nbytes: float, tag) -> int | None:
        if nbytes <= 0:
            return None
        links = tuple(links)
        if self.topo is not None:
            # splice rack/core/WAN links into every up->down hop; a
            # same-rack transfer expands to itself
            links = self.topo.expand(links)
        f = self.fm.add(links, nbytes, tag)
        if any(l[0] == "up" for l in links):
            self.network_bytes += nbytes
            if self.topo is not None:
                tier = self.topo.tier(links)
                self.tier_bytes[tier] = (self.tier_bytes.get(tier, 0.0)
                                         + nbytes)
        return f.id

    def _drop_flow(self, flow_id: int) -> None:
        """Deliberately abort an in-flight flow (node failure): refund the
        bytes it never moved so network_bytes keeps meaning 'bytes that
        crossed a NIC' even when transfers are cut short or restarted."""
        f = self.fm.flows.get(flow_id)
        if f is None:
            return
        if any(l[0] == "up" for l in f.links):
            unsent = self.fm.unsent(flow_id)
            self.network_bytes -= unsent
            if self.topo is not None:
                self.tier_bytes[self.topo.tier(f.links)] -= unsent
        self.fm.remove(flow_id)
        self._read_ctx.pop(flow_id, None)

    def schedule_failure(self, t: float, node: int) -> None:
        self._scheduled_failures.append((t, node))

    def schedule_join(self, t: float, node_id: int) -> None:
        self._scheduled_joins.append((t, node_id))

    # ------------------------------------------------------------- lifecycle
    def _submit(self, task: TaskSpec) -> None:
        self.pending.add(task.id)
        assign_priorities([task], self.ranks, self.file_sizes)
        self.strategy.submit(task)

    def _submit_initial(self) -> None:
        for t in self.wf.tasks.values():
            if self.remaining_inputs[t.id] == 0:
                self._submit(t)

    def _iterate(self) -> None:
        for act in self.strategy.schedule():
            if isinstance(act, StartTask):
                self.action_log.append((self.time, "task", act.task_id,
                                        act.node))
                # the sim never declines: ack immediately (no-op by the
                # adapter contract -- resources were reserved at schedule())
                self.strategy.task_started(act.task_id, act.node)
                self._start_task(act.task_id, act.node)
            elif isinstance(act, StartCop):
                self.action_log.append((self.time, "cop", act.plan.task_id,
                                        act.plan.target))
                self._start_cop(act.plan)

    def _start_task(self, tid: int, node: int) -> None:
        self.pending.discard(tid)
        task = self.wf.tasks[tid]
        run = _TaskRun(task, node, "read", set(), self.time)
        self.task_runs[tid] = run
        if self.traffic is not None:
            iid = self._task_instance.get(tid)
            if iid is not None:
                rec = self._instances[iid]
                if rec.first_start_t is None:
                    rec.first_start_t = self.time
        if isinstance(self.strategy, WowStrategy):
            dps = self.strategy.dps
            assert dps.is_prepared(task.inputs, node), (
                f"scheduler started task {tid} on unprepared node {node}")
            needed = False
            for cid, (plan, _) in self.completed_cops.items():
                if plan.target != node:
                    continue
                files = {t.file_id for t in plan.transfers}
                if files & set(task.inputs):
                    self.used_cops.add(cid)
                if plan.task_id == tid:
                    needed = True
            if not needed:
                self.tasks_no_cop += 1
        # read phase flows
        if self.strategy.local_io:
            local_bytes = sum(self.file_sizes[f] for f in task.inputs)
            fid = self._add_flow((("dr", node),), local_bytes,
                                 ("taskread", tid))
            if fid is not None:
                run.pending.add(fid)
            for links, size in self.dfs.input_read_paths(task.dfs_inputs,
                                                         node):
                fid = self._add_flow(links, size, ("taskread", tid))
                if fid is not None:
                    run.pending.add(fid)
                    self._read_ctx[fid] = (tid, None, size)
        else:
            for f in task.inputs:
                for links, size in self.dfs.read_paths(f, self.file_sizes[f],
                                                       node):
                    fid = self._add_flow(links, size, ("taskread", tid))
                    if fid is not None:
                        run.pending.add(fid)
                        self._read_ctx[fid] = (tid, f, size)
            for links, size in self.dfs.input_read_paths(task.dfs_inputs,
                                                         node):
                fid = self._add_flow(links, size, ("taskread", tid))
                if fid is not None:
                    run.pending.add(fid)
                    self._read_ctx[fid] = (tid, None, size)
        run.flows |= run.pending
        if not run.pending:
            self._begin_compute(tid)

    def _begin_compute(self, tid: int) -> None:
        run = self.task_runs[tid]
        run.phase = "compute"
        if run.task.compute_time > 0:
            self._push_timer(self.time + run.task.compute_time,
                             "compute", tid)
        else:
            self._begin_write(tid)

    def _begin_write(self, tid: int) -> None:
        run = self.task_runs[tid]
        run.phase = "write"
        task, node = run.task, run.node
        out_bytes = sum(self.file_sizes[f] for f in task.outputs)
        if self.strategy.local_io:
            total = out_bytes + task.dfs_outputs
            fid = self._add_flow((("dw", node),), total, ("taskwrite", tid))
            if fid is not None:
                run.pending.add(fid)
            self.storage_per_node[node] = (
                self.storage_per_node.get(node, 0.0) + total)
        else:
            # storage accounting is NOT done here: the DFS's placement map
            # (dfs.stored_bytes_per_node) is authoritative -- it tracks
            # replica loss and re-replication, which write-time accounting
            # cannot -- and is merged into the storage Gini in _result()
            for f in task.outputs:
                for links, size in self.dfs.write_paths(f, self.file_sizes[f],
                                                        node):
                    fid = self._add_flow(links, size, ("taskwrite", tid))
                    if fid is not None:
                        run.pending.add(fid)
            if task.dfs_outputs:
                for links, size in self.dfs.write_paths(-tid - 1,
                                                        task.dfs_outputs,
                                                        node):
                    fid = self._add_flow(links, size, ("taskwrite", tid))
                    if fid is not None:
                        run.pending.add(fid)
        run.flows |= run.pending
        if not run.pending:
            self._finish_task(tid)

    def _finish_task(self, tid: int) -> None:
        run = self.task_runs.pop(tid)
        task, node = run.task, run.node
        self.done_tasks[tid] = (run.start, self.time, node)
        self.cpu_per_node[node] = (self.cpu_per_node.get(node, 0.0)
                                   + (self.time - run.start) * task.cores)
        if self.traffic is not None:
            self._traffic_task_done(tid, run.start, self.time, task.cores)
        self.strategy.task_finished(tid, node)
        if isinstance(self.strategy, WowStrategy):
            for f in task.outputs:
                self.strategy.dps.register_file(self.wf.files[f], node)
        for f in task.outputs:
            self.produced.add(f)
        for f in task.outputs:
            for consumer in self.wf.files[f].consumers:
                self.remaining_inputs[consumer] = sum(
                    1 for g in self.wf.tasks[consumer].inputs
                    if g not in self.produced)
                if (self.remaining_inputs[consumer] == 0
                        and consumer not in self.pending
                        and consumer not in self.task_runs
                        and consumer not in self.done_tasks):
                    self._submit(self.wf.tasks[consumer])
        if self.cfg.gc_replicas and isinstance(self.strategy, WowStrategy):
            for f in task.inputs:
                if all(c in self.done_tasks
                       for c in self.wf.files[f].consumers):
                    self.strategy.dps.delete_replicas(f, keep=0)

    def _start_cop(self, plan: CopPlan) -> None:
        cop = _CopRun(plan, set())
        self.cop_runs[plan.id] = cop
        for tr in plan.transfers:
            links = (("dr", tr.src), ("up", tr.src), ("down", tr.dst),
                     ("dw", tr.dst))
            fid = self._add_flow(links, tr.size, ("cop", plan.id))
            if fid is not None:
                cop.pending.add(fid)
                self.storage_per_node[tr.dst] = (
                    self.storage_per_node.get(tr.dst, 0.0) + tr.size)
        cop.flows |= cop.pending
        if not cop.pending:
            self._finish_cop(plan.id, ok=True)

    def _finish_cop(self, cop_id: int, ok: bool) -> None:
        cop = self.cop_runs.pop(cop_id)
        if ok:
            self.completed_cops[cop_id] = (cop.plan, self.time)
        self.strategy.cop_finished(cop.plan, ok)

    # ----------------------------------------------------- failure/elastic
    def _fail_node(self, node: int) -> None:
        """Node leaves the cluster: abort its running tasks (resubmitted),
        abort COPs touching it, shrink the resource pool, and drive the
        DFS replica lifecycle.

        Under the WOW strategy the node's intermediate replicas are dropped
        and lost files are recovered by re-running their producers.  Under
        orig/cws all intermediate data lives in the DFS, which is
        failure-aware: the dead node's replicas are gone, in-flight reads
        off the node restart from a surviving replica (degraded reads),
        writes to the dead replica are dropped, and each under-replicated
        object schedules a repair flow (survivor -> new holder) priced
        through the FlowManager so re-replication traffic contends with
        workflow COPs and task I/O."""
        self.failed_nodes.add(node)
        # abort running tasks on the node
        for tid, run in list(self.task_runs.items()):
            if run.node != node:
                continue
            for fl in run.flows:
                self._drop_flow(fl)
            self.task_runs.pop(tid)
            # frees resources on the (soon-removed) node
            self.strategy.task_finished(tid, node)
            self._resubmit(self.wf.tasks[tid])
        # abort COPs touching the node
        for cid, cop in list(self.cop_runs.items()):
            if node in cop.plan.nodes:
                for fl in cop.flows:
                    self._drop_flow(fl)
                self.cop_runs.pop(cid)
                self.strategy.cop_finished(cop.plan, ok=False)
        # DFS replica lifecycle: drop dead replicas, plan repairs, cancel
        # in-flight repairs that touched the node (replacements included in
        # `repairs`), then redirect surviving tasks' I/O off the dead node
        repairs, aborted = self.dfs.fail_node(node)
        for fid in aborted:
            fl = self._repair_flow_by_fid.pop(fid, None)
            if fl is not None:
                self._drop_flow(fl)
                self.repair_flows.pop(fl, None)
        self._redirect_node_io(node)
        lost: list[int] = []
        if isinstance(self.strategy, WowStrategy):
            # drop replicas (index-safe); recover lost files by re-running
            # their producers
            lost = self.strategy.dps.drop_node(node)
        self.nodes.pop(node, None)
        self.node_order.discard(node)
        self.strategy.node_removed(node)
        for spec in repairs:
            self._launch_repair(*spec)
        for f in lost:
            self._recover_file(f)

    def _redirect_node_io(self, node: int) -> None:
        """Re-route in-flight task I/O of *surviving* tasks that crossed the
        dead node.  Reads restart from scratch on a surviving replica (the
        DFS already excludes the dead node and counts the degraded read);
        writes to the dead replica are dropped -- the repair subsystem
        restores redundancy from the surviving copy."""
        for fl in self.fm.flows_on_node(node):
            f = self.fm.flows.get(fl)
            if f is None:
                continue
            kind = f.tag[0]
            if kind not in ("taskread", "taskwrite"):
                continue
            tid = f.tag[1]
            run = self.task_runs.get(tid)
            if run is None or run.node == node:
                continue
            ctx = self._read_ctx.get(fl)
            self._drop_flow(fl)
            run.pending.discard(fl)
            run.flows.discard(fl)
            if kind == "taskread" and ctx is not None:
                _, file_id, size = ctx
                if file_id is not None:
                    paths = self.dfs.read_paths(file_id, size, run.node)
                else:
                    paths = self.dfs.reroute_read(size, run.node)
                for links, sz in paths:
                    nf = self._add_flow(links, sz, ("taskread", tid))
                    if nf is not None:
                        run.pending.add(nf)
                        run.flows.add(nf)
                        self._read_ctx[nf] = (tid, file_id, sz)
            if not run.pending:
                if run.phase == "read":
                    self._begin_compute(tid)
                elif run.phase == "write":
                    self._finish_task(tid)

    def _launch_repair(self, file_id: int, src: int, dst: int,
                       size: float) -> None:
        links = (("dr", src), ("up", src), ("down", dst), ("dw", dst))
        fl = self._add_flow(links, size, ("repair", file_id))
        if fl is None:                  # zero-byte object: instant repair
            self.repairs_completed += 1
            for spec in self.dfs.commit_repair(file_id, dst):
                self._launch_repair(*spec)
            return
        self.repair_flows[fl] = (file_id, dst, size)
        self._repair_flow_by_fid[file_id] = fl

    def _recover_file(self, file_id: int, force: bool = False) -> None:
        """Re-execute the producer (transitively) of a lost file.

        ``force``: the file is needed as a *recursive* dependency of another
        recovery even if all of its direct consumers already finished."""
        spec = self.wf.files[file_id]
        if not force and all(c in self.done_tasks for c in spec.consumers):
            return
        producer = self.wf.tasks[spec.producer]
        if producer.id in self.task_runs or producer.id in self.pending:
            return  # already being re-run / queued
        # invalidate its outputs; consumers recompute readiness lazily
        for f in producer.outputs:
            self.produced.discard(f)
        for f in producer.outputs:
            for c in self.wf.files[f].consumers:
                if c not in self.done_tasks:
                    self.remaining_inputs[c] = sum(
                        1 for g in self.wf.tasks[c].inputs
                        if g not in self.produced)
        popped = self.done_tasks.pop(producer.id, None)
        if popped is not None and self.traffic is not None:
            self._traffic_task_undone(producer.id, popped, producer.cores)
        dps = self.strategy.dps
        missing = [f for f in producer.inputs if not dps.locations(f)]
        self.remaining_inputs[producer.id] = len(missing)
        for f in missing:
            self._recover_file(f, force=True)
        if not missing:
            self._submit(producer)

    def _resubmit(self, task: TaskSpec) -> None:
        popped = self.done_tasks.pop(task.id, None)
        if popped is not None and self.traffic is not None:
            self._traffic_task_undone(task.id, popped, task.cores)
        self._submit(task)

    def _join_node(self, node_id: int) -> None:
        self.nodes[node_id] = NodeState(node_id, self.cfg.mem, self.cfg.cores)
        self.node_order.add(node_id)
        for kind, bw in (("up", self.cfg.net_bw), ("down", self.cfg.net_bw),
                         ("dr", self.cfg.disk_read_bw),
                         ("dw", self.cfg.disk_write_bw)):
            self.fm.capacities[(kind, node_id)] = bw
        if self.topo is not None:
            # a join may open a brand-new rack/site: materialise its links
            self.topo.ensure_node(node_id, self.fm.capacities)
        self.dfs.add_node(node_id)      # joins the placement universe
        self.strategy.node_added(node_id)

    # -------------------------------------------------- open-loop traffic
    def _sample_depth(self) -> None:
        self._depth_samples.append((self.time, len(self.pending),
                                    self._live_instances))

    def _on_arrival(self, spec: ArrivalSpec) -> None:
        """Workflow arrival event: admission gate, then id-namespacing and
        merge into the engine's (shared) workflow view.

        The arrival stream is pre-generated by ``arrival_schedule`` at
        ``run()``; only the admission decision depends on engine state."""
        tr = self.traffic
        self._sample_depth()
        if (tr.max_backlog is not None
                and self._live_instances >= tr.max_backlog):
            self._rejections.append((self.time, spec.tenant))
            policy = self._tenant_retry.get(spec.tenant)
            if policy is not None and spec.attempt + 1 < policy.max_attempts:
                # closed-loop client: re-submit the same instance (same
                # index / workflow / builder seed) after a seeded backoff
                delay = policy.delay(spec.seed, spec.attempt)
                retry = dataclasses.replace(spec, attempt=spec.attempt + 1)
                self._retries.append((self.time + delay, spec.tenant))
                self._push_timer(self.time + delay, "arrive", retry)
            return
        from ..workloads import make_workflow  # lazy: package cycle
        template = make_workflow(spec.workflow, scale=spec.scale,
                                 seed=spec.seed)
        prefix = f"{spec.tenant}/{spec.index}:"
        t_base, f_base = self._next_task_base, self._next_file_base
        t_span, f_span = template.id_bounds()
        self._next_task_base += t_span
        self._next_file_base += f_span
        inst = template.namespaced(t_base, f_base, prefix)
        rec = InstanceRecord(
            id=spec.index, tenant=spec.tenant, workflow=spec.workflow,
            arrival_t=self.time, n_tasks=len(inst.tasks),
            task_ids=frozenset(inst.tasks), remaining=len(inst.tasks),
            attempts=spec.attempt + 1)
        self._instances[spec.index] = rec
        self._instance_abstracts[spec.index] = set(inst.abstract_edges)
        self._live_instances += 1
        # merge the namespaced instance into the engine's merged view; the
        # prefixed abstract names keep per-instance rank DAGs independent
        self.wf.tasks.update(inst.tasks)
        self.wf.files.update(inst.files)
        self.wf.abstract_edges.update(inst.abstract_edges)
        self.ranks.update(abstract_ranks(inst.abstract_edges))
        for f in inst.files.values():
            self.file_sizes[f.id] = f.size
        for t in inst.tasks.values():
            self.remaining_inputs[t.id] = len(t.inputs)
            self._task_instance[t.id] = spec.index
        for t in inst.tasks.values():
            if self.remaining_inputs[t.id] == 0:
                self._submit(t)
        # cross-workflow churn profile: sample the scheduler's dirty sets
        # and cumulative solver/flow counters right after the arrival lands
        # (before the next iterate() drains them)
        sample: dict = {"t": self.time, "instance": spec.index}
        sample.update(self.strategy.churn_probe())
        if hasattr(self.fm, "health"):
            sample["flow_recomputes"] = int(self.fm.health()["recomputes"])
        self._churn_samples.append(sample)

    def _traffic_task_done(self, tid: int, start: float, end: float,
                           cores: float) -> None:
        self._tt_tasks_done += 1
        self._tt_cpu_seconds += (end - start) * cores
        self._tt_min_start = min(self._tt_min_start, start)
        self._tt_max_end = max(self._tt_max_end, end)
        iid = self._task_instance.get(tid)
        if iid is None:
            return
        rec = self._instances[iid]
        if rec.completed_t is not None:     # post-completion recovery re-run
            return
        rec.cpu_seconds += (end - start) * cores
        rec.remaining -= 1
        if rec.remaining == 0:
            rec.completed_t = end
            self._live_instances -= 1
            self._sample_depth()
            # retire event: reclaim the instance's engine/DPS state.  The
            # completion metrics are already recorded on the InstanceRecord.
            self._push_timer(end, "retire", iid)

    def _traffic_task_undone(self, tid: int, done: tuple, cores: float) -> None:
        """A previously-done task re-runs (failure recovery): roll the
        first-completion accounting back unless its instance already
        completed (a completed instance keeps its recorded latency)."""
        iid = self._task_instance.get(tid)
        if iid is None:
            return
        rec = self._instances[iid]
        if rec.completed_t is not None:
            return
        s, e, _ = done
        rec.cpu_seconds -= (e - s) * cores
        rec.remaining += 1

    def _retire_instance(self, iid: int) -> None:
        """Retire event: drop the completed instance's task/file specs from
        the merged workflow view and release its DPS-tracked replicas, so a
        long-running service holds state proportional to the *live* backlog
        only.  DFS-resident bytes persist (written data outlives the run,
        and the placement map stays authoritative for storage metrics)."""
        rec = self._instances[iid]
        if any(t in self.task_runs or t in self.pending
               for t in rec.task_ids):
            return      # failure recovery re-opened the instance; keep it
        wow = isinstance(self.strategy, WowStrategy)
        for tid in rec.task_ids:
            task = self.wf.tasks.pop(tid, None)
            if task is None:
                continue
            self.done_tasks.pop(tid, None)
            self.remaining_inputs.pop(tid, None)
            self._task_instance.pop(tid, None)
            self.strategy.forget_task(tid)
            for f in task.outputs:
                if wow:
                    self.strategy.dps.delete_replicas(f, keep=0)
                self.wf.files.pop(f, None)
                self.file_sizes.pop(f, None)
                self.produced.discard(f)
        for a in self._instance_abstracts.pop(iid, ()):
            self.wf.abstract_edges.pop(a, None)
            self.ranks.pop(a, None)
        self._retired_instances += 1

    def _traffic_incomplete(self) -> list[dict]:
        """Why did admitted instances not finish?  Residual task states per
        unfinished instance -- the admission gate may shed load at the
        door, but an admitted instance must complete or be explained."""
        out: list[dict] = []
        for rec in self._instances.values():
            if rec.completed_t is not None:
                continue
            running = sum(1 for t in rec.task_ids if t in self.task_runs)
            queued = sum(1 for t in rec.task_ids if t in self.pending)
            done = sum(1 for t in rec.task_ids if t in self.done_tasks)
            blocked = rec.n_tasks - running - queued - done
            if queued:
                reason = "queued: no node ever fit / scheduler never started"
            elif running:
                reason = "running at horizon"
            else:
                reason = "blocked: inputs never produced"
            out.append({"id": rec.id, "tenant": rec.tenant,
                        "workflow": rec.workflow,
                        "arrival_t": rec.arrival_t, "done": done,
                        "running": running, "queued": queued,
                        "blocked": blocked, "reason": reason})
        return out

    def _churn_summary(self) -> dict:
        """Aggregate the per-arrival churn samples: dirty-set statistics
        plus cumulative-counter-per-arrival rates, and the raw samples (the
        arrival stream is bounded, so the list stays small)."""
        samples = self._churn_samples
        if not samples:
            return {}
        out: dict = {"arrivals_sampled": len(samples)}
        dirty = [s["dirty_tasks"] for s in samples if "dirty_tasks" in s]
        if dirty:
            out["dirty_tasks_mean"] = sum(dirty) / len(dirty)
            out["dirty_tasks_max"] = max(dirty)
        for key, rate_key in (("solver_events", "solver_events_per_arrival"),
                              ("flow_recomputes",
                               "flow_recomputes_per_arrival")):
            vals = [s[key] for s in samples if key in s]
            if vals:
                out[rate_key] = vals[-1] / len(vals)
        out["samples"] = samples
        return out

    def traffic_result(self) -> TrafficResult:
        if self.traffic is None:
            raise RuntimeError("simulation was not run with a TrafficConfig")
        return compute_traffic_result(
            self.traffic, sorted(self._instances.values(),
                                 key=lambda r: r.id),
            self._rejections, self._depth_samples, end_time=self.time,
            incomplete=self._traffic_incomplete(),
            retries=self._retries, churn=self._churn_summary())

    # ------------------------------------------------------------------ run
    def run(self, max_steps: int = 50_000_000) -> SimResult:
        for t, n in self._scheduled_failures:
            self._push_timer(t, "fail", n)
        for t, n in self._scheduled_joins:
            self._push_timer(t, "join", n)
        for spec in self._arrival_specs:
            self._push_timer(spec.time, "arrive", spec)
        self._submit_initial()
        self._iterate()
        steps = 0
        while True:
            steps += 1
            self.steps_executed = steps
            if steps > max_steps:
                raise RuntimeError("simulation step budget exceeded")
            self.fm.recompute()
            dt, _ = self.fm.next_completion()
            t_flow = self.time + dt if dt != math.inf else math.inf
            t_timer = self.timers[0][0] if self.timers else math.inf
            t_next = min(t_flow, t_timer)
            if t_next == math.inf:
                break
            completed = self.fm.advance(max(t_next - self.time, 0.0))
            self.time = t_next
            progressed = False
            for f in completed:
                self._on_flow_done(f)
                progressed = True
            while self.timers and self.timers[0][0] <= self.time + EPS:
                _, _, kind, payload = heapq.heappop(self.timers)
                self._on_timer(kind, payload)
                progressed = True
            if progressed:
                self._iterate()
        if self.traffic is None and len(self.done_tasks) != len(self.wf.tasks):
            missing = set(self.wf.tasks) - set(self.done_tasks)
            raise DeadlockError(
                f"{len(missing)} tasks never completed, e.g. "
                f"{sorted(missing)[:5]} (running={list(self.task_runs)[:5]})")
        return self._result()

    def _on_flow_done(self, flow) -> None:
        kind, ident = flow.tag
        if kind == "taskread":
            self._read_ctx.pop(flow.id, None)
            run = self.task_runs.get(ident)
            if run is None:
                return
            run.pending = {f for f in run.pending if f in self.fm.flows}
            if not run.pending:
                self._begin_compute(ident)
        elif kind == "taskwrite":
            run = self.task_runs.get(ident)
            if run is None:
                return
            run.pending = {f for f in run.pending if f in self.fm.flows}
            if not run.pending:
                self._finish_task(ident)
        elif kind == "cop":
            cop = self.cop_runs.get(ident)
            if cop is None:
                return
            cop.pending = {f for f in cop.pending if f in self.fm.flows}
            if not cop.pending:
                self._finish_cop(ident, ok=True)
        elif kind == "repair":
            info = self.repair_flows.pop(flow.id, None)
            if info is None:
                return
            file_id, dst, size = info
            self._repair_flow_by_fid.pop(file_id, None)
            self.rereplication_bytes += size
            self.repairs_completed += 1
            for spec in self.dfs.commit_repair(file_id, dst):
                self._launch_repair(*spec)

    def _on_timer(self, kind: str, payload) -> None:
        if kind == "compute":
            if payload in self.task_runs:
                self._begin_write(payload)
        elif kind == "fail":
            self._fail_node(payload)
        elif kind == "join":
            self._join_node(payload)
        elif kind == "arrive":
            self._on_arrival(payload)
        elif kind == "retire":
            self._retire_instance(payload)

    # -------------------------------------------------------------- metrics
    def _result(self) -> SimResult:
        if self.traffic is not None:
            # retired instances left done_tasks/wf.tasks; the engine kept
            # running first-completion aggregates instead
            makespan = ((self._tt_max_end - self._tt_min_start)
                        if self._tt_tasks_done else 0.0)
            cpu_hours = self._tt_cpu_seconds / 3600.0
            tasks_total = self._tt_tasks_done
        else:
            starts = [s for s, _, _ in self.done_tasks.values()]
            ends = [e for _, e, _ in self.done_tasks.values()]
            makespan = (max(ends) - min(starts)) if ends else 0.0
            cpu_hours = sum((e - s) * self.wf.tasks[t].cores
                            for t, (s, e, _)
                            in self.done_tasks.items()) / 3600.0
            tasks_total = len(self.done_tasks)
        unique = sum(f.size for f in self.wf.files.values())
        cop_bytes = 0
        cops_created = 0
        if isinstance(self.strategy, WowStrategy):
            cop_bytes = self.strategy.dps.cop_bytes_total
            cops_created = self.strategy.sched.cops_created
        # the engine's actual surviving node set -- includes elastic-join
        # nodes (ids >= n_nodes), excludes failed ones; the NFS server is
        # never in self.nodes
        node_ids = sorted(self.nodes)
        # engine-side storage (WOW local writes, COP landings) merged with
        # the DFS's authoritative per-node replica bytes
        storage = dict(self.storage_per_node)
        for n, b in self.dfs.stored_bytes_per_node().items():
            storage[n] = storage.get(n, 0.0) + b
        lost_files = len(self.dfs.lost_files)
        # flow-manager health (zeros on the counter-less frozen reference)
        fm_health = (self.fm.health() if hasattr(self.fm, "health")
                     else {"recomputes": 0, "compactions": 0,
                           "mean_component": 0.0})
        return SimResult(
            workflow=self.wf.name,
            strategy=self.strategy.name,
            dfs=self.cfg.dfs,
            n_nodes=self.cfg.n_nodes,
            makespan=makespan,
            cpu_alloc_hours=cpu_hours,
            tasks_total=tasks_total,
            tasks_no_cop=self.tasks_no_cop,
            cops_created=cops_created,
            cops_used=len(self.used_cops),
            cop_bytes=cop_bytes,
            unique_intermediate_bytes=unique,
            network_bytes=self.network_bytes,
            gini_storage=gini([storage.get(n, 0.0) for n in node_ids]),
            gini_cpu=gini([self.cpu_per_node.get(n, 0.0)
                           for n in node_ids]),
            degraded_reads=self.dfs.degraded_reads,
            degraded_read_bytes=self.dfs.degraded_read_bytes,
            rereplication_bytes=self.rereplication_bytes,
            repairs_completed=self.repairs_completed,
            dfs_lost_files=lost_files,
            sim_steps=self.steps_executed,
            flow_recomputes=int(fm_health["recomputes"]),
            flow_compactions=int(fm_health["compactions"]),
            flow_mean_component=float(fm_health["mean_component"]),
            tier_bytes=dict(self.tier_bytes),
        )


def run_workflow(wf: Workflow, strategy: str, cfg: SimConfig | None = None,
                 *, device="cuda", **cfg_overrides) -> SimResult:
    cfg = dataclasses.replace(cfg or SimConfig(), **cfg_overrides)
    return Simulation(wf, cfg, strategy, device=device).run()


def run_traffic(traffic: TrafficConfig, strategy: str,
                cfg: SimConfig | None = None, *, device="cuda",
                **cfg_overrides) -> tuple[SimResult, TrafficResult]:
    """Run an open-loop multi-tenant stream; returns (SimResult,
    TrafficResult)."""
    cfg = dataclasses.replace(cfg or SimConfig(), **cfg_overrides)
    sim = Simulation(None, cfg, strategy, traffic=traffic, device=device)
    res = sim.run()
    return res, sim.traffic_result()
