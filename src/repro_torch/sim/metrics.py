"""Metrics mirroring the paper's evaluation (Table II, Fig. 4/5, Gini),
plus the open-loop traffic service metrics (windowed completion-latency
percentiles, per-tenant weighted fairness, starvation and admission
counters) computed into a ``TrafficResult``.  Pure Python, the reference's
``repro/sim/metrics.py`` as it is."""
from __future__ import annotations

import dataclasses
import math


def gini(values: list[float]) -> float:
    """Gini coefficient in [0,1); 0 = perfectly even."""
    xs = sorted(max(v, 0.0) for v in values)
    n = len(xs)
    total = sum(xs)
    if n == 0 or total <= 0:
        return 0.0
    cum = 0.0
    for i, x in enumerate(xs, start=1):
        cum += i * x
    return (2.0 * cum) / (n * total) - (n + 1.0) / n


@dataclasses.dataclass
class SimResult:
    workflow: str
    strategy: str
    dfs: str
    n_nodes: int
    makespan: float                     # seconds
    cpu_alloc_hours: float              # Σ (end-start) * cores / 3600
    tasks_total: int
    tasks_no_cop: int                   # "none" column of Table II
    cops_created: int
    cops_used: int                      # "used" column of Table II
    cop_bytes: int                      # Fig. 4 numerator
    unique_intermediate_bytes: int      # Fig. 4 denominator
    network_bytes: float                # all bytes that crossed a NIC
    gini_storage: float
    gini_cpu: float
    # DFS churn (failure-aware replication; zero in failure-free runs)
    degraded_reads: int = 0             # reads served off a non-ideal replica
    degraded_read_bytes: float = 0.0
    rereplication_bytes: float = 0.0    # repair traffic that completed
    repairs_completed: int = 0
    dfs_lost_files: int = 0             # objects whose every replica died
    # engine / flow-manager health (fill-regression observability)
    sim_steps: int = 0                  # discrete-event loop steps
    flow_recomputes: int = 0            # non-trivial rate recomputes
    flow_compactions: int = 0           # ETA-heap rebuilds
    flow_mean_component: float = 0.0    # mean flows per recompute
    # per-locality-tier traffic (hierarchical topology runs only;
    # keys from Topology.TIERS that carried bytes: rack/site/wan)
    tier_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def pct_no_cop(self) -> float:
        return 100.0 * self.tasks_no_cop / max(self.tasks_total, 1)

    @property
    def pct_cops_used(self) -> float:
        return 100.0 * self.cops_used / max(self.cops_created, 1)

    @property
    def data_overhead(self) -> float:
        """Fig. 4: additional replica bytes / unique intermediate bytes."""
        return self.cop_bytes / max(self.unique_intermediate_bytes, 1)

    def row(self) -> dict:
        return dataclasses.asdict(self) | {
            "pct_no_cop": self.pct_no_cop,
            "pct_cops_used": self.pct_cops_used,
            "data_overhead": self.data_overhead,
        }


def efficiency(makespan_1: float, makespan_n: float, n: int) -> float:
    """Fig. 5: efficiency(n) = makespan(1) / (makespan(n) * n)."""
    return makespan_1 / (makespan_n * n)


# ------------------------------------------------ open-loop traffic metrics
def percentile(values: list[float], q: float) -> float | None:
    """Nearest-rank percentile: the ceil(q/100 * n)-th smallest value.

    ``None`` on an empty list.  Nearest-rank (no interpolation) keeps the
    definition brute-force checkable: sort, index."""
    if not values:
        return None
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[min(rank, len(xs)) - 1]


def jain(values: list[float]) -> float:
    """Jain's fairness index (sum x)^2 / (n * sum x^2) in (0, 1].

    1.0 = perfectly fair.  Degenerate inputs (empty, or all-zero service)
    report 1.0: nothing was served, so nothing was served unfairly."""
    n = len(values)
    sq = sum(x * x for x in values)
    if n == 0 or sq <= 0:
        return 1.0
    s = sum(values)
    return (s * s) / (n * sq)


@dataclasses.dataclass
class TrafficResult:
    """Service-level view of one open-loop multi-tenant run.

    Sits alongside ``SimResult`` (which keeps its single-run meaning):
    workflow-completion latency is measured from *arrival* (queueing
    included), fairness is over per-tenant weight-normalized service
    (CPU-seconds of completed work / tenant weight), and the ``windows``
    series slices every counter into fixed ``window``-second buckets."""

    arrivals: int
    admitted: int
    rejected: int
    completed: int
    horizon: float                      # virtual end-of-run time
    latency_p50: float | None
    latency_p99: float | None
    slo_attainment: float | None        # over completed instances with SLOs
    slo_violations: int
    starved: int                        # starvation events (see TrafficConfig)
    fairness_jain: float                # Jain over per-tenant service/weight
    fairness_gini: float                # Gini over per-tenant service/weight
    queue_depth_max: int                # scheduler backlog (pending tasks)
    queue_depth_mean: float
    per_tenant: dict[str, dict]
    windows: list[dict]
    incomplete: list[dict]              # admitted instances that never
                                        # finished, with residual state
    instances: list[dict] = dataclasses.field(default_factory=list)
    # closed-loop clients (TenantSpec.retry): re-submissions scheduled
    # after a rejection, and admitted instances that needed >1 attempt
    retries: int = 0
    retry_admitted: int = 0
    # per-arrival scheduler churn profile (engine churn_probe samples)
    churn: dict = dataclasses.field(default_factory=dict)

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("instances")              # bulky; keep rows lean
        return d


def compute_traffic_result(cfg, records, rejections, depth_samples,
                           end_time: float,
                           incomplete: list[dict] | None = None,
                           retries: list | None = None,
                           churn: dict | None = None,
                           ) -> TrafficResult:
    """Aggregate engine bookkeeping into a ``TrafficResult``.

    ``records``: InstanceRecord per *admitted* instance.
    ``rejections``: (time, tenant) per admission-gate rejection (retried
    attempts that bounce again are counted once per bounce).
    ``depth_samples``: (time, pending_tasks, live_instances) sampled at
    every arrival and instance completion.
    ``retries``: (time, tenant) per scheduled retry re-submission.
    ``churn``: per-arrival scheduler churn summary (engine-provided)."""
    retries = list(retries or [])
    tenants = {t.name: t for t in cfg.tenants}
    incomplete = list(incomplete or [])
    completed = [r for r in records if r.completed_t is not None]
    latencies = [r.latency for r in completed]

    per_tenant: dict[str, dict] = {}
    service_norm: list[float] = []
    slo_hits = slo_total = 0
    starved_total = 0
    for name, spec in tenants.items():
        mine = [r for r in records if r.tenant == name]
        done = [r for r in mine if r.completed_t is not None]
        lats = [r.latency for r in done]
        rej = sum(1 for _, t in rejections if t == name)
        service = sum(r.cpu_seconds for r in done)
        starved = 0
        if spec.slo is not None:
            hits = sum(1 for l in lats if l <= spec.slo)
            slo_hits += hits
            slo_total += len(done)
            limit = cfg.starvation_factor * spec.slo
            starved = (sum(1 for l in lats if l > limit)
                       + sum(1 for r in mine if r.completed_t is None))
        else:
            starved = sum(1 for r in mine if r.completed_t is None)
        starved_total += starved
        per_tenant[name] = {
            "weight": spec.weight,
            "arrivals": len(mine) + rej,
            "admitted": len(mine),
            "rejected": rej,
            "retries": sum(1 for _, t in retries if t == name),
            "completed": len(done),
            "p50": percentile(lats, 50),
            "p99": percentile(lats, 99),
            "slo": spec.slo,
            "slo_hits": (sum(1 for l in lats if l <= spec.slo)
                         if spec.slo is not None else None),
            "starved": starved,
            "service_cpu_s": service,
        }
        if spec.weight > 0:
            service_norm.append(service / spec.weight)

    # windowed series over [0, end_time]
    w = cfg.window
    n_windows = max(1, math.ceil(max(end_time, 1e-12) / w))
    windows: list[dict] = []
    for i in range(n_windows):
        t0, t1 = i * w, (i + 1) * w
        arr = sum(1 for r in records if t0 <= r.arrival_t < t1)
        rej = sum(1 for t, _ in rejections if t0 <= t < t1)
        done = [r for r in completed if t0 <= r.completed_t < t1]
        lats = [r.latency for r in done]
        depths = [d for t, d, _ in depth_samples if t0 <= t < t1]
        windows.append({
            "t0": t0, "t1": t1,
            "arrivals": arr + rej, "admitted": arr, "rejected": rej,
            "completions": len(done),
            "p50": percentile(lats, 50),
            "p99": percentile(lats, 99),
            "queue_depth_max": max(depths) if depths else 0,
            "queue_depth_mean": (sum(depths) / len(depths)
                                 if depths else 0.0),
        })

    depths_all = [d for _, d, _ in depth_samples]
    return TrafficResult(
        arrivals=len(records) + len(rejections),
        admitted=len(records),
        rejected=len(rejections),
        completed=len(completed),
        horizon=end_time,
        latency_p50=percentile(latencies, 50),
        latency_p99=percentile(latencies, 99),
        slo_attainment=(slo_hits / slo_total if slo_total else None),
        slo_violations=slo_total - slo_hits,
        starved=starved_total,
        fairness_jain=jain(service_norm),
        fairness_gini=gini(service_norm),
        queue_depth_max=max(depths_all) if depths_all else 0,
        queue_depth_mean=(sum(depths_all) / len(depths_all)
                          if depths_all else 0.0),
        per_tenant=per_tenant,
        windows=windows,
        incomplete=incomplete,
        instances=[r.row() for r in records],
        retries=len(retries),
        retry_admitted=sum(1 for r in records
                           if getattr(r, "attempts", 1) > 1),
        churn=dict(churn or {}),
    )
