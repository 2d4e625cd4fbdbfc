"""Open-loop multi-tenant traffic for the cluster simulator: the
reference's ``repro/sim/traffic.py``, copied so that the port imports
nothing of ``repro``.  Every draw stays a ``random.Random``, so equal
seeds give the reference's arrival stream.

Every pre-existing benchmark runs ONE workflow to completion; real WOW
deployments are shared clusters where many dynamic workflows from many
tenants execute concurrently and contend for the network.  This module
supplies the engine's arrival side:

* ``TenantSpec`` / ``TrafficConfig`` -- a seeded open-loop arrival process
  (Poisson or diurnal-modulated Poisson via thinning), per-tenant weights,
  workflow templates, SLOs, and an admission gate bound.
* ``arrival_schedule(cfg)`` -- the *pure* seeded generator: the full list
  of ``ArrivalSpec`` events is computable without running a simulation, so
  "same seed => identical arrival schedule" holds by construction and the
  three strategies can be benchmarked under literally identical streams.
* ``InstanceRecord`` -- per-admitted-instance lifecycle bookkeeping kept by
  the engine (arrival/admit/first-start/completion times, task membership),
  from which ``sim/metrics.py`` computes the windowed service metrics.

Admission semantics (DESIGN.md "Open-loop traffic"): an arrival is admitted
iff the number of live (admitted, not yet completed) instances is below
``max_backlog``; rejected arrivals are counted per tenant and never enter
the scheduler.  By default admission never re-queues: open-loop traffic
models demand, not a retrying client.  A tenant may opt into closed-loop
behaviour with a ``RetryPolicy``: its rejected arrivals are re-submitted
after a capped, seeded, jittered exponential backoff, up to
``max_attempts`` admission attempts per instance.  Retried submissions are
new admission attempts of the *same* instance (same index / workflow /
builder seed), so per-tenant ``arrivals`` counts admission attempts while
``retries`` counts the re-submissions among them.  Every admitted instance
either completes or is reported in ``TrafficResult.incomplete`` with its
residual task states -- the gate may shed load, it must never silently
starve.
"""
from __future__ import annotations

import dataclasses
import math
import random

GiB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Closed-loop client behaviour for admission-rejected arrivals.

    ``max_attempts`` bounds the total admission attempts per instance (the
    original submission counts as attempt 1).  The delay before attempt
    ``k`` (0-based retry count) is an exponential backoff
    ``backoff * multiplier**k`` capped at ``cap``, multiplied by a seeded
    uniform jitter in [0.5, 1.5) so retries across instances decorrelate
    deterministically."""

    max_attempts: int = 3
    backoff: float = 30.0
    multiplier: float = 2.0
    cap: float = 600.0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff <= 0 or self.multiplier < 1 or self.cap <= 0:
            raise ValueError("backoff/multiplier/cap must be positive "
                             "(multiplier >= 1)")

    def delay(self, seed: int, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based) of the
        instance with builder seed ``seed``.  Pure: a private RNG keyed on
        (seed, attempt), no shared stream is consumed."""
        base = min(self.cap, self.backoff * self.multiplier ** attempt)
        jitter = random.Random(seed * 1000003 + attempt).random()
        return base * (0.5 + jitter)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One traffic source: a weighted tenant submitting workflow templates.

    ``weight`` drives both the arrival mix (chance this tenant owns an
    arrival) and the fairness accounting (service is normalized by weight).
    ``slo`` is the tenant's workflow-completion latency objective in
    seconds (``None`` = no SLO; attainment is reported over tenants that
    declare one)."""

    name: str
    weight: float = 1.0
    workflows: tuple[str, ...] = ("chain",)
    scale: float = 0.1
    slo: float | None = None
    # closed-loop client: re-submit admission-rejected arrivals after a
    # seeded backoff (None keeps the pure open-loop semantics)
    retry: RetryPolicy | None = None


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Seeded open-loop arrival process + admission gate + metric windows.

    ``process`` is ``"poisson"`` (constant rate) or ``"diurnal"`` (rate
    modulated by ``1 + amplitude * sin(2*pi*t/period)``, sampled by
    thinning against the peak rate -- still exact and seed-deterministic).
    ``rate`` is the mean arrival rate in workflows/second; ``n_arrivals``
    bounds the stream length and ``horizon`` (seconds, optional) cuts it
    off in time.  ``max_backlog`` is the admission gate: a new arrival is
    rejected while that many admitted instances are still live (``None``
    disables the gate).  ``window`` is the service-metric window length in
    seconds; ``starvation_factor`` flags completions slower than
    ``starvation_factor * slo`` as starvation events."""

    tenants: tuple[TenantSpec, ...]
    rate: float = 0.1
    n_arrivals: int = 20
    process: str = "poisson"            # "poisson" | "diurnal"
    diurnal_period: float = 600.0
    diurnal_amplitude: float = 0.8
    horizon: float | None = None
    max_backlog: int | None = None      # admitted live instances bound
    window: float = 60.0
    starvation_factor: float = 10.0
    seed: int = 0
    enabled: bool = True                # False => engine ignores the config

    def __post_init__(self) -> None:
        if self.process not in ("poisson", "diurnal"):
            raise ValueError(f"unknown arrival process {self.process!r}")
        if not self.tenants:
            raise ValueError("TrafficConfig needs at least one tenant")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if self.rate <= 0:
            raise ValueError("rate must be positive")


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """One scheduled workflow arrival, fully determined by the seed."""

    index: int                  # 0-based arrival sequence number
    time: float                 # virtual arrival time (seconds)
    tenant: str
    workflow: str               # template name (repro_torch.workloads registry)
    scale: float
    seed: int                   # per-instance builder seed
    attempt: int = 0            # 0 = original submission, k = k-th retry


def _pick_tenant(cfg: TrafficConfig, rng: random.Random) -> TenantSpec:
    total = sum(t.weight for t in cfg.tenants)
    x = rng.random() * total
    acc = 0.0
    for t in cfg.tenants:
        acc += t.weight
        if x < acc:
            return t
    return cfg.tenants[-1]


def arrival_schedule(cfg: TrafficConfig) -> list[ArrivalSpec]:
    """The full seeded arrival stream -- pure, no engine required.

    Poisson: inter-arrival ~ Exp(rate).  Diurnal: thinning against the
    peak rate ``rate * (1 + amplitude)``: candidate gaps are Exp(peak) and
    a candidate at time t is accepted with probability lambda(t)/peak.
    Both consume the single stream RNG in a fixed order, so equal seeds
    yield bit-equal schedules."""
    rng = random.Random(cfg.seed)
    out: list[ArrivalSpec] = []
    t = 0.0
    peak = cfg.rate * (1.0 + cfg.diurnal_amplitude)
    while len(out) < cfg.n_arrivals:
        if cfg.process == "poisson":
            t += rng.expovariate(cfg.rate)
        else:
            # thinning: exact non-homogeneous Poisson sampling
            while True:
                t += rng.expovariate(peak)
                lam = cfg.rate * (1.0 + cfg.diurnal_amplitude
                                  * math.sin(2 * math.pi * t
                                             / cfg.diurnal_period))
                if rng.random() * peak <= lam:
                    break
        if cfg.horizon is not None and t > cfg.horizon:
            break
        tenant = _pick_tenant(cfg, rng)
        wf_name = tenant.workflows[rng.randrange(len(tenant.workflows))]
        inst_seed = rng.randrange(2 ** 31)
        out.append(ArrivalSpec(index=len(out), time=t, tenant=tenant.name,
                               workflow=wf_name, scale=tenant.scale,
                               seed=inst_seed))
    return out


@dataclasses.dataclass
class InstanceRecord:
    """Lifecycle of one admitted workflow instance inside the engine."""

    id: int                     # == ArrivalSpec.index
    tenant: str
    workflow: str
    arrival_t: float
    n_tasks: int
    task_ids: frozenset[int]    # namespaced task ids
    remaining: int = 0          # tasks not yet (re-)completed
    first_start_t: float | None = None
    completed_t: float | None = None
    cpu_seconds: float = 0.0    # sum over tasks of (end-start)*cores
    attempts: int = 1           # admission attempts until admitted

    @property
    def latency(self) -> float | None:
        if self.completed_t is None:
            return None
        return self.completed_t - self.arrival_t

    def row(self) -> dict:
        return {"id": self.id, "tenant": self.tenant,
                "workflow": self.workflow, "arrival_t": self.arrival_t,
                "n_tasks": self.n_tasks,
                "first_start_t": self.first_start_t,
                "completed_t": self.completed_t, "latency": self.latency,
                "cpu_seconds": self.cpu_seconds, "attempts": self.attempts}
