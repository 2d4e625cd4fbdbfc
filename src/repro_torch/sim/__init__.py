"""Discrete-event cluster simulator for the WOW reproduction, in PyTorch:
the reference's ``repro/sim`` on the port's scheduler core.  The WOW
scheduler's hot state and the flow network's dense fill are tensors on the
simulation's device (``Simulation(..., device=...)``, CUDA by default);
events, flows and the DFS stay plain Python."""
from .dfs import CephModel, DfsModel, NfsModel
from .engine import (DeadlockError, SimConfig, Simulation, run_traffic,
                     run_workflow)
from .metrics import (SimResult, TrafficResult, compute_traffic_result,
                      efficiency, gini, jain, percentile)
from .network import Flow, FlowManager, LinkId, ReferenceFlowManager, \
    build_links
from .strategies import (BaseStrategy, CwsStrategy, OrigStrategy,
                         WowStrategy, make_strategy)
from .topology import Topology, TopologySpec
from .traffic import (ArrivalSpec, InstanceRecord, RetryPolicy, TenantSpec,
                      TrafficConfig, arrival_schedule)
from .workflow import Workflow

__all__ = [
    "ArrivalSpec", "BaseStrategy", "CephModel", "CwsStrategy",
    "DeadlockError", "DfsModel", "Flow", "FlowManager", "InstanceRecord",
    "LinkId", "NfsModel", "OrigStrategy", "ReferenceFlowManager",
    "RetryPolicy", "SimConfig", "SimResult", "Simulation", "TenantSpec",
    "Topology", "TopologySpec", "TrafficConfig", "TrafficResult", "Workflow",
    "WowStrategy", "arrival_schedule", "build_links",
    "compute_traffic_result", "efficiency", "gini", "jain",
    "make_strategy", "percentile", "run_traffic", "run_workflow",
]
