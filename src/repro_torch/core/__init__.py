"""WOW core in PyTorch: the paper's three-step scheduler, the DPS, the
step-1 solver and priorities, held decision for decision against
``repro/core``.  The scheduler's hot node state, its COP matrix and its
blocked drain are torch tensors on the scheduler's device (CUDA unless the
caller names another); everything else is the reference's plain Python.

The exports are the reference's, less ``HAVE_NUMPY`` (torch is always
present here), plus ``torch_winner``, the drain's winner reduction.
"""
from .adapter import (ADAPTER_API, CwsAdapter, OrigAdapter, RuntimeAdapter,
                      WowAdapter, assert_implements, make_adapter)
from .copmatrix import torch_winner
from .dps import DataPlacementService
from .ilp import (AssignmentProblem, FingerprintCache,
                  IncrementalAssignmentSolver, component_fingerprint,
                  decompose, solve, solve_exact, solve_greedy,
                  solve_monolithic)
from .nodearray import ArrayCapacityClasses, NodeCapacityArray
from .priority import abstract_ranks, assign_priorities, priority_value
from .readyset import CapacityClasses, NodeOrder, ReadySet, ShapeIndex
from .reference import ReferenceWowScheduler
from .scheduler import WowScheduler
from .types import (Action, CopPlan, DFS_LOC, FileSpec, NodeState, StartCop,
                    StartTask, TaskSpec, Transfer)

__all__ = [
    "ADAPTER_API", "Action", "ArrayCapacityClasses", "AssignmentProblem",
    "CapacityClasses",
    "CopPlan", "CwsAdapter", "DFS_LOC", "DataPlacementService", "FileSpec",
    "FingerprintCache", "IncrementalAssignmentSolver",
    "NodeCapacityArray", "NodeOrder", "NodeState", "OrigAdapter", "ReadySet",
    "ReferenceWowScheduler", "RuntimeAdapter", "ShapeIndex", "StartCop",
    "StartTask", "TaskSpec", "Transfer", "WowAdapter", "WowScheduler",
    "abstract_ranks", "assert_implements", "assign_priorities",
    "component_fingerprint", "decompose", "make_adapter",
    "priority_value", "solve", "solve_exact", "solve_greedy",
    "solve_monolithic", "torch_winner",
]
