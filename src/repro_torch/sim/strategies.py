"""Compatibility shim: the scheduling strategies now live in
``repro_torch.core.adapter`` as engine-agnostic runtime adapters.

The three policies of the paper's evaluation (§V-C) -- Nextflow original
(FIFO + round-robin), the Common Workflow Scheduler baseline and the
paper's WOW scheduler -- used to be welded to the sim engine's synchronous
callbacks here.  They were always environment-free (they import only from
``repro_torch.core``), so the CWS-style adapter refactor moved them behind the
runtime boundary in ``core/adapter.py``, where the same classes drive both
the discrete-event simulator and the live asyncio mock resource manager
(``runtime/mockrm.py``).  This module keeps the historical sim-facing names
as aliases; new code should import from ``repro_torch.core.adapter``.

Node churn: all three adapters support failure injection and elastic join
(``node_removed`` / ``node_added``).  For the DFS-bound baselines the
engine additionally drives the failure-aware replica lifecycle
(``sim/dfs.py``): their intermediate data survives a node loss via degraded
reads and background re-replication, while WOW's node-local intermediates
are recovered by re-running producers (``dps.drop_node``) -- so churn
comparisons price each design's actual recovery mechanism.
"""
from __future__ import annotations

from ..core.adapter import (CwsAdapter, OrigAdapter, RuntimeAdapter,
                            WowAdapter, make_adapter)

BaseStrategy = RuntimeAdapter
OrigStrategy = OrigAdapter
CwsStrategy = CwsAdapter
WowStrategy = WowAdapter
make_strategy = make_adapter

__all__ = ["BaseStrategy", "CwsStrategy", "OrigStrategy", "WowStrategy",
           "make_strategy"]
