"""The simulator half of WOW in PyTorch.  So far only the hierarchical
topology, which the DPS's locality cost reads; the discrete-event engine,
the network and DFS models come later."""
from .topology import LinkId, Topology, TopologySpec

__all__ = ["LinkId", "Topology", "TopologySpec"]
