"""Workload registry: the paper's 16 evaluation workflows and three ML
pipelines, the reference's ``repro/workloads`` in the port."""
from __future__ import annotations

from ..sim.workflow import Workflow
from . import mlpipes, patterns, realworld, synthetic

PATTERNS = ["all_in_one", "chain", "fork", "group", "group_multiple"]
SYNTHETIC = ["syn_blast", "syn_bwa", "syn_cycles", "syn_genome",
             "syn_montage", "syn_seismology", "syn_soykb"]
REAL_WORLD = ["rnaseq", "sarek", "chipseq", "rangeland"]
MLPIPES = ["mlpipe_phi4", "mlpipe_deepseek", "mlpipe_mamba"]
ALL_WORKFLOWS = REAL_WORLD + SYNTHETIC + PATTERNS + MLPIPES

_REGISTRY = {
    "all_in_one": patterns.all_in_one,
    "chain": patterns.chain,
    "fork": patterns.fork,
    "group": patterns.group,
    "group_multiple": patterns.group_multiple,
    "syn_blast": synthetic.syn_blast,
    "syn_bwa": synthetic.syn_bwa,
    "syn_cycles": synthetic.syn_cycles,
    "syn_genome": synthetic.syn_genome,
    "syn_montage": synthetic.syn_montage,
    "syn_seismology": synthetic.syn_seismology,
    "syn_soykb": synthetic.syn_soykb,
    "rnaseq": realworld.rnaseq,
    "sarek": realworld.sarek,
    "chipseq": realworld.chipseq,
    "rangeland": realworld.rangeland,
    "mlpipe_phi4": mlpipes.mlpipe_phi4,
    "mlpipe_deepseek": mlpipes.mlpipe_deepseek,
    "mlpipe_mamba": mlpipes.mlpipe_mamba,
}


def make_workflow(name: str, scale: float = 1.0, seed: int = 0) -> Workflow:
    if name not in _REGISTRY:
        raise KeyError(f"unknown workflow {name!r}; "
                       f"choose from {sorted(_REGISTRY)}")
    return _REGISTRY[name](scale=scale, seed=seed)
