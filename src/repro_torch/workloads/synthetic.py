"""WfChef-style synthetic workflows (paper §V-A, Table I).

Seven topologies synthesized from the WfCommons recipes the paper uses
(BLAST, BWA, Cycles, 1000Genome, Montage, Seismology, SoyKB), scaled to the
paper's settings: ~198 physical tasks, ~20 GB input, ~150-170 GB generated,
CPU load low enough that the workflows are I/O bound.

The exact WfCommons generators are not available offline; these builders
reproduce the documented DAG shapes (fan-out/fan-in structure, stage counts)
and the Table I data volumes, which are the properties the scheduling
results depend on.
"""
from __future__ import annotations

from .builder import GB, GiB, MB, WorkflowBuilder, scaled_count

_CORES = 2.0
_MEM = 6 * GiB


def _c(scale: float, n: int, minimum: int = 1) -> int:
    return scaled_count(n, scale, minimum)


def syn_blast(scale: float = 1.0, seed: int = 0):
    """split_fasta -> blastall xN -> cat_blast -> cat   (4 abstract)."""
    b = WorkflowBuilder("syn_blast", seed)
    n = _c(scale, 195, 3)
    _, splits = b.task("split_fasta", dfs_inputs=int(21.9 * GB),
                       out_sizes=[int(20 * GB / n)] * n,
                       compute=20.0, cores=_CORES, mem=_MEM)
    blast_outs = []
    for f in splits:
        _, outs = b.task("blastall", inputs=[f],
                         out_sizes=[int(b.uniform(0.6, 0.72) * GB)],
                         compute=b.uniform(15, 30), cores=_CORES, mem=_MEM)
        blast_outs.append(outs[0])
    _, cat1 = b.task("cat_blast", inputs=blast_outs,
                     out_sizes=[int(1.0 * GB)], compute=10.0,
                     cores=_CORES, mem=_MEM)
    b.task("cat", inputs=cat1, out_sizes=[int(0.5 * GB)], compute=5.0,
           cores=_CORES, mem=_MEM)
    return b.build()


def syn_bwa(scale: float = 1.0, seed: int = 0):
    """fastq_reduce -> bwa_index, bwa xN -> cat_bwa -> cat  (5 abstract)."""
    b = WorkflowBuilder("syn_bwa", seed)
    n = _c(scale, 194, 3)
    _, idx = b.task("bwa_index", dfs_inputs=int(3 * GB),
                    out_sizes=[int(3 * GB)], compute=30.0,
                    cores=_CORES, mem=_MEM)
    _, splits = b.task("fastq_reduce", dfs_inputs=int(16.4 * GB),
                       out_sizes=[int(16 * GB / n)] * n,
                       compute=20.0, cores=_CORES, mem=_MEM)
    outs = []
    for f in splits:
        _, o = b.task("bwa", inputs=[f, idx[0]],
                      out_sizes=[int(b.uniform(0.6, 0.74) * GB)],
                      compute=b.uniform(15, 30), cores=_CORES, mem=_MEM)
        outs.append(o[0])
    _, cat1 = b.task("cat_bwa", inputs=outs, out_sizes=[int(1.0 * GB)],
                     compute=10.0, cores=_CORES, mem=_MEM)
    b.task("cat", inputs=cat1, out_sizes=[int(0.5 * GB)], compute=5.0,
           cores=_CORES, mem=_MEM)
    return b.build()


def syn_cycles(scale: float = 1.0, seed: int = 0):
    """prep -> baseline xN -> fertilizer xN -> parser xN -> agg xN ->
    summary x4 -> plot   (7 abstract)."""
    b = WorkflowBuilder("syn_cycles", seed)
    n = _c(scale, 48, 4)
    _, prep = b.task("prep", dfs_inputs=int(20.4 * GB),
                     out_sizes=[int(18 * GB / n)] * n, compute=20.0,
                     cores=_CORES, mem=_MEM)
    agg_outs = []
    for f in prep:
        _, o1 = b.task("baseline_cycles", inputs=[f],
                       out_sizes=[int(b.uniform(0.7, 0.9) * GB)],
                       compute=b.uniform(10, 25), cores=_CORES, mem=_MEM)
        _, o2 = b.task("cycles_fertilizer", inputs=o1,
                       out_sizes=[int(b.uniform(0.7, 0.9) * GB)],
                       compute=b.uniform(10, 25), cores=_CORES, mem=_MEM)
        _, o3 = b.task("output_parser", inputs=o2,
                       out_sizes=[int(b.uniform(0.5, 0.7) * GB)],
                       compute=b.uniform(5, 15), cores=_CORES, mem=_MEM)
        _, o4 = b.task("cycles_agg", inputs=o3,
                       out_sizes=[int(b.uniform(0.4, 0.6) * GB)],
                       compute=b.uniform(5, 15), cores=_CORES, mem=_MEM)
        agg_outs.append(o4[0])
    summaries = []
    chunk = [agg_outs[i::_c(scale, 4)] for i in range(_c(scale, 4))]
    for part in chunk:
        if not part:
            continue
        _, s = b.task("summary", inputs=part,
                      out_sizes=[sum(b.files[f].size for f in part) // 4],
                      compute=10.0, cores=_CORES, mem=_MEM)
        summaries.append(s[0])
    b.task("plots", inputs=summaries, out_sizes=[int(0.5 * GB)],
           compute=10.0, cores=_CORES, mem=_MEM)
    return b.build()


def syn_genome(scale: float = 1.0, seed: int = 0):
    """individuals xN -> merge xM, sifting xM -> mutation xK, frequency xK
    (5 abstract, 1000Genome shape)."""
    b = WorkflowBuilder("syn_genome", seed)
    n_ind = _c(scale, 130, 4)
    n_mrg = _c(scale, 10, 2)
    n_ovl = _c(scale, 24, 2)
    per = int(20 * GB / n_ind)
    ind_outs = []
    for _ in range(n_ind):
        _, o = b.task("individuals", dfs_inputs=int(21.9 * GB / n_ind),
                      out_sizes=[int(b.uniform(0.8, 1.2) * per)],
                      compute=b.uniform(10, 25), cores=_CORES, mem=_MEM)
        ind_outs.append(o[0])
    merges, sifts = [], []
    for i in range(n_mrg):
        part = ind_outs[i::n_mrg]
        _, m = b.task("individuals_merge", inputs=part,
                      out_sizes=[sum(b.files[f].size for f in part)],
                      compute=10.0, cores=_CORES, mem=_MEM)
        merges.append(m[0])
        _, s = b.task("sifting", inputs=m,
                      out_sizes=[int(b.files[m[0]].size * 0.3)],
                      compute=10.0, cores=_CORES, mem=_MEM)
        sifts.append(s[0])
    for i in range(n_ovl):
        m = merges[i % len(merges)]
        s = sifts[i % len(sifts)]
        for kind in ("mutation_overlap", "frequency"):
            b.task(kind, inputs=[m, s],
                   out_sizes=[int(b.uniform(1.0, 1.6) * GB)],
                   compute=b.uniform(10, 25), cores=_CORES, mem=_MEM)
    return b.build()


def syn_montage(scale: float = 1.0, seed: int = 0):
    """mProject xN -> mDiffFit x~2N -> mConcatFit -> mBgModel ->
    mBackground xN -> mImgtbl -> mAdd -> mShrink x4   (8 abstract)."""
    b = WorkflowBuilder("syn_montage", seed)
    n = _c(scale, 48, 4)
    projs = []
    for _ in range(n):
        _, o = b.task("mProject", dfs_inputs=int(19.8 * GB / n),
                      out_sizes=[int(b.uniform(0.75, 0.95) * GB)],
                      compute=b.uniform(10, 20), cores=_CORES, mem=_MEM)
        projs.append(o[0])
    n_diff = _c(scale, 94, 4)
    diffs = []
    for i in range(n_diff):
        a, c = projs[i % n], projs[(i + 1) % n]
        _, o = b.task("mDiffFit", inputs=[a, c],
                      out_sizes=[int(50 * MB)], compute=b.uniform(2, 6),
                      cores=_CORES, mem=_MEM)
        diffs.append(o[0])
    _, concat = b.task("mConcatFit", inputs=diffs, out_sizes=[int(100 * MB)],
                       compute=5.0, cores=_CORES, mem=_MEM)
    _, bg = b.task("mBgModel", inputs=concat, out_sizes=[int(50 * MB)],
                   compute=5.0, cores=_CORES, mem=_MEM)
    backs = []
    for f in projs:
        _, o = b.task("mBackground", inputs=[f, bg[0]],
                      out_sizes=[int(b.uniform(0.75, 0.95) * GB)],
                      compute=b.uniform(5, 12), cores=_CORES, mem=_MEM)
        backs.append(o[0])
    _, tbl = b.task("mImgtbl", inputs=backs, out_sizes=[int(20 * MB)],
                    compute=5.0, cores=_CORES, mem=_MEM)
    _, add = b.task("mAdd", inputs=backs + tbl,
                    out_sizes=[int(40 * GB)], compute=20.0,
                    cores=_CORES, mem=_MEM)
    for _ in range(_c(scale, 4)):
        b.task("mShrink", inputs=add, out_sizes=[int(1.5 * GB)],
               compute=5.0, cores=_CORES, mem=_MEM)
    return b.build()


def syn_seismology(scale: float = 1.0, seed: int = 0):
    """sG1IterDecon xN -> wrapper_siftSTFByMisfit   (2 abstract)."""
    b = WorkflowBuilder("syn_seismology", seed)
    n = _c(scale, 197, 3)
    outs = []
    for _ in range(n):
        _, o = b.task("sG1IterDecon", dfs_inputs=int(20.7 * GB / n),
                      out_sizes=[int(b.uniform(0.65, 0.82) * GB)],
                      compute=b.uniform(10, 25), cores=_CORES, mem=_MEM)
        outs.append(o[0])
    b.task("wrapper_siftSTFByMisfit", inputs=outs,
           out_sizes=[int(5 * GB)], compute=15.0, cores=_CORES, mem=_MEM)
    return b.build()


def syn_soykb(scale: float = 1.0, seed: int = 0):
    """15 samples x 13-step chains -> combine   (14 abstract)."""
    b = WorkflowBuilder("syn_soykb", seed)
    steps = ["align", "sort", "dedup", "add_replace", "realign_target",
             "indel_realign", "haplotype_caller", "genotype_gvcf",
             "combine_variants", "select_snp", "filter_snp", "select_indel",
             "filter_indel"]
    n_samples = _c(scale, 15, 2)
    finals = []
    per_in = int(22.3 * GB / n_samples)
    for _ in range(n_samples):
        prev: list[int] | None = None
        for i, s in enumerate(steps):
            size = int(b.uniform(0.75, 0.95) * GB)
            if prev is None:
                _, prev = b.task(s, dfs_inputs=per_in, out_sizes=[size],
                                 compute=b.uniform(5, 15), cores=_CORES,
                                 mem=_MEM)
            else:
                _, prev = b.task(s, inputs=prev, out_sizes=[size],
                                 compute=b.uniform(5, 15), cores=_CORES,
                                 mem=_MEM)
        finals.append(prev[0])
    b.task("merge_gcvf", inputs=finals, out_sizes=[int(2 * GB)],
           compute=15.0, cores=_CORES, mem=_MEM)
    return b.build()
