"""Real-world-like workflows scaled to Table I of the paper.

The four evaluation workflows (nf-core RNA-Seq / Sarek / Chip-Seq and the
Rangeland remote-sensing workflow) are reconstructed as parameterized DAGs
matching Table I: abstract-task counts, physical-task counts (at scale=1.0),
input GB, generated GB, and the paper's observation that real-world tasks
are compute-heavier than the synthetic ones.

``scale`` shrinks physical task counts (per-task data grows inversely so the
total volumes stay at Table I values) -- used to keep simulated benchmark
wall-time reasonable; results are reported with the scale noted.
"""
from __future__ import annotations

from .builder import GB, GiB, WorkflowBuilder, scaled_count

_MEM = 8 * GiB


def _sample_chain(b: WorkflowBuilder, prefix: str, steps: list[str],
                  dfs_in: int, sizes: list[int], compute: float,
                  cores: float = 4.0) -> list[int]:
    """A per-sample linear chain; returns final output files."""
    prev: list[int] | None = None
    for i, s in enumerate(steps):
        if prev is None:
            _, prev = b.task(s, dfs_inputs=dfs_in, out_sizes=[sizes[i]],
                             compute=b.uniform(0.7, 1.3) * compute,
                             cores=cores, mem=_MEM)
        else:
            _, prev = b.task(s, inputs=prev, out_sizes=[sizes[i]],
                             compute=b.uniform(0.7, 1.3) * compute,
                             cores=cores, mem=_MEM)
    return prev


def rnaseq(scale: float = 1.0, seed: int = 0):
    """nf-core/rnaseq-like: Table I = 139.1 GB in, 598.3 GB out, 53 abstract,
    1269 physical.  Per sample: QC -> trim -> align -> quant chains with
    per-sample fan-out QC steps and global MultiQC-style merges."""
    b = WorkflowBuilder("rnaseq", seed)
    n_samples = scaled_count(24, scale, 2)
    # 1269 physical / 24 samples ~ 52 per sample + merges; we model 48
    # per-sample steps as: main chain of 12 + 3 side chains of 12
    main_steps = ["fastqc", "trimgalore", "star_align", "samtools_sort",
                  "samtools_index", "markduplicates", "stringtie",
                  "salmon_quant", "bigwig", "qualimap", "dupradar",
                  "featurecounts"]
    side_steps = [["rseqc_bamstat", "rseqc_innerdist", "rseqc_junction",
                   "rseqc_dist"],
                  ["preseq", "picard_metrics", "biotype_qc", "misc_qc"]]
    total_in = 139.1 * GB
    total_out = 598.3 * GB
    per_sample_out = total_out * 0.95 / n_samples
    finals = []
    for _ in range(n_samples):
        sizes = [int(per_sample_out * w) for w in
                 (0.02, 0.10, 0.26, 0.22, 0.01, 0.20, 0.05, 0.06, 0.05,
                  0.01, 0.01, 0.01)]
        last = _sample_chain(b, "s", main_steps,
                             dfs_in=int(total_in / n_samples),
                             sizes=sizes, compute=180.0)
        finals.extend(last)
        for chain in side_steps:
            prev = last
            for s in chain:
                _, prev = b.task(s, inputs=prev,
                                 out_sizes=[int(0.2 * GB)],
                                 compute=b.uniform(20, 60), cores=2.0,
                                 mem=_MEM)
            finals.extend(prev)
    _, mq = b.task("multiqc", inputs=finals,
                   out_sizes=[int(1 * GB)], compute=60.0, cores=2.0,
                   mem=_MEM)
    b.task("report", inputs=mq, out_sizes=[int(0.2 * GB)], compute=20.0,
           cores=2.0, mem=_MEM)
    return b.build()


def sarek(scale: float = 1.0, seed: int = 0):
    """nf-core/sarek-like variant calling: 205.9 GB in, 918.8 GB out,
    49 abstract, 8656 physical.  Dominated by many small per-interval
    scatter tasks after per-sample alignment."""
    b = WorkflowBuilder("sarek", seed)
    n_samples = scaled_count(12, scale, 2)
    n_intervals = scaled_count(60, scale, 4)   # scatter width per sample
    total_in = 205.9 * GB
    total_out = 918.8 * GB
    align_steps = ["fastp", "bwamem", "sort", "markdup", "bqsr_table",
                   "apply_bqsr"]
    per_sample_out = total_out * 0.55 / n_samples
    sizes = [int(per_sample_out * w) for w in
             (0.10, 0.35, 0.25, 0.15, 0.05, 0.10)]
    interval_bytes = total_out * 0.40 / (n_samples * n_intervals * 3)
    for _ in range(n_samples):
        bam = _sample_chain(b, "s", align_steps,
                            dfs_in=int(total_in / n_samples),
                            sizes=sizes, compute=240.0)
        calls = []
        for _ in range(n_intervals):
            _, hc = b.task("haplotypecaller", inputs=bam,
                           out_sizes=[int(interval_bytes)],
                           compute=b.uniform(30, 90), cores=2.0, mem=_MEM)
            _, dv = b.task("deepvariant", inputs=bam,
                           out_sizes=[int(interval_bytes)],
                           compute=b.uniform(30, 90), cores=2.0, mem=_MEM)
            _, st = b.task("strelka", inputs=bam,
                           out_sizes=[int(interval_bytes)],
                           compute=b.uniform(30, 90), cores=2.0, mem=_MEM)
            calls.extend([hc[0], dv[0], st[0]])
        _, merged = b.task("merge_vcf", inputs=calls,
                           out_sizes=[int(total_out * 0.04 / n_samples)],
                           compute=60.0, cores=2.0, mem=_MEM)
        b.task("annotate", inputs=merged,
               out_sizes=[int(total_out * 0.01 / n_samples)],
               compute=60.0, cores=2.0, mem=_MEM)
    return b.build()


def chipseq(scale: float = 1.0, seed: int = 0):
    """nf-core/chipseq-like: 141.2 GB in, 787.2 GB out, 48 abstract,
    3537 physical."""
    b = WorkflowBuilder("chipseq", seed)
    n_samples = scaled_count(30, scale, 2)
    total_in = 141.2 * GB
    total_out = 787.2 * GB
    steps = ["fastqc", "trimgalore", "bwa_align", "sort", "merge_bam",
             "markdup", "filter_bam", "bigwig", "macs2", "homer_annotate"]
    per_sample_out = total_out * 0.9 / n_samples
    sizes = [int(per_sample_out * w) for w in
             (0.02, 0.12, 0.28, 0.22, 0.05, 0.10, 0.10, 0.06, 0.03, 0.02)]
    peak_files = []
    for _ in range(n_samples):
        last = _sample_chain(b, "s", steps,
                             dfs_in=int(total_in / n_samples),
                             sizes=sizes, compute=150.0)
        peak_files.extend(last)
        for extra in ("phantompeak", "plotfingerprint", "featurecounts_qc"):
            b.task(extra, inputs=last, out_sizes=[int(0.3 * GB)],
                   compute=b.uniform(20, 60), cores=2.0, mem=_MEM)
    _, consensus = b.task("consensus_peaks", inputs=peak_files,
                          out_sizes=[int(2 * GB)], compute=90.0, cores=2.0,
                          mem=_MEM)
    _, mq = b.task("multiqc", inputs=consensus, out_sizes=[int(1 * GB)],
                   compute=30.0, cores=2.0, mem=_MEM)
    return b.build()


def rangeland(scale: float = 1.0, seed: int = 0):
    """FORCE/Rangeland-like remote sensing: 303.2 GB in, 274.0 GB out
    (factor 0.9 -- compute reduces data), 8 abstract, 3184 physical."""
    b = WorkflowBuilder("rangeland", seed)
    n_imgs = scaled_count(1500, scale, 6)
    n_tiles = scaled_count(520, scale, 4)
    total_in = 303.2 * GB
    total_out = 274.0 * GB
    l2_outs = []
    for _ in range(n_imgs):
        _, o = b.task("level2", dfs_inputs=int(total_in / n_imgs),
                      out_sizes=[int(total_out * 0.45 / n_imgs)],
                      compute=b.uniform(60, 180), cores=4.0, mem=_MEM)
        l2_outs.append(o[0])
    per_tile = max(1, len(l2_outs) // n_tiles)
    mosaics = []
    for i in range(n_tiles):
        part = l2_outs[i::n_tiles]
        if not part:
            continue
        _, cube = b.task("cube", inputs=part,
                         out_sizes=[int(total_out * 0.25 / n_tiles)],
                         compute=b.uniform(30, 90), cores=2.0, mem=_MEM)
        _, tsa = b.task("tsa", inputs=cube,
                        out_sizes=[int(total_out * 0.20 / n_tiles)],
                        compute=b.uniform(60, 150), cores=4.0, mem=_MEM)
        _, trend = b.task("trend", inputs=tsa,
                          out_sizes=[int(total_out * 0.08 / n_tiles)],
                          compute=b.uniform(30, 90), cores=2.0, mem=_MEM)
        mosaics.append(trend[0])
    _, mos = b.task("mosaic", inputs=mosaics,
                    out_sizes=[int(total_out * 0.015)], compute=120.0,
                    cores=4.0, mem=_MEM)
    _, pyr = b.task("pyramid", inputs=mos, out_sizes=[int(total_out * 0.004)],
                    compute=60.0, cores=2.0, mem=_MEM)
    b.task("report", inputs=pyr, out_sizes=[int(0.5 * GB)], compute=30.0,
           cores=2.0, mem=_MEM)
    return b.build()
