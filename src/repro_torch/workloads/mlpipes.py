"""ML-pipeline workflows costed by the port's roofline model.

Workload diversity for the open-loop traffic layer: instead of synthetic
uniform durations, these pipelines derive task compute times and artifact
sizes from the repo's *other* half -- the analytic three-term roofline
(``repro_torch/roofline/model.py``) evaluated over the seed architecture
configs (``repro_torch/configs/``).  A pipeline instance is

    ingest -> tokenize x S -> train x E (checkpoint chain, each epoch
    re-reads every shard) -> eval (+ DFS checkpoint export)

where the train step time is ``max(compute_s, memory_s, collective_s)``
of an analytically constructed ``RooflineReport`` (the same finalize()
the dry-run path uses), the eval time prices prefill + decode steps, and
the checkpoint size is the architecture's total parameter count times its
parameter dtype width.  Tokenizer shards carry seeded +-10% size jitter so
concurrent instances are not clones; everything else is deterministic in
(arch, scale, seed).

The reference's ``repro/workloads/mlpipes.py`` with one difference by
design: each report's FLOPs and bytes are the reference's formula as it
is, but its time terms come from this package's ``RooflineReport.finalize``
at the H100's data-sheet peaks (989 TFLOP/s, 3.35 TB/s, NVLink 450 GB/s).
So a pipeline task's ``compute_time`` is the H100 estimate; the DAG, the
sizes, the shards and the seeded draws are the reference's.
``mlpipe_stages`` returns the exact report rows a workflow was built from.
"""
from __future__ import annotations

import math

from ..configs import get_config
from ..models.config import ArchConfig
from ..roofline.model import RooflineReport, model_flops
from .builder import GiB, WorkflowBuilder

MB = 1_000_000

# fixed pipeline operating point (per-step shapes)
BATCH = 4
SEQ = 2048
SHARD_TOKENS = 2 ** 18          # ~262k tokens per tokenized shard
TOKEN_BYTES = 4                 # int32 token ids on disk
TOKENIZE_RATE = 2 ** 18         # tokens/s of the (CPU) tokenize stage
EVAL_REQUESTS = 8
EVAL_DECODE_TOKENS = 64

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _dtype_bytes(name: str) -> int:
    return _DTYPE_BYTES.get(name, 4)


def checkpoint_bytes(cfg: ArchConfig) -> int:
    """Total parameters x parameter dtype width."""
    return int(cfg.param_counts()["total"]) * _dtype_bytes(cfg.param_dtype)


def stage_report(cfg: ArchConfig, kind: str, batch: int = BATCH,
                 seq: int = SEQ, chips: int = 1) -> RooflineReport:
    """Analytic RooflineReport for one step of ``kind``.

    FLOPs come from ``roofline.model_flops`` (the dry-run's MODEL_FLOPS
    term).  HBM bytes are the standard streaming estimate: parameter bytes
    per pass (train reads them forward + backward and writes grads/opt
    state: 4 passes; inference reads them once) plus activation traffic
    (tokens x d_model x width x layers, x4 for train fwd+bwd read+write,
    x2 for prefill) and, for decode, one KV-cache (or SSM-state) sweep per
    generated token.  Collectives model data-parallel gradient all-reduce
    only (2 x params x (chips-1)/chips), zero on one chip."""
    flops_global = model_flops(cfg, kind, batch, seq)
    w = _dtype_bytes(cfg.compute_dtype)
    params_b = checkpoint_bytes(cfg)
    tokens = batch * seq
    act = tokens * cfg.d_model * w * cfg.n_layers
    if kind == "train":
        hbm = 4 * params_b + 4 * act
    elif kind == "prefill":
        hbm = params_b + 2 * act
    elif kind == "decode":
        l_attn = cfg.n_layers if cfg.family not in ("ssm", "hybrid") else (
            cfg.n_layers // cfg.attn_every if cfg.attn_every else 0)
        kv = batch * seq * cfg.n_kv_heads * cfg.head_dim * 2 * w * l_attn
        if cfg.family in ("ssm", "hybrid"):
            d_inner = cfg.d_model * cfg.ssm_expand
            kv += batch * d_inner * cfg.ssm_state * w * cfg.n_layers
        hbm = params_b + kv + batch * cfg.d_model * w * cfg.n_layers
    else:
        raise ValueError(kind)
    coll = (2.0 * params_b * (chips - 1) / chips) if (
        kind == "train" and chips > 1) else 0.0
    return RooflineReport(
        arch=cfg.name, shape=f"{kind}:b{batch}s{seq}", mesh=f"dp{chips}",
        chips=chips, flops_per_device=flops_global / chips,
        bytes_per_device=hbm / chips,
        collective_bytes_per_device=coll,
        collective_by_kind={"all-reduce": coll} if coll else {},
        model_flops_global=flops_global,
    ).finalize()


def step_seconds(report: RooflineReport) -> float:
    """Roofline step time: the binding term."""
    return max(report.compute_s, report.memory_s, report.collective_s)


def mlpipe_stages(arch: str, batch: int = BATCH, seq: int = SEQ,
                  chips: int = 1) -> dict[str, RooflineReport]:
    """The report rows an ``mlpipe(arch)`` instance derives its costs from."""
    cfg = get_config(arch)
    return {kind: stage_report(cfg, kind, batch, seq, chips)
            for kind in ("train", "prefill", "decode")}


def mlpipe(arch: str = "phi4-mini-3.8b", scale: float = 1.0, seed: int = 0,
           chips: int = 1) -> "Workflow":
    """One training+eval pipeline for ``arch``, roofline-costed.

    ``scale`` sets data volume and epochs: S = max(2, round(8*scale))
    tokenized shards of ~SHARD_TOKENS tokens, E = max(1, round(2*scale))
    epochs.  Each epoch is one physical train task covering
    ceil(S*shard_tokens / (batch*seq)) roofline steps, chained through
    checkpoints; every epoch re-reads all shards (the full-dataset pass is
    what makes concurrent pipelines contend for placement)."""
    cfg = get_config(arch)
    reports = mlpipe_stages(arch, chips=chips)
    train_s = step_seconds(reports["train"])
    prefill_s = step_seconds(reports["prefill"])
    decode_s = step_seconds(reports["decode"])
    ckpt = checkpoint_bytes(cfg)

    b = WorkflowBuilder(f"mlpipe_{arch}", seed)
    n_shards = max(2, round(8 * scale))
    n_epochs = max(1, round(2 * scale))

    # ingest: stage the raw corpus out of the DFS into a manifest
    shard_tokens = [int(SHARD_TOKENS * b.uniform(0.9, 1.1))
                    for _ in range(n_shards)]
    corpus_bytes = sum(shard_tokens) * TOKEN_BYTES
    _, manifest = b.task("ingest", dfs_inputs=corpus_bytes,
                         out_sizes=[64 * MB],
                         compute=corpus_bytes / (537e6),  # one disk pass
                         cores=2.0, mem=4 * GiB)

    # tokenize fan-out: one shard per task, seeded size jitter
    shards = []
    for toks in shard_tokens:
        _, out = b.task("tokenize", inputs=manifest,
                        out_sizes=[toks * TOKEN_BYTES],
                        compute=toks / TOKENIZE_RATE,
                        cores=2.0, mem=4 * GiB)
        shards.append(out[0])

    # train chain: epoch e consumes ckpt_{e-1} + every shard
    total_tokens = sum(shard_tokens)
    steps_per_epoch = max(1, math.ceil(total_tokens / (BATCH * SEQ)))
    train_mem = min(48 * GiB, max(6 * GiB, 2 * ckpt))
    prev_ckpt: list[int] = []
    for _ in range(n_epochs):
        _, prev_ckpt = b.task("train", inputs=prev_ckpt + shards,
                              out_sizes=[ckpt],
                              compute=steps_per_epoch * train_s,
                              cores=4.0, mem=train_mem)

    # eval: prefill + decode over a fixed request batch, export to DFS
    eval_compute = EVAL_REQUESTS * (prefill_s
                                    + EVAL_DECODE_TOKENS * decode_s)
    b.task("eval", inputs=prev_ckpt, out_sizes=[16 * MB],
           dfs_outputs=ckpt, compute=eval_compute,
           cores=2.0, mem=min(16 * GiB, max(4 * GiB, ckpt)))
    return b.build()


# registry entries (repro_torch.workloads): one pipeline per representative arch
def mlpipe_phi4(scale: float = 1.0, seed: int = 0):
    return mlpipe("phi4-mini-3.8b", scale=scale, seed=seed)


def mlpipe_deepseek(scale: float = 1.0, seed: int = 0):
    return mlpipe("deepseek-7b", scale=scale, seed=seed)


def mlpipe_mamba(scale: float = 1.0, seed: int = 0):
    return mlpipe("mamba2-780m", scale=scale, seed=seed)
