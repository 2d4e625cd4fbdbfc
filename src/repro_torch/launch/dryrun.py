"""Dry run for one H100: every (arch x shape) cell's step, counted without
the card.

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for a TPU mesh without a TPU.  Here PyTorch's meta device
stands in for the card: the model, the optimizer state and the inputs are
meta tensors (shapes and dtypes, no memory), the kernel wrappers return
outputs of their CUDA shapes without arithmetic, and one step runs under
``roofline.counting.Counter``.  The dry run allocates nothing and launches
nothing; that is its purpose, not a fallback.  It runs on any machine, the
CPU-only one included.

For each cell:
    model = Model(cfg, device="meta")
    with Counter("meta") as c:
        step(...)            # make_train_step | make_prefill_step |
                             # make_serve_step, as launch/steps.py makes them
    -> memory (parameters, gradients, optimizer state, inputs, the peak of
       live bytes over the step with autograd's and remat's lifetimes),
       whether it fits the card's HBM, the counts by kind, and the
       three-term ``RooflineReport`` at the H100's data-sheet peaks

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --batch 2 --seq 2048 --moments bfloat16

``--batch``, ``--seq``, ``--layers`` and ``--moments`` cut a cell to the
size a run on one card takes (the reference's ``cfg_overrides``).  There is
no mesh: one card, so the collective term is 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from ..configs import ARCHS, SHAPES, applicable, get_config, get_smoke
from ..models import Model
from ..optim import AdamW, AdamWConfig
from ..roofline import Counter, RooflineReport, model_flops
from ..roofline.model import HBM_BW, HBM_BYTES, PEAK_FLOPS
from .input_specs import batch_specs, cache_specs
from .steps import make_prefill_step, make_serve_step, make_train_step

MESH = "1xH100"


def _moment_dtype(cfg) -> str:
    # the reference's rule: bf16 Adam moments for the >100B-param MoE
    return "bfloat16" if cfg.param_counts()["total"] > 1e11 else "float32"


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def lower_cell(arch: str, shape_name: str, cfg_overrides: dict | None = None,
               batch: int | None = None, seq: int | None = None,
               moments: str | None = None, smoke: bool = False):
    """Returns (run, meta) for one cell: ``run()`` runs its step once on
    meta; ``meta`` holds the config, the shape and the memory the step
    starts from.  (None, {"skipped": why}) when the shape does not apply.
    ``smoke`` takes the arch's smoke config."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    if seq is not None:
        shape = dataclasses.replace(shape, seq_len=seq)
    model = Model(cfg, device="meta")
    params = dict(model.named_parameters())
    bspec = batch_specs(cfg, shape)
    memory = {"params_bytes": _bytes(params.values()), "grads_bytes": 0,
              "opt_bytes": 0, "inputs_bytes": _bytes(bspec.values())}
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "cfg": cfg, "batch": shape.global_batch, "seq": shape.seq_len,
            "memory": memory}
    if shape.kind == "train":
        moments = moments or _moment_dtype(cfg)
        opt = AdamW(AdamWConfig(moment_dtype=moments))
        state = {"params": params, "opt": opt.init(params)}
        memory["grads_bytes"] = memory["params_bytes"]
        memory["opt_bytes"] = _bytes(_leaves(state["opt"]))
        meta["moments"] = moments
        step = make_train_step(model, opt)

        def run():
            step(state, bspec)
    elif shape.kind == "prefill":
        step = make_prefill_step(model)

        def run():
            step(bspec)
    else:
        cache = cache_specs(cfg, shape)
        memory["inputs_bytes"] += _bytes(_leaves(cache))
        step = make_serve_step(model)

        def run():
            step(bspec["tokens"], cache)
    memory["state_bytes"] = (memory["params_bytes"] + memory["grads_bytes"]
                             + memory["opt_bytes"])
    return run, meta


def run_cell(arch: str, shape_name: str, verbose: bool = True,
             cfg_overrides: dict | None = None, batch: int | None = None,
             seq: int | None = None, moments: str | None = None,
             smoke: bool = False) -> dict:
    """One cell's row: status "ok" with its memory, counts and roofline,
    "skipped" (the shape does not apply to the arch) or "error"."""
    t0 = time.time()
    head = {"arch": arch, "shape": shape_name, "mesh": MESH}
    try:
        run, meta = lower_cell(arch, shape_name, cfg_overrides, batch, seq,
                               moments, smoke)
        if run is None:
            return {**head, "status": "skipped", "reason": meta["skipped"]}
        with Counter("meta") as counter:
            run()
    except Exception as e:  # a failure on meta is a bug of the port
        return {**head, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}
    cfg, mem = meta["cfg"], meta["memory"]
    counts = counter.summary()
    # the step starts from its state (parameters, optimizer state) and
    # inputs; the gradients and every temporary are the step's own
    mem["peak_bytes"] = (mem["params_bytes"] + mem["opt_bytes"]
                         + mem["inputs_bytes"] + counts["peak_bytes"])
    mem["fits"] = mem["peak_bytes"] <= HBM_BYTES
    mf = model_flops(cfg, meta["kind"], meta["batch"], meta["seq"])
    rep = RooflineReport(
        arch=arch, shape=shape_name, mesh=MESH, chips=1,
        flops_per_device=counts["flops"], bytes_per_device=counts["bytes"],
        collective_bytes_per_device=0.0, collective_by_kind={},
        model_flops_global=mf).finalize()
    out = {**head, "chips": 1, "kind": meta["kind"], "status": "ok",
           "batch": meta["batch"], "seq": meta["seq"],
           "n_layers": cfg.n_layers, "moments": meta.get("moments"),
           "dryrun_s": round(time.time() - t0, 2), "memory": mem,
           "counts": counts, "roofline": rep.row(), "model_flops": mf,
           "bound_s": max(rep.compute_s, rep.memory_s, rep.collective_s)}
    if verbose:
        print(f"== {arch} x {shape_name} ({meta['kind']}, batch "
              f"{meta['batch']}, seq {meta['seq']}, {cfg.n_layers} layers"
              + (f", {meta['moments']} moments" if "moments" in meta
                 else "") + f"; {out['dryrun_s']} s on meta)")
        print(f"   memory: state {mem['state_bytes'] / 1e9:.1f} GB "
              f"(params {mem['params_bytes'] / 1e9:.1f}, grads "
              f"{mem['grads_bytes'] / 1e9:.1f}, optimizer "
              f"{mem['opt_bytes'] / 1e9:.1f}), inputs "
              f"{mem['inputs_bytes'] / 1e9:.2f}, peak "
              f"{mem['peak_bytes'] / 1e9:.1f} GB: "
              + ("fits" if mem["fits"] else "does not fit")
              + f" {HBM_BYTES / 1e9:.0f} GB")
        print("   counts: " + "; ".join(
            f"{k} {v['flops'] / 1e12:.3f} TFLOP {v['bytes'] / 1e9:.2f} GB"
            for k, v in counts["kinds"].items())
            + f"; kernel calls {counts['calls']}")
        print(f"   roofline (data-sheet peaks, {PEAK_FLOPS / 1e12:.0f} "
              f"TFLOP/s, {HBM_BW / 1e12:.2f} TB/s): compute "
              f"{rep.compute_s * 1e3:.2f} ms, memory "
              f"{rep.memory_s * 1e3:.2f} ms, bottleneck {rep.bottleneck}, "
              f"useful {rep.useful_ratio:.2f}, peak_frac "
              f"{rep.peak_fraction:.3f}")
    return out


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output dir")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--moments", choices=["float32", "bfloat16"],
                    default=None, help="AdamW's moment dtype (default: the "
                    "reference's rule, bf16 above 100 G parameters)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        archs = [args.arch] if args.arch else ARCHS
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]
    overrides = {"n_layers": args.layers} if args.layers else None

    results = []
    for arch, shape in cells:
        res = run_cell(arch, shape, cfg_overrides=overrides,
                       batch=args.batch, seq=args.seq, moments=args.moments)
        results.append(res)
        if res["status"] == "error":
            print(f"!! {arch} x {shape}: {res['error']}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            path = os.path.join(args.out, f"{arch}__{shape}__{MESH}.json")
            with open(path, "w") as f:
                json.dump(res, f, indent=1, default=str)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors / {len(results)} cells")
    if n_err:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
