"""Dry run: every (arch x shape) cell's step counted without the card, on
one H100 or as one rank of the reference's production meshes holds it.

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for a TPU mesh without a TPU.  Here PyTorch's meta device
stands in for the card: the model, the optimizer state and the inputs are
meta tensors (shapes and dtypes, no memory), the kernel wrappers return
outputs of their CUDA shapes without arithmetic, and one step runs under
``roofline.counting.Counter``.  The dry run allocates nothing and launches
nothing; that is its purpose, not a fallback.  It runs on any machine, the
CPU-only one included.

For each cell:
    model = Model(cfg, device="meta"[, mesh=mesh])
    with Counter("meta", mesh) as c:
        step(...)            # make_train_step | make_prefill_step |
                             # make_serve_step, as launch/steps.py makes them
    -> memory (parameters, gradients, optimizer state, inputs, the peak of
       live bytes over the step with autograd's and remat's lifetimes),
       whether it fits the card's HBM, the counts by kind, the collectives
       by kind, count and mesh axis, and the three-term ``RooflineReport``
       at the H100's data-sheet peaks

Without ``--multi-pod`` a cell runs on one card (mesh "1xH100"), with no
collective.  ``--multi-pod off|on|both`` selects the reference's production
meshes instead: (16, 16) = 256 cards ("16x16") and (2, 16, 16) = 512
("2x16x16"), in ``--sharding-mode`` "tp" or "fsdp", ZeRO-1 moments unless
``--no-zero1``, as the reference's flags do.  Such a cell is counted as ONE
rank holds it (``--rank``; by default the last, every coordinate last: under
a sequence split the last rank attends to the most keys, and no layout gives
another rank more work): a meta model on a world of the "fake" backend
(``launch/mesh.fake_world``), which dispatches every collective on meta
tensors and moves nothing, so the counter books each at the reference's
ring cost for its group.  The rank holds its parameter and moment parts
(``shard_params``, ZeRO-1's), the steps cut its part of the whole batch
(the decode step its rows, ``make_serve_step``) and its decode cache is the
port's layout (``shardings.decode_cache_specs``, which the row compares
with the rules' ``cache_shardings``).  A fake world must be the only
process group of its process: run the mesh dry run in a process of its own
(``chip_smoke.py`` starts one beside its NCCL phases).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --multi-pod both --sharding-mode fsdp --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --batch 2 --seq 2048 --moments bfloat16

``--batch``, ``--seq``, ``--layers`` and ``--moments`` cut a cell to the
size a run takes (the reference's ``cfg_overrides``).  Every figure is an
estimate at data-sheet peaks, not a measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, applicable, get_config, get_smoke
from ..models import Model
from ..models.common import set_sharding_mode
from ..optim import AdamW, AdamWConfig
from ..roofline import (Counter, RooflineReport, collective_s_by_axis,
                        model_flops)
from ..roofline.model import (HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS,
                              POD_BW)
from .input_specs import batch_specs, cache_specs, rank_bytes
from .mesh import coordinate, fake_world, production_spec
from .shardings import (batch_shardings, cache_shardings, decode_cache_specs,
                        split_axes)
from .steps import make_prefill_step, make_serve_step, make_train_step

MESH = "1xH100"


def mesh_tag(multi_pod: bool) -> str:
    """The reference's name of a production mesh."""
    return "2x16x16" if multi_pod else "16x16"


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


@contextlib.contextmanager
def _mode(mode: str):
    """Models built inside are built in sharding ``mode``."""
    set_sharding_mode(mode)
    try:
        yield
    finally:
        set_sharding_mode("tp")


def _layout(cfg, shape, bspec: dict, mesh, mode: str) -> dict:
    """Where the rank's inputs lie: the axes of its rows and of its
    sequence's slice, and for a decode cell the cache's specs where the
    port's layout keeps whole what the rules split."""
    if shape.kind == "decode":
        rows, seq, _ = split_axes(batch_shardings(bspec, mesh, "tp"), mesh)
        whole = cache_specs(cfg, shape)
        rules = cache_shardings(whole, cfg, mesh)
        port = decode_cache_specs(whole, cfg, mesh, mode)
        kept = {k: {"rules": rules[k], "port": port[k]} for k in whole
                if k != "pos" and rules[k] != port[k]}
        return {"rows": rows, "seq": seq, "cache_kept_whole": kept}
    rows, seq, whole = split_axes(batch_shardings(bspec, mesh, mode), mesh)
    return {"rows": rows, "seq": seq, "whole": whole}


def lower_cell(arch: str, shape_name: str, cfg_overrides: dict | None = None,
               batch: int | None = None, seq: int | None = None,
               moments: str | None = None, smoke: bool = False, mesh=None,
               mode: str = "tp", zero1: bool = True):
    """Returns (run, meta) for one cell: ``run()`` runs its step once on
    meta; ``meta`` holds the config, the shape and the memory the step
    starts from.  (None, {"skipped": why}) when the shape does not apply.
    ``smoke`` takes the arch's smoke config.  On ``mesh`` (a meta mesh of
    ``fake_world``) the model is built in sharding ``mode`` and the memory
    is the rank's: its parameter parts, ZeRO-1's moment parts with
    ``zero1``, its part of the batch and its decode cache."""
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
    with _mode(mode):
        model = Model(cfg, device="meta", mesh=mesh)
    params = dict(model.named_parameters())
    bspec = batch_specs(cfg, shape)
    inputs = _bytes(bspec.values()) if mesh is None else rank_bytes(
        bspec, mesh, "tp" if shape.kind == "decode" else mode)
    memory = {"params_bytes": _bytes(params.values()), "grads_bytes": 0,
              "opt_bytes": 0, "inputs_bytes": inputs}
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "cfg": cfg, "batch": shape.global_batch, "seq": shape.seq_len,
            "memory": memory}
    if mesh is not None:
        meta["layout"] = _layout(cfg, shape, bspec, mesh, mode)
    if shape.kind == "train":
        moments = moments or _moment_dtype(cfg)
        opt = AdamW(AdamWConfig(moment_dtype=moments))
        state = {"params": params,
                 "opt": opt.init(params, model,
                                 zero1=zero1 and mesh is not None)}
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
        cache = cache_specs(cfg, shape, mesh, mode)
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
             smoke: bool = False, multi_pod: bool | None = None,
             mode: str = "tp", zero1: bool = True,
             rank: int | None = None) -> dict:
    """One cell's row: status "ok" with its memory, counts and roofline,
    "skipped" (the shape does not apply to the arch) or "error".  With
    ``multi_pod`` (False: (16, 16), True: (2, 16, 16)) the cell is counted
    as ``rank`` (default the last) of that production mesh holds it, in a
    fake world of its own for the cell's span."""
    t0 = time.time()
    if multi_pod is None:
        head = {"arch": arch, "shape": shape_name, "mesh": MESH,
                "torch": torch.__version__}
        world = contextlib.nullcontext()
    else:
        spec = production_spec(multi_pod=multi_pod)
        rank = spec.size - 1 if rank is None else rank
        head = {"arch": arch, "shape": shape_name, "mesh": mesh_tag(multi_pod),
                "chips": spec.size, "sharding_mode": mode, "zero1": zero1,
                "rank": rank, "torch": torch.__version__}
        world = fake_world(spec, rank)
    try:
        with world as mesh:
            run, meta = lower_cell(arch, shape_name, cfg_overrides, batch,
                                   seq, moments, smoke, mesh, mode, zero1)
            if run is None:
                return {**head, "status": "skipped",
                        "reason": meta["skipped"]}
            if mesh is not None:
                head["coordinate"] = coordinate(mesh)
            with Counter("meta", mesh) as counter:
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
    chips = head.get("chips", 1)
    rep = RooflineReport(
        arch=arch, shape=shape_name, mesh=head["mesh"], chips=chips,
        flops_per_device=counts["flops"], bytes_per_device=counts["bytes"],
        collective_bytes_per_device=counts["collective_bytes"],
        collective_by_kind=counts["collective_by_kind"],
        model_flops_global=mf).finalize()
    # the bound: each axis's link bytes at its own rate ("pod" over the
    # network), the axes' collectives one after another
    by_axis = collective_s_by_axis(counts["collective_by_axis"])
    out = {**head, "chips": chips, "kind": meta["kind"], "status": "ok",
           "batch": meta["batch"], "seq": meta["seq"],
           "n_layers": cfg.n_layers, "moments": meta.get("moments"),
           "dryrun_s": round(time.time() - t0, 2), "memory": mem,
           "counts": counts, "roofline": rep.row(), "model_flops": mf,
           "collective_s_by_axis": by_axis,
           "bound_s": max(rep.compute_s, rep.memory_s,
                          sum(by_axis.values()))}
    if "layout" in meta:
        out["layout"] = meta["layout"]
    if verbose:
        _print_row(out, meta, rep)
    return out


def _print_row(out: dict, meta: dict, rep: RooflineReport) -> None:
    mem, counts = out["memory"], out["counts"]
    where = out["mesh"] if out["mesh"] == MESH else (
        f"{out['mesh']} {out['sharding_mode']}"
        + (" + ZeRO-1" if out["zero1"] else "") + f", rank {out['rank']} "
        f"at {out['coordinate']}")
    print(f"== {out['arch']} x {out['shape']} on {where} ({out['kind']}, "
          f"batch {out['batch']}, seq {out['seq']}, {out['n_layers']} layers"
          + (f", {meta['moments']} moments" if "moments" in meta else "")
          + f"; {out['dryrun_s']} s on meta)")
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
    if counts["collective_counts"]:
        print("   collectives (link GB at ring costs): " + "; ".join(
            f"{k} {counts['collective_counts'][k]} calls "
            f"{v / 1e9:.3f} GB" for k, v in
            counts["collective_by_kind"].items()) + "; by axis " + ", ".join(
            f"{a} {v / 1e9:.3f} GB" for a, v in
            counts["collective_by_axis"].items()))
    if "layout" in out:
        print(f"   layout: {out['layout']}")
    print(f"   roofline (data-sheet peaks, {PEAK_FLOPS / 1e12:.0f} "
          f"TFLOP/s, {HBM_BW / 1e12:.2f} TB/s, links "
          f"{NVLINK_BW / 1e9:.0f} GB/s, pod {POD_BW / 1e9:.0f} GB/s): "
          f"compute {rep.compute_s * 1e3:.2f} ms, memory "
          f"{rep.memory_s * 1e3:.2f} ms, collective "
          f"{rep.collective_s * 1e3:.2f} ms ("
          + ", ".join(f"{a} {v * 1e3:.2f}" for a, v in
                      out["collective_s_by_axis"].items())
          + f"), bound {out['bound_s'] * 1e3:.2f} ms, bottleneck "
          f"{rep.bottleneck}, useful {rep.useful_ratio:.2f}, peak_frac "
          f"{rep.peak_fraction:.3f}")


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
    ap.add_argument("--multi-pod", choices=["on", "off", "both"],
                    default=None, help="count one rank of the production "
                    "meshes: off (16, 16), on (2, 16, 16), both; without "
                    "it, one card")
    ap.add_argument("--sharding-mode", choices=["tp", "fsdp"], default="tp")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--rank", type=int, default=None,
                    help="the rank counted on a mesh (default: the last)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        archs = [args.arch] if args.arch else ARCHS
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]
    overrides = {"n_layers": args.layers} if args.layers else None
    pods = {None: [None], "on": [True], "off": [False],
            "both": [False, True]}[args.multi_pod]

    results = []
    for arch, shape in cells:
        for mp in pods:
            res = run_cell(arch, shape, cfg_overrides=overrides,
                           batch=args.batch, seq=args.seq,
                           moments=args.moments, multi_pod=mp,
                           mode=args.sharding_mode, zero1=not args.no_zero1,
                           rank=args.rank)
            results.append(res)
            if res["status"] == "error":
                print(f"!! {arch} x {shape} on {res['mesh']}: "
                      f"{res['error']}")
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                tag = MESH if mp is None else \
                    f"{mesh_tag(mp)}__{args.sharding_mode}"
                path = os.path.join(args.out, f"{arch}__{shape}__{tag}.json")
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
