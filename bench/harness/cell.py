"""One run of one cell: set-up, the measured window, the per-layer readers
of a traced run, the correctness check and the result line.

The traffic file's ``kind`` names the runner (``train.py``, ``serve.py``);
the runner builds the program from the configuration file, runs the
window through this ``Context`` and fills its end-to-end metrics, the
values the readers take and the numbers compared."""
from __future__ import annotations

import argparse
import importlib
import json
import math
import shutil
import subprocess
import time

from .common import (BenchError, ROOT, cell_files, forbidden_modules,
                     load_json, metric_reader, require_cards, say)
from .roofline import Arch

RUNNERS = {"train": "harness.train", "serve": "harness.serve"}


class Context:
    """What a runner reads (the cell's files, the seed, the window's
    length) and fills (``end_to_end``, ``values``, ``checks``,
    ``attempted``, ``failed``)."""

    def __init__(self, args, files: dict, start: float, root=ROOT,
                 device: str = "cuda") -> None:
        import torch
        self.device = torch.device(device)
        self.name = args.workload
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace_on = bool(args.trace)
        self.files = files
        self.config = load_json(files["config"])
        self.arch = Arch(self.config["arch"])
        self.traffic = load_json(files["traffic"])
        self.limits = load_json(files["limits"])
        self.start = start
        self.values: dict = {}
        self.end_to_end: dict = {}
        self.checks: dict = {}
        self.attempted = self.failed = 0
        self.cleanup: list = []
        self.closers: list = []
        self.nodes: dict = {}
        self.readers = {m["name"]: metric_reader(m["name"], root)
                        for m in files["per_layer"]} if self.trace_on else {}
        self.tracer = None
        self.trace = None
        self.traced = 0
        self.t0 = self.t1 = None
        self.setup_s = None
        self.memory_peak = None

    # ------------------------------------------------------------- window
    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> None:
        self.sync()
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.start

    def trace_step(self, i: int) -> None:
        """Starts the profiler before the window's step ``trace.from`` and
        stops it before step ``from + steps`` (the traffic file's)."""
        if not self.trace_on:
            return
        first = self.traffic["trace"]["from"]
        if i == first:
            from .trace import Tracer
            self.tracer = Tracer(self.sync)
            self.tracer.start()
        elif i == first + self.traffic["trace"]["steps"] and self.tracer.on:
            self.tracer.stop()
        if self.tracer is not None and self.tracer.on:
            self.traced += 1

    def untraced(self, t: float) -> bool:
        """Whether host time ``t`` lies outside the traced stretch: the
        per-layer metrics read from the host clock take only those parts
        of a traced run's window, which the profiler does not slow."""
        tr = self.tracer
        lo, hi = (None, None) if tr is None else tr.span
        return lo is None or not (
            lo <= t <= (hi if hi is not None else float("inf")))

    def untraced_seconds(self, t0: float, t1: float) -> float:
        """The part of [t0, t1] outside the traced stretch."""
        lo, hi = (None, None) if self.tracer is None else self.tracer.span
        if lo is None:
            return t1 - t0
        hi = t1 if hi is None else hi
        return (t1 - t0) - max(0.0, min(t1, hi) - max(t0, lo))

    def close_window(self, t1: float) -> None:
        self.t1 = t1
        if self.tracer is not None and self.tracer.on:
            self.tracer.stop()

    def read_memory(self) -> None:
        import torch
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)

    def free(self) -> None:
        """Return the program's freed memory to the device, so that the
        reference, run after it, fits."""
        import gc

        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def wrap_kernels(self) -> None:
        """For a traced run: every function that a per-layer reader names
        in its ``WRAP`` ((module, attribute, short name)) is called inside
        a ``bench:<short name>`` range, and the autograd node of its
        output's backward is noted under the short name in ``nodes``."""
        from .trace import label
        for reader in self.readers.values():
            for module, attr, short in getattr(reader, "WRAP", ()):
                mod = importlib.import_module(module)
                orig = getattr(mod, attr)
                if getattr(orig, "bench_wrapped", False):
                    continue

                def wrapped(*a, _orig=orig, _short=short, **kw):
                    with label(_short):
                        out = _orig(*a, **kw)
                    first = out[0] if isinstance(out, tuple) else out
                    if getattr(first, "grad_fn", None) is not None:
                        self.nodes[_short] = first.grad_fn.name()
                    return out

                wrapped.bench_wrapped = True
                setattr(mod, attr, wrapped)
                self.closers.append(
                    lambda m=mod, a=attr, o=orig: setattr(m, a, o))

    def close(self) -> None:
        for fn in reversed(self.closers):
            fn()
        self.closers.clear()
        for path in self.cleanup:
            shutil.rmtree(path, ignore_errors=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json "
                                "once and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(ctx: Context, files: dict) -> dict:
    """The result line: the end-to-end metrics (``--trace 0``) or the
    per-layer metrics the readers find (``--trace 1``), the device, the
    breakdown of a traced run, and the numbers compared, last."""
    import torch
    units = {m["name"]: m["unit"] for m in
             files["end_to_end"] + files["per_layer"]}
    if ctx.trace_on:
        values = {}
        for name, reader in ctx.readers.items():
            v = reader.read(ctx)
            if v is not None:
                values[name] = v
    else:
        got = {**ctx.end_to_end, "setup_s": ctx.setup_s}
        missing = {m["name"] for m in files["end_to_end"]} - set(got)
        if missing:
            raise BenchError(f"the run gave no {sorted(missing)}")
        values = {m["name"]: got[m["name"]] for m in files["end_to_end"]}
    for name, v in values.items():
        if not math.isfinite(v):
            raise BenchError(f"{name} reads {v}")
    kind = (torch.cuda.get_device_name(ctx.device)
            if ctx.device.type == "cuda" else "cpu")
    device = {"platform": "gpu", "kind": kind,
              "count": files["cell"]["chips"],
              "memory_peak_bytes": ctx.memory_peak}
    line = {"correct": all(c["value"] <= c["limit"]
                           for c in ctx.checks.values()),
            "attempted": ctx.attempted, "failed": ctx.failed,
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": device}
    if ctx.trace_on:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
        line["breakdown"] = {"device_ops": ctx.trace.device_ops,
                             "idle_gaps": ctx.trace.idle_gaps}
    line["checks"] = ctx.checks
    return line


def run(args, start: float, root=ROOT, device: str = "cuda") -> tuple:
    """Run the cell ``args.workload`` once: (its result line, the Context).
    ``device`` "cpu" drives the same run on the CPU at whatever size the
    cell's files give (the tests' way past the look for a card)."""
    files = cell_files(args.workload, root)
    kind = load_json(files["traffic"])["kind"]
    if kind not in RUNNERS:
        raise BenchError(f"no runner for traffic of kind {kind!r}")
    ctx = Context(args, files, start, root, device)
    try:
        importlib.import_module(RUNNERS[kind]).run(ctx)
        if ctx.trace_on:
            if ctx.tracer is None:
                raise BenchError("the window ended before the traced steps "
                                 "began")
            ctx.trace = ctx.tracer.summary()
        return result(ctx, files), ctx
    finally:
        ctx.close()


def main(argv, start: float) -> int:
    try:
        args = parse(argv)
        require_cards(cell_files(args.workload)["cell"]["chips"])
        line, ctx = run(args, start)
    except (BenchError, ModuleNotFoundError) as e:
        say(f"bench: {type(e).__name__}: {e}")
        return 2
    held = forbidden_modules()
    if held:
        say(f"bench: the process holds {held}: the benchmark runs the port "
            f"without JAX or the JAX package")
        return 3
    say(f"bench: {args.workload} seed {args.seed} on {card_line()}")
    for name, v in ctx.end_to_end.items():
        if name not in line["metrics"]:
            say(f"reading {name} {v!r} (not a metric of this run)")
    for name, c in ctx.checks.items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0
