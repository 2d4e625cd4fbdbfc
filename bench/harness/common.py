"""What every cell shares: finding its files by name, seeds, the device
and JAX checks, and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; the harness finds them as
``bench/configs/<config>.json`` and ``bench/traffic/<traffic>.json``, the
limits of its correctness numbers as ``bench/limits/<cell>.json`` and each
per-layer metric's reader as ``bench/metrics/<metric>.py``.  Adding a cell
or a metric adds files and entries; no file here names one.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# top-level module names that no process of the benchmark may hold: JAX,
# its libraries and the JAX package the port was made from (compared
# whole, so the port, ``repro_torch``, passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot give a result: it exits non-zero, printing none."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` and the files it is run
    from: {"cell", "config", "traffic", "limits", "metrics"} (the last
    {metric name: its entry} of the end-to-end and per-layer metrics that
    the cell reports)."""
    bench = benchmark(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    files = {
        "cell": cell,
        "config": root / configs[cell["config"]]["file"],
        "traffic": root / "bench" / "traffic" / f"{cell['traffic']}.json",
        "limits": root / "bench" / "limits" / f"{name}.json",
    }
    for key in ("config", "traffic", "limits"):
        if not files[key].is_file():
            raise BenchError(f"{name}: {key} file {files[key]} is missing")
    files["end_to_end"] = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
    files["per_layer"] = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
    return files


def metric_reader(name: str, root: Path = ROOT):
    """The module of ``bench/metrics/<name>.py``: its ``read(run)`` returns
    the metric's value, or None where the run has nothing to read."""
    path = root / "bench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"metric {name!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed of its own for each use of ``seed`` (weights of one
    leaf, the token file, the traffic), so that one use never shifts
    another's draws."""
    text = "/".join(str(k) for k in (seed, *keys)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") \
        & ((1 << 63) - 1)


def forbidden_modules() -> list[str]:
    """The modules of ``sys.modules`` whose top-level name is one of
    ``FORBIDDEN``, compared whole."""
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in FORBIDDEN)


def require_cards(count: int):
    """The CUDA device count, or BenchError where there are fewer cards
    than ``count`` (the run then prints no result)."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError("CUDA is not available: the benchmark measures the "
                         "port on the card only")
    have = torch.cuda.device_count()
    if have < count:
        raise BenchError(f"the cell asks for {count} cards, {have} found")
    return have


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
