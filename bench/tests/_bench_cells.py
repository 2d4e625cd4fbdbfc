"""A scratch checkout for the CPU tests: ``BENCHMARK.json`` and ``bench/``
copied, with cells at the configurations' smoke sizes added by files and
entries alone, as a later change adds a cell."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

OPTIMIZER = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
             "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 1,
             "total_steps": 10000, "moment_dtype": "float32"}
ARCHS = {
    "smoke-dense": {"name": "smoke-dense", "family": "dense", "n_layers": 2,
                    "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
                    "head_dim": 16, "d_ff": 128, "vocab": 512,
                    "param_dtype": "float32", "compute_dtype": "float32",
                    "remat": "none"},
}
TRAFFIC = {
    "smoke-train": {"kind": "train", "batch": 2, "seq_len": 20,
                    "checked_steps": 3, "file_steps": 16,
                    "trace": {"from": 1, "steps": 2}},
    "smoke-serve": {"kind": "serve", "slots": 4, "max_len": 48,
                    "arrival": {"process": "backlog", "count": 8},
                    "prompt": {"dist": "lognormal", "median": 8,
                               "sigma": 0.5, "min": 4, "max": 16},
                    "output": {"dist": "uniform", "min": 4, "max": 12},
                    "check_tokens": 30, "trace": {"from": 2, "steps": 4}},
}
CELLS = {"smoke-dense.smoke-train": ("smoke-dense", "smoke-train"),
         "smoke-dense.smoke-serve": ("smoke-dense", "smoke-serve")}
# the smoke cells' limits: f32 both sides, so the gaps are rounding's
LIMITS = {"smoke-train": {"loss_gap": 1e-4, "grad_gap": 1e-3,
                          "change_gap": 1e-2},
          "smoke-serve": {"logit_gap": 1e-3}}


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def smoke_root(tmp: Path) -> Path:
    """A copy of the benchmark under ``tmp`` with the smoke cells added."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, arch in ARCHS.items():
        write(root / "bench" / "configs" / f"{name}.json",
              {"name": name, "arch": arch, "optimizer": OPTIMIZER})
        bench["configs"].append({"name": name, "source": "smoke",
                                 "file": f"bench/configs/{name}.json",
                                 "reduced": [], "why": "CPU tests"})
    for name, traffic in TRAFFIC.items():
        write(root / "bench" / "traffic" / f"{name}.json", traffic)
    # each smoke cell reports what the cell of its kind does
    like = {"smoke-train": "deepseek-7b.train-1x4096",
            "smoke-serve": "deepseek-7b.serve-batch"}
    for cell, (config, traffic) in CELLS.items():
        write(root / "bench" / "limits" / f"{cell}.json", LIMITS[traffic])
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like[traffic] in m.get("workloads", ()):
                m["workloads"].append(cell)
    write(root / "BENCHMARK.json", bench)
    return root
