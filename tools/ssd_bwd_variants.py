#!/usr/bin/env python3
"""Time variants of the SSD backward kernel against each other on one card.

    python3 tools/ssd_bwd_variants.py VARIANTS.json [--dy-bf16]

VARIANTS.json maps a name to a list of text edits of the kernel's sources:
``[old, new]`` in ``ssd_intra_chunk_bwd.cu``, or ``[file, old, new]`` for a
header beside it (``ssd_mma.cuh``, ``ssd_cb.cuh``); ``{"base": []}`` is the
tree as it is.  Each variant is copied under
``build/ssd_bwd_variants/<name>/`` and built with the flags of
``kernels/_build.py``, all at once.  Each is then called through the port's
wrapper at mamba2-780m's and zamba2-2.7b's training shapes (x bf16, as
``chip_smoke.py`` draws them), and the script prints its registers and
spills (ptxas), its time replayed from a CUDA graph, each launch's device
time (``torch.profiler``) and the largest difference of its outputs from
the first variant's.  ``--dy-bf16`` rounds the cotangent dy to bf16 values,
as the bf16 training path hands it in.  Needs a CUDA card and nvcc; imports
neither JAX nor the JAX package."""
from __future__ import annotations

import contextlib
import ctypes
import io
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402

SRC = _build._PKG / "ssd" / "csrc"
FILES = ("ssd_intra_chunk_bwd.cu", "ssd_mma.cuh", "ssd_cb.cuh")
OUT = ROOT / "build" / "ssd_bwd_variants"


def build(variants: dict) -> dict:
    """name -> the loaded library of each variant that built."""
    jobs = {}
    for name, edits in variants.items():
        files = {f: (SRC / f).read_text() for f in FILES}
        for edit in edits:
            f, old, new = edit if len(edit) == 3 else (FILES[0], *edit)
            if old not in files[f]:
                raise ValueError(f"{name}: {old[:60]!r} is not in {f}")
            files[f] = files[f].replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / FILES[0])]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        regs = cs.instantiations([ln.strip() for ln in log.splitlines()
                                  if "registers" in ln or "spill" in ln
                                  or "entry function" in ln])
        print(f"{name}: rc {proc.returncode}; " + "; ".join(
            f"{k}: {v}" for k, v in regs.items() if k.startswith("ssd_bwd")),
            flush=True)
        if proc.returncode:
            print(log[-3000:], flush=True)
            continue
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.ssd_intra_chunk_bwd.argtypes = ssd_kernel._BWD_ARGTYPES
        lib.ssd_intra_chunk_bwd.restype = ctypes.c_int
        lib.ssd_bwd_groups.argtypes = [ctypes.c_int]
        lib.groups = (lib.ssd_bwd_groups(0), lib.ssd_bwd_groups(1))
        libs[name] = lib
    return libs


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_variants: no CUDA card", file=sys.stderr)
        return 1
    variants = json.loads(Path(argv[0]).read_text())
    card = cs.phase_info()
    libs = build(variants)
    for shape in cs.SSD_BWD_TIMED.values():
        gen = torch.Generator("cuda").manual_seed(16)
        x = cs.ssd_inputs(*shape, True, gen)
        dy, ds = cs.ssd_cotangents(shape, "both", gen)
        if "--dy-bf16" in argv:
            dy = dy.bfloat16().float()
        first = None
        for name, lib in libs.items():
            ssd_kernel._BWD_LIB = lib

            def call():
                return ssd_kernel.ssd_intra_chunk_bwd_cuda(*x, dy, ds)
            got = call()
            torch.cuda.synchronize()
            first = got if first is None else first
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(got, first))
            ms = cs.graph_ms(call, 10)
            with contextlib.redirect_stdout(io.StringIO()):
                parts = cs.profile_region(call, name, card, top=6,
                                          groups=cs.SSD_BWD_PARTS)
            print(f"{shape} {name}: graph {ms:.4f} ms; " + ", ".join(
                f"{k} {v:.4f}" for k, v in parts.get("groups", {}).items()
                if v) + f"; largest difference from the first {diff:.2e} "
                f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
