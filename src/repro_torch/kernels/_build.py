"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch_kernels/`` at the root of the checkout.  A library is
named by a hash of its source and flags, so an edit rebuilds it and an
unchanged source is built once.  Nothing is built at import: the first call
of a kernel builds it, and ``build_all`` builds every kernel at once, one
``nvcc`` process per source, all started together.

Every header a source includes with ``#include "..."``, followed
transitively (``csrc/sm90.cuh`` is shared by the kernels that run ``wgmma``
fed by TMA), enters the hash too.  The compiler's report (``-Xptxas -v``:
registers, shared memory, spills) is kept beside each library as
``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch_kernels"

# kernel name -> source, relative to this directory
SOURCES = {
    "flash_attn_fwd": "flash_attention/csrc/flash_attn_fwd.cu",
    "flash_attn_bwd": "flash_attention/csrc/flash_attn_bwd.cu",
    "moe_gmm": "moe_gmm/csrc/moe_gmm.cu",
    "moe_gmm_bwd": "moe_gmm/csrc/moe_gmm_bwd.cu",
    "ssd_intra_chunk": "ssd/csrc/ssd_intra_chunk.cu",
    "ssd_intra_chunk_bwd": "ssd/csrc/ssd_intra_chunk_bwd.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def included_headers(src: Path) -> list[Path]:
    """The headers ``src`` includes with ``#include "..."``, each resolved
    beside the file that names it, followed transitively, in the order
    first reached.  Raises if one is missing."""
    seen: list[Path] = []
    todo = [src.resolve()]
    while todo:
        path = todo.pop(0)
        for inc in _INCLUDE.findall(path.read_text()):
            header = (path.parent / inc).resolve()
            if header in seen:
                continue
            if not header.is_file():
                raise FileNotFoundError(f"{path.name} includes {inc!r}, "
                                        f"not found at {header}")
            seen.append(header)
            todo.append(header)
    return seen


def library_path(name: str, root: Path = _PKG) -> Path:
    """Where kernel ``name``'s library goes: named by a hash of its source,
    every header it includes (transitively) and the flags.  ``root`` is the
    directory the sources lie under (this package's, or a copy's)."""
    src = root / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in included_headers(src):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; (popen, tmp, out)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_PKG / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)     # atomic: a concurrent reader sees all or nothing


def build_all(names=None) -> dict[str, Path]:
    """Build every kernel (or ``names``) in parallel; name -> library path."""
    names = list(SOURCES if names is None else names)
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            _finish(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``, or ''."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if the C launcher of ``name`` returned a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
