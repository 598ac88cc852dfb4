"""Build and load the port's CUDA kernels.

Each source in ``repro_torch/csrc`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries go to
``<checkout>/build/kernels`` under a name that carries a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one loads.
Sources build in parallel: one ``nvcc`` per source, all started together.
Nothing is built at import time; the first launch (or ``build_all``)
builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"routing": "routing.cu", "nsa_verify": "nsa_verify.cu",
           "flash_verify": "flash_verify.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _paths(name: str):
    src = CSRC / SOURCES[name]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    stem = f"lib{name}_{digest.hexdigest()[:12]}"
    return src, BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.ptxas.txt"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source in parallel. Returns {name: the ``-Xptxas -v``
    report (registers, shared memory, spills)}. Raises with the compiler's
    output when a build fails."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib, report = _paths(name)
        if lib.exists() and report.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, report)
    failed = []
    for name, (proc, tmp, lib, report) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode})\n{out}")
            continue
        report.write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _paths(name)[2].read_text() for name in names}


_hits = _misses = 0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed. Every
    launch looks its library up here: a hit is a launch that found its
    kernel loaded, a miss one that had to build or load it."""
    global _hits, _misses
    lib = _loaded.get(name)
    if lib is None:
        _misses += 1
        build_all([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _loaded[name] = lib
    else:
        _hits += 1
    return lib


def library_cache_info() -> Tuple[int, int, int]:
    """(hits, misses, libraries loaded) of ``library`` in this process."""
    return _hits, _misses, len(_loaded)
