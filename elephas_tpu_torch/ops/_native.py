"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each source under ``elephas_tpu_torch/csrc/`` compiles, at first use, into
a shared library with a plain C interface in ``build/kernels/`` beside the
package (a directory ``.gitignore`` lists). The library's name carries a
hash of its source and flags, so an edited source rebuilds and an unchanged
one is loaded as built. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "flash_fwd": _PKG / "csrc" / "flash_fwd.cu",
    "layer_norm": _PKG / "csrc" / "layer_norm.cu",
}
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_TIMEOUT_S = 600
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": wall time of the nvcc run, "ptxas": its -Xptxas -v report}
build_log: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together; returns each name's library path."""
    names = list(SOURCES) if names is None else list(names)
    targets = {n: _target(n) for n in names}
    missing = [n for n in names if not targets[n].exists()]
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for n in missing:
            tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            try:
                log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                log = proc.communicate()[0] + f"\nnvcc ran past {NVCC_TIMEOUT_S} s"
            build_log[n] = {
                "seconds": time.perf_counter() - t0, "ptxas": log.strip()
            }
            if proc.returncode:
                failed.append(f"{SOURCES[n].name}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                # atomic: a concurrent process sees the old state or the whole library
                os.replace(tmp, targets[n])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _libs[name] = lib
    return lib
