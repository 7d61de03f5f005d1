"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each library is compiled on first use into ``build/kernels/`` at the root
of the checkout, named by a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  The sources expose a
plain C interface (no PyTorch headers), which keeps a build to seconds.
Any build or load failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-split-compile=0",  # optimize a source's kernels in parallel, on every core
]

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}
"""Wall seconds of each build this process ran (absent when reused)."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (cuda_home / "bin" / "nvcc").exists():
        return str(cuda_home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (and the shared
    headers) lives."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> None:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together.  The ptxas report
    (registers, shared memory, spills) is kept beside each library as
    ``<lib>.log``.  Raises if any build fails."""
    running = []
    for name in dict.fromkeys(names):
        lib = library_path(name)
        if name in _LOADED or lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = lib.with_suffix(".log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as out:
            proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, lib, log, time.perf_counter()))
    failed = []
    for name, proc, tmp, lib, log, t0 in running:
        if proc.wait() != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {name}:\n{log.read_text()}")
            continue
        BUILD_SECONDS[name] = time.perf_counter() - t0
        tmp.rename(lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
