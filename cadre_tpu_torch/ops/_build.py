"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `cadre_tpu_torch/csrc/` becomes one shared library with a
plain C interface in `build/kernels/` at the root of the checkout, built at
first use and reused while it is newer than its source. Sources are built
in parallel, one nvcc per source. Nothing here runs at import time: the
CPU tests import every module on a machine without nvcc or a GPU.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("paint", "dual_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every stale source in `names` at once; returns the wall
    seconds of the whole build per compiled name (0.0 when it was fresh).
    Raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if _stale(n)]
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    seconds = time.perf_counter() - t0
    return {n: (seconds if n in procs else 0.0) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
