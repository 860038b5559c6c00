"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `cadre_tpu_torch/csrc/` becomes one shared library with a
plain C interface in `build/kernels/` at the root of the checkout, built at
first use. A library is named after a hash of what it is built from (its
`.cu`, every `csrc/*.cuh` and `NVCC_FLAGS`), so a changed source, header
or flag always builds a new one and a stale library is never loaded
(the scheme of `utils/libbuild.py`, shared with the host libraries).
Sources are built in parallel, one nvcc per source. Nothing here runs at
import time: the CPU tests import every module on a machine without nvcc
or a GPU.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

from cadre_tpu_torch.utils import libbuild

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("paint", "dual_attention", "dual_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def source_hash(name: str, csrc: Path = CSRC,
                flags: Sequence[str] = NVCC_FLAGS) -> str:
    """12 hex digits of a hash of `csrc/<name>.cu`, every `csrc/*.cuh`
    (by name, in name order) and `flags`: what the library is built from."""
    return libbuild.content_hash(
        [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))], flags)


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_hash(name)}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every source in `names` whose library is missing, all at
    once; returns the wall seconds of the whole build per compiled name
    (0.0 when it was there). Raises with nvcc's output if any compile
    fails."""
    todo = {n: lib_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    t0 = time.perf_counter()
    results = libbuild.compile_all(
        {n: ([nvcc(), *NVCC_FLAGS, str(CSRC / f"{n}.cu")], lib)
         for n, lib in todo.items()})
    failed = []
    for name, (rc, out) in results.items():
        build_log[name] = out
        if rc != 0:
            failed.append(f"{name}.cu:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    seconds = time.perf_counter() - t0
    return {n: (seconds if n in todo else 0.0) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, built first if needed; one load per
    process."""
    def built() -> Path:
        build([name])
        return lib_path(name)
    return libbuild.load_once(f"kernels/{name}", built)


def cuda_stream(tensor: torch.Tensor) -> int:
    """The handle of the current CUDA stream of `tensor`'s device, for a
    kernel's C entry. Read raw, as torch's own generated kernels read it:
    `torch.cuda.current_stream()` builds a Stream object on every call,
    host time spent again on every launch."""
    return torch._C._cuda_getCurrentRawStream(tensor.get_device())


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
