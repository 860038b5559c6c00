"""Build the port's host-side C++ libraries with g++ and load them with
ctypes.

Each source `runtime/<name>.cpp` becomes one shared library in
`build/host/` at the root of the checkout, built at first use, never at
import, by the scheme of `utils/libbuild.py` (the one the CUDA kernels
use): named after a hash of the source, the compiler flags and its link
libraries (`libringbuf-<12 hex>.so`), written to a temporary file and
then renamed. A failed build raises with the compiler's output: there is
no fallback.
"""
from __future__ import annotations

import ctypes
import shutil
from pathlib import Path
from typing import Sequence

from cadre_tpu_torch.utils import libbuild

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "host"
# no FMA contraction: the rasterizer's centres must round as numpy's do
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")


def lib_path(name: str, link: Sequence[str] = ()) -> Path:
    h = libbuild.content_hash([SRC_DIR / f"{name}.cpp"], (*CXX_FLAGS, *link))
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(name: str, link: Sequence[str] = ()) -> Path:
    """Compile `runtime/<name>.cpp` unless its library exists; returns the
    library's path. Raises with g++'s output if the compile fails."""
    lib = lib_path(name, link)
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"building {name}.cpp: g++ not found")
    cmd = [gxx, *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), *link]
    rc, out = libbuild.compile_all({name: (cmd, lib)})[name]
    if rc != 0:
        raise RuntimeError(f"g++ failed for {name}.cpp ({' '.join(cmd)}):\n"
                           f"{out}")
    return lib


def load(name: str, link: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of `name` (errno kept for ctypes.get_errno),
    built first if needed; one load per process."""
    return libbuild.load_once(f"host/{name}", lambda: build(name, link),
                              use_errno=True)
