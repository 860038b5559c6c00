"""Build shared libraries at first use and load them once per process.

The one scheme behind the port's CUDA kernels (`ops/_build.py`, nvcc) and
its host-side C++ libraries (`runtime/native.py`, g++). A library is named
after a hash of what it is built from (`lib<name>-<12 hex>.so`), so an
edited source, header or flag always builds a new one and a stale library
is never loaded. Each compiler writes to a temporary file of its own
process and thread, which then replaces the library's path in one step:
processes that build at the same moment (test workers, env workers) never
load a half-written library. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Mapping, Sequence, Tuple

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def content_hash(paths: Sequence[Path], flags: Sequence[str]) -> str:
    """12 hex digits of a hash of the files `paths` (by name and text, in
    the order given) and of `flags`."""
    h = hashlib.sha256()
    for path in paths:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:12]


def compile_all(jobs: Mapping[str, Tuple[Sequence[str], Path]]
                ) -> Dict[str, Tuple[int, str]]:
    """Run every job's compiler at once. A job is name -> (compiler
    command without its output, library path); `-o <temporary file>` is
    appended to the command, and a compile that succeeds replaces the
    library's path with its file. Returns name -> (exit code, compiler
    output); the caller raises on a failed one."""
    procs = {}
    for name, (cmd, lib) in jobs.items():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        procs[name] = (lib, tmp, subprocess.Popen(
            [*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    results = {}
    for name, (lib, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            tmp.unlink(missing_ok=True)
        results[name] = (proc.returncode, out)
    return results


def load_once(key: str, built: Callable[[], Path],
              use_errno: bool = False) -> ctypes.CDLL:
    """The library cached under `key`, or the one at the path `built()`
    returns (building it first where it is missing), loaded and cached."""
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(built()), use_errno=use_errno)
            _loaded[key] = lib
        return lib
