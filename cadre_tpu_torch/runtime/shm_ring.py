"""ctypes bindings of the shared-memory frame ring (runtime/ringbuf.cpp).

The port's copy of the JAX package's `ShmRing`. The library is built with
g++ into `build/host/` at first use (runtime/native.py); see ringbuf.cpp
for the design: single producer, single consumer, fixed-size frames,
latest-wins when full.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Union

import numpy as np

from cadre_tpu_torch.runtime import native

_TIMEOUT_SENTINEL = 2 ** 64 - 1


def _lib() -> ctypes.CDLL:
    lib = native.load("ringbuf", link=("-lrt",))
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                              ctypes.c_uint64]
    lib.rb_attach.restype = ctypes.c_void_p
    lib.rb_attach.argtypes = [ctypes.c_char_p]
    lib.rb_frame_bytes.restype = ctypes.c_uint64
    lib.rb_frame_bytes.argtypes = [ctypes.c_void_p]
    lib.rb_slots.restype = ctypes.c_uint32
    lib.rb_slots.argtypes = [ctypes.c_void_p]
    lib.rb_available.restype = ctypes.c_uint64
    lib.rb_available.argtypes = [ctypes.c_void_p]
    lib.rb_write.restype = ctypes.c_uint64
    lib.rb_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_uint64]
    lib.rb_read.restype = ctypes.c_uint64
    lib.rb_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_uint64]
    lib.rb_read_batch.restype = ctypes.c_uint64
    lib.rb_read_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_uint64]
    lib.rb_close.restype = None
    lib.rb_close.argtypes = [ctypes.c_void_p]
    return lib


def ring_bytes(n_slots: int, frame_bytes: int) -> int:
    """Bytes of /dev/shm one ring takes: its header, n_slots slot
    headers and n_slots frames (ringbuf.cpp's ring_bytes)."""
    return 32 + 8 * n_slots + n_slots * frame_bytes


class ShmRing:
    """One direction of a worker <-> trainer channel: `create=True` makes
    the named ring (and unlinks it on close), otherwise attaches to it."""

    def __init__(self, name: str, n_slots: int = 0, frame_bytes: int = 0,
                 create: bool = False):
        self._h = None
        self._lib = _lib()
        self.name = name
        if create:
            h = self._lib.rb_create(name.encode(), n_slots, frame_bytes)
        else:
            h = self._lib.rb_attach(name.encode())
        if not h:
            err = ctypes.get_errno()
            what = (f"create ring {name!r} of {n_slots} x {frame_bytes} "
                    f"bytes ({ring_bytes(n_slots, frame_bytes)} bytes of "
                    "/dev/shm)" if create else f"attach ring {name!r}")
            raise OSError(err, f"failed to {what}: {os.strerror(err)}")
        self._h = h
        self.frame_bytes = int(self._lib.rb_frame_bytes(self._h))
        self.n_slots = int(self._lib.rb_slots(self._h))

    def write(self, data: Union[bytes, np.ndarray]) -> int:
        """Write one frame of at most frame_bytes; returns its index.
        Longer data raises: the ring never cuts a frame to fit."""
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data).tobytes()
        if len(data) > self.frame_bytes:
            raise ValueError(f"a frame of {len(data)} bytes does not fit "
                             f"ring {self.name!r} of {self.frame_bytes}-byte "
                             "frames")
        return int(self._lib.rb_write(self._h, data, len(data)))

    def read(self, timeout_ms: int = 1000) -> Optional[bytes]:
        """The next frame, or None after `timeout_ms` without one."""
        buf = ctypes.create_string_buffer(self.frame_bytes)
        idx = self._lib.rb_read(self._h, buf, timeout_ms)
        if idx == _TIMEOUT_SENTINEL:
            return None
        return buf.raw

    def read_batch(self, max_frames: int, timeout_ms: int = 1000
                   ) -> np.ndarray:
        """Up to `max_frames` frames as [k, frame_bytes] uint8, waiting up
        to `timeout_ms` for the first (k = 0 on timeout)."""
        buf = ctypes.create_string_buffer(self.frame_bytes * max_frames)
        k = int(self._lib.rb_read_batch(self._h, buf, max_frames,
                                        timeout_ms))
        arr = np.frombuffer(buf.raw[: k * self.frame_bytes], np.uint8)
        return arr.reshape(k, self.frame_bytes)

    @property
    def available(self) -> int:
        return int(self._lib.rb_available(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.rb_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
