"""Overlap host batching and host-to-device copies with the device's work:
the counterpart of cadre_tpu.rl.pipeline.DevicePrefetcher, for iterators
of numpy batches (dicts of arrays; its callers are the perception and
CIL trainers).

A background thread runs the iterator (shard decompression, host
augmentation) and puts each batch's arrays into page-locked (pinned) host
memory. The caller's thread keeps `depth` batches' copies in flight: each
is issued with non_blocking=True on a side stream to the explicit
`device`, and the batch is handed out only after the caller's current
stream has been made to wait for that copy (an event), so the compute
stream never reads a batch before it has landed and never waits on the
host. On the CPU the batches are handed out as tensors, without pinning
or streams.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

Batch = Dict[str, torch.Tensor]


class DevicePrefetcher:
    """Iterate `iterable`'s numpy batches (dicts of arrays) as dicts of
    tensors on `device`, `depth` batches ahead."""

    _END = object()

    def __init__(self, iterable: Iterable[Dict[str, np.ndarray]], device,
                 depth: int = 2):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._host: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._produce, args=(iterable,),
                                        daemon=True)
        self._thread.start()
        self._ready: "collections.deque" = collections.deque()
        self._ended = False
        for _ in range(depth):
            self._issue()

    def _produce(self, iterable) -> None:
        try:
            for batch in iterable:
                host = {k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in batch.items()}
                if self._cuda:
                    host = {k: t.pin_memory() for k, t in host.items()}
                self._host.put(host)
        except BaseException as e:  # noqa: BLE001 - raised in __next__
            self._err = e
        finally:
            self._host.put(self._END)

    def _issue(self) -> None:
        """Start the copy of the next host batch, if there is one."""
        if self._ended:
            return
        host = self._host.get()
        if host is self._END:
            self._ended = True
            return
        if not self._cuda:
            self._ready.append((host, None))
            return
        with torch.cuda.stream(self._stream):
            dev = {k: t.to(self.device, non_blocking=True)
                   for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        self._ready.append((dev, done))

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        if not self._ready:            # every batch handed out
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, done = self._ready.popleft()
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in batch.values():   # allocated on the side stream
                t.record_stream(current)
        self._issue()
        return batch

