"""Input pipeline: host-side generation, a bounded background prefetch,
and the host-to-device put — the PyTorch counterpart of
``repro.data.pipeline`` on one device.

The worker thread generates each (step, batch) and, for a CUDA target,
copies it into pinned host memory; the consumer issues the device copy
with ``non_blocking=True``, so the copy runs on the stream behind the work
already queued and host-side generation overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


def make_global_batch(local: np.ndarray, device: Optional[torch.device] = None,
                      pin: bool = False) -> torch.Tensor:
    """(B, S) token ids -> an int64 tensor on ``device`` (None: the host).
    ``pin`` stages it in pinned memory, so the device copy is asynchronous."""
    t = torch.from_numpy(np.ascontiguousarray(local, dtype=np.int64))
    if pin:
        t = t.pin_memory()
    if device is None or torch.device(device).type == "cpu":
        return t
    return t.to(device, non_blocking=pin)


class PrefetchIterator:
    """Wraps a (step, np.ndarray) iterator with a bounded background queue
    of ``depth`` batches; yields (step, tensor on ``device``)."""

    def __init__(self, it: Iterator, device=None, depth: int = 2):
        self.it = it
        self.device = torch.device(device) if device is not None else None
        self.pin = self.device is not None and self.device.type == "cuda"
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for step, batch in self.it:
                if self._stop.is_set():
                    return
                host = make_global_batch(batch, None, pin=self.pin)
                self.q.put((step, host))
        except Exception as e:  # surface in consumer
            self.q.put(e)
        self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        step, host = item
        if self.device is None or self.device.type == "cpu":
            return step, host
        return step, host.to(self.device, non_blocking=True)

    def close(self, timeout: float = 10.0):
        """Stop the worker: drain the queue so a blocked ``put`` returns,
        then wait for the thread (it ends after at most one more batch)."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.05)
            timeout -= 0.05
            if timeout <= 0:
                raise TimeoutError("the prefetch worker did not stop")
