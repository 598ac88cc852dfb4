"""Starting the ranks of one host: spawned processes
(``torch.multiprocessing``) joined through a ``FileStore``.

The collective backend and the device are the caller's, never picked
here: NCCL takes one card per rank and raises when the world has more
ranks than the host has cards; gloo runs CPU tensors, or CUDA tensors of
ranks that share the cards (rank r on card r mod count) when the caller
names ``device_type="cuda"``. There is no fallback from one backend or
device to another. A rank that raises makes ``spawn`` raise, so a caller's
process exits non-zero; a world that outlives its ``timeout`` is killed.
A rank that raises prints its traceback at once and leaves its process
group to the process's exit: tearing the group down (``destroy_process_
group``) waits for the ranks that are blocked in a collective with it,
and a rank that ran out of memory mid-layer so hid its error behind a hung
world until NCCL's 600 s watchdog ended it.
"""
from __future__ import annotations

import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def rank_device(rank: int, world: int, backend: str, device_type: str) -> torch.device:
    """The device of ``rank``; raises for a pairing the backend refuses."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs CUDA tensors only; name gloo for CPU ranks")
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device_type='cpu' with gloo "
                           "to run the ranks on the CPU")
    cards = torch.cuda.device_count()
    if backend == "nccl" and world > cards:
        raise RuntimeError(f"NCCL takes one card per rank: a world of {world} ranks needs "
                           f"{world} cards and this host has {cards}; name gloo to share "
                           "the cards")
    return torch.device("cuda", rank % cards)


def init_rank(rank: int, world: int, backend: str, device_type: str,
              store_path: str) -> torch.device:
    """Join the world as ``rank`` through the ``FileStore`` at
    ``store_path``; sets and returns the rank's device."""
    dev = rank_device(rank, world, backend, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    return dev


def _entry(rank: int, fn: Callable, world: int, backend: str, device_type: str,
           store_path: str, threads: Optional[int], args: Sequence) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = init_rank(rank, world, backend, device_type, store_path)
    try:
        fn(rank, world, dev, *args)
    except BaseException:
        print(f"rank {rank} of {world} raised:", file=sys.stderr)
        traceback.print_exc()
        sys.stderr.flush()
        raise
    dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str, device_type: str, args: Sequence = (),
          timeout: float = 600.0, threads: Optional[int] = None,
          store_dir: Optional[str] = None) -> None:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned
    processes, each joined to one process group (a ``FileStore`` in
    ``store_dir`` or a fresh temporary directory). ``fn`` must be
    importable by name (a module-level function). Raises when a rank
    raises or when ``timeout`` seconds pass, after stopping every rank."""
    import torch.multiprocessing as mp
    rank_device(0, world, backend, device_type)      # refuse before starting anything
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store_path = str(Path(tmp) / "store")
        ctx = mp.start_processes(_entry, args=(fn, world, backend, device_type, store_path,
                                               threads, tuple(args)),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.time() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.time() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(5)
                if p.is_alive():
                    p.kill()
