"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no explicit CPU request they raise: a serving run never drifts to
the CPU on its own. The ``meta`` device (shapes and dtypes, no storage) is
accepted only where a caller asks for shapes (``shapes_only=True``: the
parameter tree that ``launch.specs`` reckons bytes from); nothing runs a
model on it.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   shapes_only: bool = False) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type == "meta" and shapes_only:
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic garbage collector off for the block. Wraps each CUDA
    graph capture: a collection inside it could free another graph held in
    a dead reference cycle (a finished engine's group steps), which the
    CUDA refuses while a stream captures, and the capture fails."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
