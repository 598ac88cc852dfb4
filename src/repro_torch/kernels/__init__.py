"""Hand-written Hopper kernels of the served verify paths, each beside its
plain PyTorch version, each built for head dim 64 and 128:

nsa_verify — fused grouped-query NSA verification (full fusion on reuse
             layers, partial fusion with the routing output on refresh
             layers; exact merged-schedule and approximate shared-index
             grouping), and its branch-wise vanilla mode (one ungated
             branch per launch, the paper's Fig. 6(a) baseline);
routing    — the refresh-layer routing launch: compressed-branch attention
             and selection-block scores in one pass;
flash      — dense tree verification (the dense draft's verify passes and
             the dense-verification target).

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs the plain version. Sources live in ``repro_torch/csrc``
and are built by ``kernels.build``.
"""
from typing import Dict, List

import torch


class LaunchCounter:
    """Counts a kernel's launches; the wrapper adds one where it launches
    the kernel and nowhere else, so a run can show that its main path went
    through the kernel.

    A CUDA graph replays its launches without calling the wrappers, so the
    engine that captures one takes the counts its capture added
    (``snapshot`` before, ``since`` after), restores them (a capture
    launches nothing) and adds them again on every replay (``add_counts``).
    """

    registry: List["LaunchCounter"] = []

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        LaunchCounter.registry.append(self)

    def add(self, n: int = 1) -> None:
        self.count += n

    def reset(self) -> None:
        self.count = 0

    @classmethod
    def snapshot(cls) -> Dict["LaunchCounter", int]:
        return {c: c.count for c in cls.registry}

    @classmethod
    def since(cls, snap: Dict["LaunchCounter", int]) -> Dict["LaunchCounter", int]:
        """Counts added since ``snap`` (counters made later count from 0)."""
        return {c: c.count - snap.get(c, 0) for c in cls.registry
                if c.count != snap.get(c, 0)}

    @classmethod
    def restore(cls, snap: Dict["LaunchCounter", int]) -> None:
        for c in cls.registry:
            c.count = snap.get(c, 0)

    @staticmethod
    def add_counts(counts: Dict["LaunchCounter", int]) -> None:
        for c, n in counts.items():
            c.add(n)


def per_row(x, B: int, device) -> torch.Tensor:
    """An int or a 0-d / (B,) tensor -> a contiguous (B,) int32 tensor.
    A device tensor stays on the device (no host sync)."""
    t = torch.as_tensor(x, device=device).to(torch.int32).reshape(-1)
    return t.expand(B).contiguous()
