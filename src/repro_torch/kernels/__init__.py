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
import torch


class LaunchCounter:
    """Counts a kernel's launches; the wrapper adds one where it launches
    the kernel and nowhere else, so a run can show that its main path went
    through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def per_row(x, B: int, device) -> torch.Tensor:
    """An int or a 0-d / (B,) tensor -> a contiguous (B,) int32 tensor.
    A device tensor stays on the device (no host sync)."""
    t = torch.as_tensor(x, device=device).to(torch.int32).reshape(-1)
    return t.expand(B).contiguous()
