"""Hand-written Hopper kernels of the served NSA verify path, each beside
its plain PyTorch version:

nsa_verify — fused grouped-query NSA verification (full fusion on reuse
             layers, partial fusion with the routing output on refresh
             layers; exact merged-schedule and approximate shared-index
             grouping);
routing    — the refresh-layer routing launch: compressed-branch attention
             and selection-block scores in one pass.

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs the plain version. Sources live in ``repro_torch/csrc``
and are built by ``kernels.build``.
"""


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
