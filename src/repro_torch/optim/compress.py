"""Gradient compression: int8 quantization with per-tensor scales,
stochastic rounding from an explicit generator, and error feedback — the
PyTorch counterpart of ``repro.optim.compress``.

Quantizing to int8 cuts the wire bytes of a cross-host gradient reduction
2x against bf16 / 4x against f32; the residual carried in the train state
keeps the scheme convergent (Karimireddy et al., 2019). On one card no
reduction crosses a wire, so here it simulates the quantization error only.

A leaf is one tensor of the port's tree (one layer's weight), where the
JAX package quantizes each stacked segment leaf (all layers of one weight)
under one scale. The rounding noise of leaf ``i`` at step ``s`` is
``torch.rand`` from a ``torch.Generator`` seeded with ``(i, s)``, so a run
is reproducible; ``_quantize`` takes the noise as an argument, which lets
a test feed in the JAX noise.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def _quantize(x, noise):
    """x any float tensor, noise U[0, 1) float32 of x's shape ->
    (int8 q, f32 scale) with q = clip(round(x / scale + noise - 0.5))."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    y = xf / scale
    q = torch.clamp(torch.round(y + (noise - 0.5)), -127, 127).to(torch.int8)
    return q, scale


def noise_for(leaf: torch.Tensor, index: int, step: int) -> torch.Tensor:
    gen = torch.Generator(device=leaf.device)
    gen.manual_seed((index << 32) + step)
    return torch.rand(leaf.shape, generator=gen, device=leaf.device)


@torch.no_grad()
def compress_pytree(grads, residual, step: int):
    """-> ((int8 tree, scale tree), new residual)."""
    qs, scales, new_res = [], [], []
    for i, (g, r) in enumerate(zip(tree_leaves(grads), tree_leaves(residual))):
        corrected = g.float() + r
        q, s = _quantize(corrected, noise_for(corrected, i, step))
        qs.append(q)
        scales.append(s)
        new_res.append(corrected - q.float() * s)
    return ((tree_unflatten(grads, qs), tree_unflatten(grads, scales)),
            tree_unflatten(grads, new_res))


def decompress_pytree(quantized):
    qs, scales = quantized
    return tree_map(lambda q, s: q.float() * s, qs, scales)


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
