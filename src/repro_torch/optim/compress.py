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
``torch.rand`` from a ``torch.Generator`` seeded with ``noise_seed(i, s)``,
so a run is reproducible; ``_quantize`` takes the noise as an argument,
which lets a test feed in the JAX noise.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def _quantize(x, noise, amax=None):
    """x any float tensor, noise U[0, 1) float32 of x's shape ->
    (int8 q, f32 scale) with q = clip(round(x / scale + noise - 0.5)) and
    scale = max |x| / 127 (``amax`` in place of max |x| when x is a block
    of a larger leaf)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max() if amax is None else amax, min=1e-12) / 127.0
    y = xf / scale
    q = torch.clamp(torch.round(y + (noise - 0.5)), -127, 127).to(torch.int8)
    return q, scale


_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """SplitMix64's finaliser: a bijection of 64-bit integers whose every
    output bit depends on every input bit."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def noise_seed(index: int, step: int) -> int:
    """The generator seed of leaf ``index`` at ``step``: (index, step) mixed
    through a 64-bit hash and folded to 63 bits. The CPU generator keeps a
    seed's low 32 bits only and CUDA's Philox all 64, so the seed spreads
    (index, step) over the low bits as well as the high ones: distinct
    pairs draw distinct noise on either device."""
    h = _mix64(_mix64(index & _MASK64) ^ (step & _MASK64))
    return (h ^ (h >> 63)) & ((1 << 63) - 1)


def noise_for(leaf: torch.Tensor, index: int, step: int, shape=None) -> torch.Tensor:
    """Leaf ``index``'s rounding noise at ``step`` on the leaf's device, of
    the leaf's shape or of ``shape`` (a whole leaf, of which ``leaf`` is a
    block)."""
    gen = torch.Generator(device=leaf.device)
    gen.manual_seed(noise_seed(index, step))
    return torch.rand(leaf.shape if shape is None else shape, generator=gen,
                      device=leaf.device)


@torch.no_grad()
def compress_pytree(grads, residual, step: int, blocks=None):
    """-> ((int8 tree, scale tree), new residual).

    ``blocks`` (``runtime.sharded.LeafBlocks``) when the leaves are this
    rank's blocks of whole leaves: ``blocks.amax`` turns the blocks' max
    |x| into the whole leaves' (a MAX over the ranks) and ``blocks.noise``
    cuts this block of the whole leaf's noise, so a block quantizes as the
    same block of the whole leaf does."""
    gl, rl = tree_leaves(grads), tree_leaves(residual)
    amax = None if blocks is None else \
        blocks.amax([(g.float() + r).abs().max() for g, r in zip(gl, rl)])
    qs, scales, new_res = [], [], []
    for i, (g, r) in enumerate(zip(gl, rl)):
        corrected = g.float() + r
        if blocks is None:
            q, s = _quantize(corrected, noise_for(corrected, i, step))
        else:
            q, s = _quantize(corrected, blocks.noise(corrected, i, step), amax[i])
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
