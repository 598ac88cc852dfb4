"""Core layer primitives: RMSNorm, rotary embeddings, activations, the
gated and non-gated FFN, embedding (tied or separate unembedding) and LM
head — the PyTorch counterparts of ``repro.models.layers``.

Parameters are plain dicts of tensors with the JAX package's names and
layouts (``x @ w`` with ``w`` of shape (d_in, d_out)), so weights bridge
one to one (``repro_torch.bridge``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(params, x, eps: float = 1e-6):
    """Computed in float32, then cast back to the input dtype."""
    orig = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * params["scale"].float()).to(orig)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a Python-scalar base: no host-to-device copy, so a CUDA graph can
    # capture the step that calls this (theta is rounded to float32 as before)
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    Split-halves rotation (not interleaved), as the JAX package does."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., seq, half)
    angles = angles[..., None, :]                          # (..., seq, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def squared_relu(x):
    return torch.square(F.relu(x))


ACTIVATIONS = {
    "gelu": gelu,
    "relu": F.relu,
    "silu": F.silu,
    "squared_relu": squared_relu,
}

GATED = {"swiglu": F.silu, "geglu": gelu, "reglu": F.relu}


def ffn(params, x, activation: str):
    if activation in GATED:
        h = GATED[activation](x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = ACTIVATIONS[activation](x @ params["w_up"])
    return h @ params["w_down"]


def embed(params, tokens):
    return params["table"][tokens]


def unembed(params, x):
    """x: (..., d) -> logits (..., V) through the (tied) embedding table."""
    return x @ params["table"].T


def lm_head(params, x):
    return x @ params["w"]
