"""Weights for the port: bridged from the JAX package, or drawn from a seed.

``from_jax`` turns the JAX ``model.init`` pytree — converted to numpy
arrays by the caller, e.g. ``jax.tree.map(np.asarray, params)`` — into the
port's parameter dict. The JAX package stacks each segment's blocks along a
leading axis (``repro.models.model.segments``); the port keeps one block
dict per layer, so the bridge unstacks in layer order.

``init_params`` draws the same distributions as the JAX ``model.init``
(not the same numbers: the generators differ), so a machine without JAX
can build a full-width model from a seed.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models.model import check_supported, segments


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")    # writable, owned by the tensor
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 from JAX
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax(np_params: Dict[str, Any], cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """JAX params pytree (numpy leaves) -> port params on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    out = {k: _map(np_params[k], lambda a: _tensor(a, dev))
           for k in ("embed", "lm_head", "final_norm")}
    blocks = []
    for (kinds, n), stacked in zip(segments(cfg), np_params["segments"]):
        for i in range(n):
            for j in range(len(kinds)):
                blocks.append(_map(stacked[j], lambda a, i=i: _tensor(np.asarray(a)[i], dev)))
    if len(blocks) != cfg.num_layers:
        raise ValueError(f"bridged {len(blocks)} blocks for {cfg.num_layers} layers")
    out["layers"] = blocks
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters with the JAX ``model.init`` distributions, drawn
    from ``generator`` (which must live on ``device``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * scale

    def linear(d_in, d_out):
        return (normal(d_in, d_out) / math.sqrt(d_in)).to(dtype)

    def ones(n):
        return {"scale": torch.ones((n,), dtype=dtype, device=dev)}

    params: Dict[str, Any] = {
        "embed": {"table": normal(cfg.vocab_size, d, scale=0.02).to(dtype)},
        "lm_head": {"w": (normal(d, cfg.vocab_size) / math.sqrt(d)).to(dtype)},
        "final_norm": ones(d),
    }
    layers = []
    for _ in range(cfg.num_layers):
        mix = {"wq": linear(d, hq * hd), "wk": linear(d, hkv * hd),
               "wv": linear(d, hkv * hd), "wo": linear(hq * hd, d)}
        if cfg.qk_norm:
            mix["q_norm"], mix["k_norm"] = ones(hd), ones(hd)
        if cfg.attention == "nsa":
            eye = torch.eye(hd, device=dev)
            mix["phi_k"] = torch.zeros((cfg.nsa.cmp_block,), device=dev)
            mix["phi_v"] = torch.zeros((cfg.nsa.cmp_block,), device=dev)
            mix["w_cmp_k"] = (eye + normal(hd, hd, scale=0.02)).to(dtype)
            mix["w_cmp_v"] = (eye + normal(hd, hd, scale=0.02)).to(dtype)
            mix["w_gate"] = normal(d, 3 * hq, scale=0.01).to(dtype)
            mix["b_gate"] = torch.zeros((3 * hq,), device=dev)
        layers.append({"norm1": ones(d), "norm2": ones(d), "mix": mix,
                       "ffn": {"w_gate": linear(d, cfg.d_ff), "w_up": linear(d, cfg.d_ff),
                               "w_down": linear(cfg.d_ff, d)}})
    params["layers"] = layers
    return params
