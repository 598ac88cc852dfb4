"""Weights for the port: bridged from the JAX package, or drawn from a seed.

``from_jax`` turns the JAX ``model.init`` pytree — converted to numpy
arrays by the caller, e.g. ``jax.tree.map(np.asarray, params)`` — into the
port's parameter dict. The JAX package stacks each segment's blocks along a
leading axis (``repro.models.model.segments``); the port keeps one block
dict per layer, so the bridge unstacks in layer order.

``to_jax`` is its inverse: it re-stacks ``params["layers"]`` into the JAX
``segments`` layout with numpy leaves. The checkpoint writer stores that
layout (``restack`` keeps tensor leaves), so a checkpoint written by either
package loads in the other.

``init_params`` draws the same distributions as the JAX ``model.init``
(not the same numbers: the generators differ), so a machine without JAX
can build a full-width model from a seed. On ``device="meta"`` (a CPU
generator) it builds the tree's shapes and dtypes only, the counterpart of
``jax.eval_shape(model.init)``. Every leaf keeps its JAX dtype:
the recurrent blocks' ``lam``, ``wi``, ``wf``, ``bf``, ``w_h`` and ``b``
are float32 in a bf16 model, as there.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models.layers import GATED
from repro_torch.models.model import RECURRENT_KINDS, check_supported, segments
from repro_torch.models.recurrent import RGLRU_C, mlstm_heads, rglru_dims
from repro_torch.optim.adamw import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")    # writable, owned by the tensor
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 from JAX
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 becomes ``ml_dtypes.bfloat16``,
    the dtype ``np.asarray`` gives a JAX bf16 array (bit for bit)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                       # only bf16 needs it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_jax(np_params: Dict[str, Any], cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """JAX params pytree (numpy leaves) -> port params on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    out = {k: tree_map(lambda a: _tensor(a, dev), v) for k, v in np_params.items()
           if k != "segments"}
    blocks = []
    for (kinds, n), stacked in zip(segments(cfg), np_params["segments"]):
        for i in range(n):
            for j in range(len(kinds)):
                blocks.append(tree_map(lambda a, i=i: _tensor(np.asarray(a)[i], dev), stacked[j]))
    if len(blocks) != cfg.num_layers:
        raise ValueError(f"bridged {len(blocks)} blocks for {cfg.num_layers} layers")
    out["layers"] = blocks
    return out


def restack(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Port params (or any tree of that structure, e.g. AdamW moments) ->
    the JAX layout, leaves stacked per segment position with
    ``torch.stack`` (same dtype and device)."""
    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"{len(params['layers'])} blocks for {cfg.num_layers} layers")
    out = {k: v for k, v in params.items() if k != "layers"}
    segs, base = [], 0
    for kinds, n in segments(cfg):
        m = len(kinds)
        group = []
        for j in range(m):
            blocks = [params["layers"][base + i * m + j] for i in range(n)]
            group.append(_stack(blocks))
        segs.append(tuple(group))
        base += n * m
    out["segments"] = segs
    return out


def _stack(blocks):
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    return torch.stack(blocks)


def to_jax(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Port params -> the JAX ``model.init`` pytree with numpy leaves (the
    inverse of ``from_jax``): ``from_jax(to_jax(p, cfg), cfg)`` equals
    ``p`` bitwise, bf16 included."""
    check_supported(cfg)
    return tree_map(_numpy, restack(params, cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random parameters with the JAX ``model.init`` distributions (the MoE
    leaves with ``moe_init``'s, the router in float32 as there; the
    recurrent blocks with those of the JAX ``recurrent.INITS``), drawn from
    ``generator`` (which must live on ``device``; a CPU generator for
    ``device="meta"``, which gives shapes and dtypes without storage)."""
    check_supported(cfg)
    dev = resolve_device(device, shapes_only=True)
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

    def ffn(d_ff):                  # drawn in this order (the seeds' numbers)
        if cfg.activation not in GATED:
            return {"w_up": linear(d, d_ff), "w_down": linear(d_ff, d)}
        return {"w_gate": linear(d, d_ff), "w_up": linear(d, d_ff), "w_down": linear(d_ff, d)}

    def moe():
        m = cfg.moe
        E, dff = m.num_experts, m.d_expert or cfg.d_ff
        p = {"router": normal(d, E, scale=0.02),
             "w_up": normal(E, d, dff, scale=1 / math.sqrt(d)).to(dtype),
             "w_down": normal(E, dff, d, scale=1 / math.sqrt(dff)).to(dtype)}
        if cfg.activation in GATED:
            p["w_gate"] = normal(E, d, dff, scale=1 / math.sqrt(d)).to(dtype)
        if m.num_shared_experts:
            p["shared"] = ffn(cfg.d_ff)
        return p

    params: Dict[str, Any] = {
        "embed": {"table": normal(cfg.vocab_size, d, scale=0.02).to(dtype)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": (normal(d, cfg.vocab_size) / math.sqrt(d)).to(dtype)}
    params["final_norm"] = ones(d)
    if cfg.modality != "text" and cfg.frontend_dim:
        params["frontend_proj"] = {"w": linear(cfg.frontend_dim, d)}

    def rglru():
        sd, cw = rglru_dims(cfg)
        # a = sigmoid(lam)^c in (0.9, 0.999) (Griffin appendix)
        u = torch.rand((sd,), generator=generator, device=dev) * (0.999 - 0.9) + 0.9
        r = u ** (1.0 / RGLRU_C)
        return {"w_in": linear(d, sd), "w_gate_branch": linear(d, sd),
                "conv": normal(cw, sd, scale=0.02).to(dtype),
                "w_a": linear(sd, sd), "w_x": linear(sd, sd),
                "lam": torch.log(r / (1 - r)), "w_out": linear(sd, d)}

    def mlstm():
        H = mlstm_heads(cfg)
        return {"wq": linear(d, d), "wk": linear(d, d), "wv": linear(d, d),
                "wi": normal(d, H, scale=0.02), "wf": normal(d, H, scale=0.02),
                "bf": torch.full((H,), 3.0, device=dev),   # remember by default
                "wo_gate": linear(d, d), "w_out": linear(d, d)}

    def slstm():
        return {"w_x": linear(d, 4 * d), "w_h": normal(d, 4 * d, scale=0.02),
                "b": torch.cat([torch.zeros((2 * d,), device=dev),
                                torch.full((d,), 3.0, device=dev),
                                torch.zeros((d,), device=dev)]),
                "w_out": linear(d, d)}

    recurrent_mix = {"rglru": rglru, "mlstm": mlstm, "slstm": slstm}
    layers = []
    for kind in cfg.layer_kinds():
        if kind in RECURRENT_KINDS:
            block = {"norm1": ones(d), "norm2": ones(d), "mix": recurrent_mix[kind]()}
            if cfg.d_ff:
                block["ffn"] = ffn(cfg.d_ff)
            layers.append(block)
            continue
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
                       "ffn": moe() if kind == "moe" else ffn(cfg.d_ff)})
    params["layers"] = layers
    return params
