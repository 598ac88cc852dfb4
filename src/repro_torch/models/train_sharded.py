"""The train step's sequence mixers on a rank's positions: the
differentiable counterpart of ``prefill_sharded._attention_layer``, without
caches. ``model.block_apply_train`` runs them when ``runtime.sharded``
splits each row's positions over ``model`` (``split``: a
``runtime.sharded.SeqSplit``; the rank holds positions ``[a, b)`` of an
S-position stream).

  * **Attention.** q, k and v of the rank's chunk; k and v all-gathered
    over ``model`` together, in one ``split.gather`` (its backward pass
    reduce-scatters their gradient). NSA builds every compressed block from
    the gathered K/V (``nsa.compress_kv``) and attends for its own queries
    on the single device's query chunks (``nsa.attend_queries(q0=a)``);
    dense and sliding-window layers run ``attention.attend_queries`` over
    the keys up to b (a window may reach into earlier ranks' chunks). Then
    ``wo``.
  * **A recurrent mixer** (RG-LRU, mLSTM, sLSTM) runs on the whole normed
    stream (``split.gather``) and keeps the chunk's rows, so its work
    repeats along ``model``: the state carries of ``recurrent_sharded``
    have no backward pass yet.

Nothing here computes what the single-device layer does not: each rank
computes the single device's layer output at its own positions. The
compressed blocks are rebuilt on every rank from the whole K/V but enter
only that rank's queries' outputs, so the gradient a rank sends back
through them (to the K/V and to ``w_cmp_k`` / ``w_cmp_v``) is its queries'
share, and the sums over ``model`` (``SeqGather``'s backward pass, the
weights' ``reduce_grad``) add every share once. The Top-n indices carry no
gradient, as in both packages.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention, nsa, recurrent


def attention_mix(params, cfg: ModelConfig, h, positions, split, chunk: int = 512):
    """h (B, b - a, d) normed chunk, positions (B, b - a) -> the attention
    output at the chunk's positions (B, b - a, d)."""
    Dh = cfg.head_dim
    q, k, v = attention.qkv(params, cfg, h, positions)
    kv = split.gather(torch.cat([k, v], dim=-1))                  # (B, S, Hkv, 2 Dh)
    k, v = kv[..., :Dh], kv[..., Dh:]
    if cfg.attention == "nsa":
        k_cmp, v_cmp = nsa.compress_kv(params, k, v, cfg.nsa)
        heads = nsa.attend_queries(cfg, q, nsa.gates(params, h, cfg.num_heads), positions,
                                   k, v, k_cmp, v_cmp, q0=split.a, chunk=chunk)
    else:
        window = cfg.window if cfg.attention == "swa" else 0
        heads = attention.attend_queries(cfg, q, k[:, :split.b], v[:, :split.b], split.a,
                                         window, chunk)
    return heads @ params["wo"]


def recurrent_mix(params, cfg: ModelConfig, kind: str, h, split):
    """A recurrent mixer's output at the chunk's positions, from the whole
    normed stream."""
    return recurrent.TRAIN[kind](params, cfg, split.gather(h))[:, split.a:split.b]
