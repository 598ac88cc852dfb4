"""The split-KV decode of a dense or sliding-window attention layer over a
sequence-sharded cache: the native-attention counterpart of
``nsa_sharded.nsa_attend_decode_sharded``, for the batched ``decode_32k``
cells across ranks (``nsa_sharded.decode_step_sharded`` dispatches each
layer by ``cfg.attention``).

Each rank holds a contiguous slice of every row's K/V (``cache_specs(
shard_sequence=False)``: the sequence over ``model``) and, for each of its
rows' query heads:

  1. computes the online-softmax state (m, l, acc) over the keys of its
     slice that the token sees: those before position p (its committed
     prefix), and for ``swa`` only those in (p - window, p], a window that
     may straddle the ``model`` boundary (a rank reads only the
     ``min(window, slice)`` rows that can hold its part of it);
  2. adds the new token's own key and value only on the rank that owns
     position p;
  3. merges the states over the group with a MAX of m and one SUM of the
     stacked (l, acc) (``nsa_sharded._merge``): two all-reduces a layer. A
     rank with no key in the window holds m = -inf and l = 0, and still
     joins both.

The owner then writes the new K/V row. The result equals ``model.
decode_step``'s ``attention.attend_verify`` at T = 1 (one softmax over the
prefix and the token) up to the order of the sums. The per-rank compute is
plain PyTorch: the JAX ``decode_step`` runs ``attend_verify`` in plain
``jnp``, no TPU kernel lies on this path.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import nsa_sharded
from repro_torch.models.attention import qkv


@torch.no_grad()
def attend_decode_sharded(params, cfg: ModelConfig, mesh, x, cache_local, prefix_len,
                          seq_axes: Sequence[str], window: int = 0):
    """One-token dense (``window`` 0) or windowed attention + the raw K/V
    commit over a sequence-sharded cache.

    x: (B, 1, D), the same on every rank of the group; ``cache_local``
    {"k", "v"}: this rank's (B, S / n, Hkv, Dh) slice (n the shard count of
    ``seq_axes``); ``prefix_len`` an int or a 0-d / (B,) tensor, the same on
    every rank. Returns (out (B, 1, D), cache_local with the new row written
    in place on the rank that owns position ``prefix_len``)."""
    group, idx, _ = nsa_sharded.shard_of(mesh, seq_axes)
    B, dev = x.shape[0], x.device
    Hq, Hkv, G, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    k_c, v_c = cache_local["k"], cache_local["v"]
    S_loc = k_c.shape[1]
    off = idx * S_loc
    pos = torch.as_tensor(prefix_len, device=dev).to(torch.int32).reshape(-1).expand(B)
    p = pos.long()
    q, k_new, v_new = qkv(params, cfg, x, pos[:, None])
    qg = q.reshape(B, Hkv, G, Dh).float()
    scale = 1.0 / math.sqrt(Dh)
    if window > 0:
        W = min(window, S_loc)
        wstart = (p - window + 1).clamp(min=0)                           # (B,)
        rows = (wstart - off).clamp(0, S_loc - W)[:, None] + torch.arange(W, device=dev)
        brow = torch.arange(B, device=dev)[:, None]
        k_s, v_s = k_c[brow, rows], v_c[brow, rows]                      # (B, W, Hkv, Dh)
        kpos = off + rows
        seen = (kpos < p[:, None]) & (kpos >= wstart[:, None])
    else:
        k_s, v_s = k_c, v_c
        seen = (off + torch.arange(S_loc, device=dev))[None] < p[:, None]  # (B, S_loc)
    own = (p >= off) & (p < off + S_loc)                                  # (B,)
    logits = torch.cat([torch.einsum("bhgd,bkhd->bhgk", qg, k_s.float()),
                        torch.einsum("bhgd,bkhd->bhgk", qg, k_new.float())], dim=-1) * scale
    m, pr = nsa_sharded._state(logits, torch.cat([seen, own[:, None]], -1)[:, None, None])
    K = k_s.shape[1]
    acc = torch.einsum("bhgk,bkhd->bhgd", pr[..., :K], v_s.float()) + \
        torch.einsum("bhgk,bkhd->bhgd", pr[..., K:], v_new.float())
    o = nsa_sharded._merge(m, pr.sum(-1), acc, group).to(x.dtype)
    out = o.reshape(B, 1, Hq * Dh) @ params["wo"]
    wr = (p - off).clamp(0, S_loc - 1)
    b = torch.arange(B, device=dev)
    keep = own[:, None, None]
    k_c[b, wr] = torch.where(keep, k_new[:, 0].to(k_c.dtype), k_c[b, wr])
    v_c[b, wr] = torch.where(keep, v_new[:, 0].to(v_c.dtype), v_c[b, wr])
    return out, cache_local
