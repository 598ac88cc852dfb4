"""Dense GQA attention: train/prefill (chunked causal) and the tree-masked
speculative verification the dense draft runs — the PyTorch counterparts of
``repro.models.attention``.

Shapes convention:
  x:        (B, S, D)
  q:        (B, S, Hq, Dh)
  k, v:     (B, S, Hkv, Dh)
  caches:   {"k": (B, S_max, Hkv, Dh), "v": ...}   (positions < length valid)

GQA is computed by reshaping q to (B, S, Hkv, G, Dh) where G = Hq // Hkv.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import kvstore
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models import layers

NEG_INF = -1e30


def qkv(params, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, scale):
    """q: (B, Sq, Hkv, G, Dh); k/v: (B, Skv, Hkv, Dh); mask (B|1, Sq, Skv).
    Returns (B, Sq, Hkv, G, Dh) in q's dtype."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.to(q.dtype)


def causal_mask(sq: int, skv: int, device, q_offset: int = 0, window: int = 0):
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None]                                          # (1, Sq, Skv)


def attend_train(params, cfg: ModelConfig, x, positions, window: int = 0,
                 chunk: int = 0):
    """Full-sequence causal attention (optionally sliding-window), chunked
    over queries when ``chunk`` divides S so the score working set stays
    bounded. Returns (out (B,S,D), (k, v))."""
    B, S, _ = x.shape
    G = cfg.q_per_kv
    q, k, v = qkv(params, cfg, x, positions)
    qg = q.reshape(B, S, cfg.num_kv_heads, G, cfg.head_dim)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if chunk and S % chunk == 0 and S > chunk:
        outs = []
        for i in range(S // chunk):
            m = causal_mask(chunk, S, x.device, q_offset=i * chunk, window=window)
            outs.append(_sdpa(qg[:, i * chunk:(i + 1) * chunk], k, v, m, scale))
        out = torch.cat(outs, dim=1)
    else:
        out = _sdpa(qg, k, v, causal_mask(S, S, x.device, window=window), scale)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], (k, v)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device,
               store: kvstore.KVStoreConfig = kvstore.DENSE):
    """Zeroed K/V: (batch, max_len, Hkv, Dh) rows, or under the paged store
    the shared page pool (num_pages, page_size, Hkv, Dh)."""
    return kvstore.init_kv(cfg, batch, max_len, dtype, device, store)


def write_cache(cache, k_new, v_new, start):
    """Insert (B, T, Hkv, Dh) at ``start`` (an int or a 0-d device tensor),
    in place, through the dense ``KVView``. Unlike
    ``jax.lax.dynamic_update_slice`` nothing is clamped: the caller keeps
    ``start + T <= S`` (the engine's headroom), and an int start that breaks
    it raises."""
    kvstore.as_view(cache).write(k_new, v_new, start)
    return cache


def attend_verify(params, cfg: ModelConfig, x, cache, prefix_len, positions,
                  tree_mask, window: int = 0):
    """Tree-masked verification over T draft tokens (the dense draft's
    verify passes and the dense-verification target): ``qkv``, then the
    flash tree-verify kernel on ``q / sqrt(Dh)`` (``kernels.flash.ops``;
    plain version for CPU tensors), then ``wo``.

    x: (B, T, D); positions (B, T) absolute; tree_mask (B, T, T) bool;
    prefix_len an int or 0-d/(B,) device tensor. ``cache`` is a raw
    ``{"k", "v"}`` dict or a ``kvstore.KVView``; a paged view is
    materialized into its logical (B, max_len, Hkv, Dh) K/V first
    (``KVView.full``), as the JAX ``attend_verify`` does. The draft K/V are
    appended only for this pass; the cache is unchanged on return.

    The flash masks add ``kpos <= position`` to the prefix mask and
    ``pos_i >= pos_j`` to the draft mask, which the JAX ``attend_verify``
    does not have. They agree on every tree the engine builds (positions =
    prefix + depth, the mask holds ancestors), not on arbitrary inputs: a
    position below ``prefix_len`` or a mask entry to a deeper node gives
    another result here.
    """
    cache_k, cache_v = kvstore.as_view(cache).full()
    B, T, _ = x.shape
    q, k_new, v_new = qkv(params, cfg, x, positions)
    q_s = (q.float() / math.sqrt(cfg.head_dim)).contiguous()
    out = flash_ops.flash_verify(q_s, cache_k, cache_v, k_new, v_new, positions,
                                 prefix_len, tree_mask, window)
    out = out.to(x.dtype).reshape(B, T, cfg.num_heads * cfg.head_dim) @ params["wo"]
    return out, (k_new, v_new)
