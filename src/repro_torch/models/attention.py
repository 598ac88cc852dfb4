"""Dense GQA attention: train/prefill (chunked causal, online softmax, and
flash with its own backward) and the tree-masked speculative verification
the dense draft runs — the PyTorch counterparts of
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
from torch.utils.checkpoint import checkpoint

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


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    autograd records (``jax.checkpoint``'s role in the JAX package)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def attend_train(params, cfg: ModelConfig, x, positions, window: int = 0,
                 chunk: int = 0, remat_chunks: bool = False):
    """Full-sequence causal attention (optionally sliding-window), chunked
    over queries when ``chunk`` divides S so the score working set stays
    bounded; ``remat_chunks`` recomputes each chunk in the backward pass
    instead of keeping its probabilities. Returns (out (B,S,D), (k, v))."""
    B, S, _ = x.shape
    G = cfg.q_per_kv
    q, k, v = qkv(params, cfg, x, positions)
    qg = q.reshape(B, S, cfg.num_kv_heads, G, cfg.head_dim)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if chunk and S % chunk == 0 and S > chunk:
        def body(i, qc, k, v):
            m = causal_mask(chunk, S, x.device, q_offset=i * chunk, window=window)
            return _sdpa(qc, k, v, m, scale)

        outs = []
        for i in range(S // chunk):
            qc = qg[:, i * chunk:(i + 1) * chunk]
            outs.append(remat(body, i, qc, k, v) if remat_chunks else body(i, qc, k, v))
        out = torch.cat(outs, dim=1)
    else:
        out = _sdpa(qg, k, v, causal_mask(S, S, x.device, window=window), scale)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], (k, v)


def query_runs(q0: int, q1: int, chunk: int = 512):
    """The (start, stop) runs ``attend_queries`` takes for global query
    positions ``[q0, q1)``: the pieces of the ``chunk``-query chunks on
    their global boundaries (the last one shorter where ``chunk`` does not
    divide the length) that lie in the range."""
    if not chunk:
        return [(q0, q1)] if q1 > q0 else []
    return [(max(q0, a), min(q1, a + chunk)) for a in range(q0 - q0 % chunk, q1, chunk)]


def attend_queries(cfg: ModelConfig, q, k, v, q0: int = 0, window: int = 0,
                   chunk: int = 512):
    """Causal (optionally sliding-window) attention of the queries at
    global positions ``[q0, q0 + Tq)`` over a sequence's keys: q (B, Tq, Hq,
    Dh) after RoPE; k, v (B, S, Hkv, Dh) whole (at least to the last query).
    The queries run in ``query_runs``' pieces, each over the keys it can
    see (those before a run's first window start, and after its last query,
    are left out: their probabilities are 0), so the score tensors stay
    (chunk, keys) whatever S is, and a slice of the queries gives the same
    rows as the whole range. Up to rounding, the whole range (q0 = 0, Tq =
    S) is ``attend_train``'s result. Returns the heads (B, Tq, Hq * Dh) in
    q's dtype, before the output projection. The prefill's dense and
    windowed layers run it (``model.prefill``: the reference's
    ``attend_train`` builds the whole (S, S) scores when ``chunk`` does not
    divide S), one card or across ranks (``models.prefill_sharded``)."""
    B, Tq = q.shape[0], q.shape[1]
    Hkv, G, Dh = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    qg = q.reshape(B, Tq, Hkv, G, Dh)
    scale = 1.0 / math.sqrt(Dh)
    outs = []
    for a, b in query_runs(q0, q0 + Tq, chunk):
        lo = max(0, a - window + 1) if window > 0 else 0
        m = causal_mask(b - a, b - lo, q.device, q_offset=a - lo, window=window)
        outs.append(_sdpa(qg[:, a - q0:b - q0], k[:, lo:b], v[:, lo:b], m, scale))
    return torch.cat(outs, dim=1).reshape(B, Tq, cfg.num_heads * Dh)


def _tile_mask(qi: int, qc: int, ki: int, kc: int, window: int, device):
    """(qc, kc) visibility of key tile ki to query tile qi (causal, window)."""
    qpos = qi * qc + torch.arange(qc, device=device)
    kpos = ki * kc + torch.arange(kc, device=device)
    m = kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _tile_visible(qi: int, qc: int, ki: int, kc: int, window: int) -> bool:
    """Whether any key of tile ki is visible to a query of tile qi. A tile
    with none leaves the online softmax's (m, l, acc) and every gradient as
    they were, so the loops skip it (the JAX scans visit it, masked)."""
    if ki * kc > qi * qc + qc - 1:
        return False
    return window <= 0 or ki * kc + kc - 1 > qi * qc - window


def _chunk_size(S: int, chunk: int) -> int:
    c = min(chunk, S)
    while S % c:
        c //= 2
    return c


def attend_train_online(params, cfg: ModelConfig, x, positions, window: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 512):
    """Flash-style attention in plain PyTorch: an online softmax over KV
    tiles, so the (Sq, Skv) score matrix is never built; each KV tile's
    step is recomputed in the backward pass (the JAX inner checkpoint).
    Semantics identical to ``attend_train`` (causal + optional window)."""
    B, S, _ = x.shape
    Hkv, G, Dh = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    q, k, v = qkv(params, cfg, x, positions)
    scale = 1.0 / math.sqrt(Dh)
    qc, kc = _chunk_size(S, q_chunk), _chunk_size(S, kv_chunk)
    qg = q.reshape(B, S, Hkv, G, Dh)

    def kv_step(m, l, acc, qx, kx, vx, mask):
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qx, kx.float()) * scale
        logits = torch.where(mask, logits, torch.full((), NEG_INF, device=x.device))
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None]) * mask
        l_new = l * alpha + p.sum(-1)
        acc_new = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vx.float())
        return m_new, l_new, acc_new

    outs = []
    for qi in range(S // qc):
        qx = qg[:, qi * qc:(qi + 1) * qc].float()
        m = torch.full((B, Hkv, G, qc), NEG_INF, device=x.device)
        l = torch.zeros((B, Hkv, G, qc), device=x.device)
        acc = torch.zeros((B, Hkv, G, qc, Dh), device=x.device)
        for ki in range(S // kc):
            if not _tile_visible(qi, qc, ki, kc, window):
                continue
            mask = _tile_mask(qi, qc, ki, kc, window, x.device)
            m, l, acc = remat(kv_step, m, l, acc, qx, k[:, ki * kc:(ki + 1) * kc],
                               v[:, ki * kc:(ki + 1) * kc], mask)
        o = torch.where(l[..., None] > 0, acc / torch.clamp(l, min=1e-30)[..., None],
                        torch.zeros((), device=x.device))
        outs.append(o.permute(0, 3, 1, 2, 4))                # (B, qc, Hkv, G, Dh)
    out = torch.cat(outs, dim=1).reshape(B, S, cfg.num_heads * Dh)
    return out.to(x.dtype) @ params["wo"], (k, v)


def _flash_fwd_impl(q, k, v, scale: float, window: int, c: int):
    """q (B,S,Hkv,G,Dh) f32; k/v (B,S,Hkv,Dh) f32 -> (o, lse (B,Hkv,G,S))."""
    B, S, Hkv, G, Dh = q.shape
    n = S // c
    dev = q.device
    o = torch.empty_like(q)
    lse = torch.empty((B, Hkv, G, S), device=dev)
    for qi in range(n):
        qx = q[:, qi * c:(qi + 1) * c]
        m = torch.full((B, Hkv, G, c), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, c), device=dev)
        acc = torch.zeros((B, Hkv, G, c, Dh), device=dev)
        for ki in range(n):
            if not _tile_visible(qi, c, ki, c, window):
                continue
            mask = _tile_mask(qi, c, ki, c, window, dev)
            lg = torch.einsum("bqhgd,bkhd->bhgqk", qx, k[:, ki * c:(ki + 1) * c]) * scale
            lg = torch.where(mask, lg, torch.full((), NEG_INF, device=dev))
            m_new = torch.maximum(m, lg.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(lg - m_new[..., None]) * mask
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                        v[:, ki * c:(ki + 1) * c])
            m = m_new
        ob = torch.where(l[..., None] > 0, acc / torch.clamp(l, min=1e-30)[..., None],
                         torch.zeros((), device=dev))
        o[:, qi * c:(qi + 1) * c] = ob.permute(0, 3, 1, 2, 4)
        lse[..., qi * c:(qi + 1) * c] = m + torch.log(torch.clamp(l, min=1e-30))
    return o, lse


def _flash_bwd(q, k, v, o, lse, do, scale: float, window: int, c: int):
    """FlashAttention-style backward: p tiles recomputed from the saved
    lse; one pass over query tiles for dq, one over key tiles for dk/dv."""
    B, S, Hkv, G, Dh = q.shape
    n = S // c
    dev = q.device
    D = torch.einsum("bshgd,bshgd->bhgs", do, o)
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)

    def tile(qi, ki):
        mask = _tile_mask(qi, c, ki, c, window, dev)
        qx, dox = q[:, qi * c:(qi + 1) * c], do[:, qi * c:(qi + 1) * c]
        kx, vx = k[:, ki * c:(ki + 1) * c], v[:, ki * c:(ki + 1) * c]
        lg = torch.einsum("bqhgd,bkhd->bhgqk", qx, kx) * scale
        p = torch.exp(lg - lse[..., qi * c:(qi + 1) * c, None]) * mask
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dox, vx)
        ds = p * (dp - D[..., qi * c:(qi + 1) * c, None]) * scale
        return qx, dox, kx, p, ds

    for qi in range(n):
        for ki in range(n):
            if _tile_visible(qi, c, ki, c, window):
                _, _, kx, _, ds = tile(qi, ki)
                dq[:, qi * c:(qi + 1) * c] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kx)
    for ki in range(n):
        for qi in range(n):
            if _tile_visible(qi, c, ki, c, window):
                qx, dox, _, p, ds = tile(qi, ki)
                dv[:, ki * c:(ki + 1) * c] += torch.einsum("bhgqk,bqhgd->bkhd", p, dox)
                dk[:, ki * c:(ki + 1) * c] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qx)
    return dq, dk, dv


class FlashCore(torch.autograd.Function):
    """``_flash_core`` of the JAX package: blockwise attention whose
    forward keeps only (q, k, v, o, lse) and whose backward recomputes the
    probability tiles — neither pass builds the (Sq, Skv) scores."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, window: int, chunk: int):
        o, lse = _flash_fwd_impl(q, k, v, scale, window, chunk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, window, chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def attend_train_flash(params, cfg: ModelConfig, x, positions, window: int = 0,
                       chunk: int = 512):
    """Flash attention with a FlashAttention-style backward
    (``FlashCore``): neither pass materializes (Sq, Skv) scores."""
    B, S, _ = x.shape
    Hkv, G, Dh = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    q, k, v = qkv(params, cfg, x, positions)
    o = FlashCore.apply(q.reshape(B, S, Hkv, G, Dh).float(), k.float(), v.float(),
                        1.0 / math.sqrt(Dh), window, _chunk_size(S, chunk))
    out = o.reshape(B, S, cfg.num_heads * Dh).to(x.dtype)
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
