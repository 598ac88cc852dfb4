"""Native Sparse Attention (NSA), serving subset — the PyTorch counterparts
of ``repro.models.nsa``.

NSA fuses three branches with learned per-head gates:
  cmp — attention over compressed KV blocks (length l, stride d)
  slc — attention over Top-n *selected* raw KV blocks (size l'), routed by
        compressed-attention scores (GQA-group shared)
  win — dense sliding window over the last w tokens

Here: geometry, compression (prefill + incremental commit update),
routing / Top-n selection / gates, the mask-based train / prefill
attention (``attend_train_nsa``) and the plain verify oracle
(``nsa_verify_ref``).
The served verify path goes through ``kernels.nsa_verify`` instead.

Lengths (``prefix_len``, ``ncb_valid``, ``old_len``) may be Python ints or
device int tensors (0-d or per row): the serving step keeps them on the
device so no layer waits on a host sync.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.config import ModelConfig, NSAConfig
from repro_torch.core import kvstore
from repro_torch.models.attention import NEG_INF, qkv


def _rows(x, device, ndim: int):
    """An int or a 0-d / (B,) tensor -> tensor shaped (B|1, 1, ..., 1) with
    ``ndim`` dims, for broadcasting a per-row scalar."""
    t = torch.as_tensor(x, device=device)
    return t.reshape((-1,) + (1,) * (ndim - 1))


# ---------------------------------------------------------------- geometry
def num_cmp_blocks(P: int, nsa: NSAConfig) -> int:
    return 0 if P < nsa.cmp_block else (P - nsa.cmp_block) // nsa.cmp_stride + 1


def num_sel_blocks(P: int, nsa: NSAConfig) -> int:
    return max(0, -(-P // nsa.sel_block))


@functools.lru_cache(maxsize=64)
def overlap_matrix(ncb: int, nsb: int, l: int, d: int, lp: int) -> np.ndarray:
    """Fractional overlap M[i, j] of cmp block i (start i*d, len l) with sel
    block j (start j*lp, len lp) (NSA eq. 9 generalized to l' != d)."""
    i = np.arange(ncb)[:, None]
    j = np.arange(nsb)[None, :]
    lo = np.maximum(i * d, j * lp)
    hi = np.minimum(i * d + l, (j + 1) * lp)
    out = (np.maximum(0, hi - lo) / float(l)).astype(np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=32)
def _overlap_tensor(ncb: int, nsb: int, l: int, d: int, lp: int, device: str):
    return torch.from_numpy(np.array(overlap_matrix(ncb, nsb, l, d, lp))).to(device)


def overlap_tensor(ncb: int, nsb: int, nsa: NSAConfig, device) -> torch.Tensor:
    """``overlap_matrix`` as a tensor on ``device``, uploaded once per shape
    (an upload per call would wait on the stream). Read-only."""
    return _overlap_tensor(ncb, nsb, nsa.cmp_block, nsa.cmp_stride, nsa.sel_block,
                           str(device))


def cmp_visible_mask(positions, ncb: int, nsa: NSAConfig):
    """cmp block i fully precedes query at pos p iff i*d + l - 1 <= p.
    positions: (..., T) -> mask (..., T, ncb)."""
    ends = torch.arange(ncb, device=positions.device) * nsa.cmp_stride + nsa.cmp_block - 1
    return ends <= positions[..., None]


def dyn_num_cmp_blocks(P, nsa: NSAConfig):
    """num_cmp_blocks for a device-resident length (no host sync)."""
    P = torch.as_tensor(P)
    return torch.where(P < nsa.cmp_block, torch.zeros_like(P),
                       torch.div(P - nsa.cmp_block, nsa.cmp_stride,
                                 rounding_mode="floor") + 1)


# ---------------------------------------------------------------- compression
def _pool_project(params, kb, vb, out_dtype):
    """kb/vb (B, n, l, H, Dh) -> softmax position pooling + projection."""
    wk = torch.softmax(params["phi_k"].float(), dim=0)
    wv = torch.softmax(params["phi_v"].float(), dim=0)
    k_cmp = torch.einsum("bnlhd,l->bnhd", kb.float(), wk) @ params["w_cmp_k"].float()
    v_cmp = torch.einsum("bnlhd,l->bnhd", vb.float(), wv) @ params["w_cmp_v"].float()
    return k_cmp.to(out_dtype), v_cmp.to(out_dtype)


def compress_kv(params, k, v, nsa: NSAConfig):
    """k, v: (B, S, Hkv, Dh) -> (B, NCB, Hkv, Dh), NCB = num_cmp_blocks(S)."""
    B, S, H, Dh = k.shape
    ncb = num_cmp_blocks(S, nsa)
    if ncb == 0:
        z = k.new_zeros((B, 0, H, Dh))
        return z, z
    starts = torch.arange(ncb, device=k.device) * nsa.cmp_stride
    idx = starts[:, None] + torch.arange(nsa.cmp_block, device=k.device)[None, :]
    return _pool_project(params, k[:, idx], v[:, idx], k.dtype)


def init_cmp_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    """Compressed-KV cache; the block axis is padded exactly as the JAX
    package pads it (to 512 from max_len 8192 on, else to 8). Padded blocks
    are invisible to every query (cmp_visible_mask + ncb_valid)."""
    ncb = num_cmp_blocks(max_len, cfg.nsa)
    pad_to = 512 if max_len >= 8192 else 8
    ncb_p = max(-(-max(ncb, 1) // pad_to) * pad_to, pad_to) if ncb > 0 else \
        max(1, min(pad_to, 8))
    shape = (batch, ncb_p, cfg.num_kv_heads, cfg.head_dim)
    return {"k_cmp": torch.zeros(shape, dtype=dtype, device=device),
            "v_cmp": torch.zeros(shape, dtype=dtype, device=device)}


def update_cmp_cache_dyn(params, cache, cmp_cache, old_len, new_len,
                         max_new: int, nsa: NSAConfig):
    """Incremental compression update for device-resident lengths.

    ``old_len`` / ``new_len`` are ints or 0-d / (B,) device tensors (one
    length per row). At most ``max_new`` blocks complete per commit;
    candidate blocks are computed unconditionally and masked into a new cmp
    cache (returned; the caller copies it into place). ``cache`` is the
    already-written raw KV: a ``{"k", "v"}`` dict or a ``kvstore.KVView``
    of either backend. Under the paged store the JAX package computes this
    against the pre-write pool with the accepted tokens overlaid
    (``commit_paged_prepare``); the port's commit writes the pool in place
    first, so reading the written pool gives the same values (the overlay
    casts to the store dtype for that reason), and every token of a block
    that completes lies below the new length, inside the row's pages.
    """
    kv = kvstore.as_view(cache)
    dev = kv.k.device
    B, S = kv.batch, kv.max_len
    ncb_old = dyn_num_cmp_blocks(torch.as_tensor(old_len, device=dev), nsa).reshape(-1, 1)
    ncb_new = dyn_num_cmp_blocks(torch.as_tensor(new_len, device=dev), nsa).reshape(-1, 1)
    j = ncb_old + torch.arange(max_new, device=dev)                   # (B|1, max_new)
    idx = (j[..., None] * nsa.cmp_stride +
           torch.arange(nsa.cmp_block, device=dev)).clamp(0, S - 1)
    kb, vb = kv.gather_tokens(idx.expand(B, *idx.shape[1:]))
    k_new, v_new = _pool_project(params, kb, vb, torch.float32)
    valid = j < ncb_new                                               # (B|1, max_new)
    NCB = cmp_cache["k_cmp"].shape[1]
    slot = j.clamp(0, NCB - 1)
    oh = torch.nn.functional.one_hot(slot.long(), NCB).float() * valid[..., None]
    # a slot no new block lands in keeps its bytes exactly
    written = (oh.sum(1) > 0)[:, :, None, None]                       # (B|1, NCB, 1, 1)
    k_cmp = torch.where(written, torch.einsum("bnhd,bnc->bchd", k_new, oh.expand(B, -1, -1))
                        .to(cmp_cache["k_cmp"].dtype), cmp_cache["k_cmp"])
    v_cmp = torch.where(written, torch.einsum("bnhd,bnc->bchd", v_new, oh.expand(B, -1, -1))
                        .to(cmp_cache["v_cmp"].dtype), cmp_cache["v_cmp"])
    return {"k_cmp": k_cmp, "v_cmp": v_cmp}


# ---------------------------------------------------------------- routing
def routing(params, cfg: ModelConfig, q, k_cmp, v_cmp, positions, kv_len: int,
            ncb_valid=None):
    """Compressed attention + selection-block scores (the plain form of the
    routing launch). q: (B, T, Hq, Dh) UNSCALED; k_cmp/v_cmp (B, NCB, Hkv,
    Dh); positions (B, T). Returns (o_cmp (B,T,Hq,Dh) f32, p_slc
    (B,T,Hkv,NSB) f32)."""
    nsa = cfg.nsa
    B, T, Hq, Dh = q.shape
    Hkv, G = cfg.num_kv_heads, cfg.q_per_kv
    ncb = k_cmp.shape[1]
    qg = q.reshape(B, T, Hkv, G, Dh)
    scale = 1.0 / math.sqrt(Dh)
    logits = torch.einsum("bthgd,bnhd->bthgn", qg.float(), k_cmp.float()) * scale
    vis = cmp_visible_mask(positions, ncb, nsa)                     # (B, T, NCB)
    if ncb_valid is not None:
        vis = vis & (torch.arange(ncb, device=q.device) < _rows(ncb_valid, q.device, 3))
    neg = torch.full((), NEG_INF, device=q.device)
    logits = torch.where(vis[:, :, None, None], logits, neg)
    p_cmp = torch.softmax(logits, dim=-1)
    p_cmp = torch.where(vis[:, :, None, None], p_cmp, torch.zeros((), device=q.device))
    o_cmp = torch.einsum("bthgn,bnhd->bthgd", p_cmp, v_cmp.float()).reshape(B, T, Hq, Dh)
    nsb = num_sel_blocks(kv_len, nsa)
    M = overlap_tensor(ncb, max(nsb, 1), nsa, q.device)
    p_slc = torch.einsum("bthn,ns->bths", p_cmp.sum(dim=3), M)
    return o_cmp, p_slc


def select_topn(p_slc, positions, kv_len, nsa: NSAConfig):
    """Top-n selection-block indices with mandatory initial + local blocks.

    p_slc (B, T, Hkv, NSB); positions (B, T); kv_len an int or device
    tensor (0-d or (B,)). Returns (indices (B,T,Hkv,n) int32 sorted
    ascending, valid (B,T,Hkv,n) bool); invalid slots carry index 0.

    Ties are broken toward the lower block index, as ``jax.lax.top_k``
    does: a stable descending sort, never ``torch.topk`` (whose tie order
    is unspecified). Ties are common — uncovered causal blocks all score 0,
    and the +1e6 mandatory bump rounds small differences away in f32.
    """
    B, T, Hkv, NSB = p_slc.shape
    dev = p_slc.device
    n = min(nsa.n_selected, NSB)
    blk = torch.arange(NSB, device=dev)
    starts = blk * nsa.sel_block
    causal = (starts <= positions[..., None, None]).expand(B, T, Hkv, NSB)
    causal = causal & (starts < _rows(kv_len, dev, 4))
    neg = torch.full((), NEG_INF, device=dev)
    scores = torch.where(causal, p_slc, neg)
    mand = torch.zeros((B, T, Hkv, NSB), dtype=torch.bool, device=dev)
    if nsa.n_init_blocks > 0:
        mand[..., : nsa.n_init_blocks] = True
    if nsa.n_local_blocks > 0:
        last = torch.minimum(positions[..., None], _rows(kv_len, dev, 3) - 1)
        last_blk = torch.div(last, nsa.sel_block, rounding_mode="floor").reshape(B, T, 1, 1)
        off = torch.arange(nsa.n_local_blocks, device=dev).reshape(1, 1, 1, -1)
        loc = (last_blk - off).clamp(0, NSB - 1)                     # (B,T,1,nl)
        hit = (loc[..., None] == blk).any(dim=3)                     # (B,T,1,NSB)
        mand = mand | hit
    mand = mand & causal
    scores = torch.where(mand, scores + 1e6, scores)

    top_vals, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[..., :n], top_idx[..., :n]
    valid = top_vals > NEG_INF / 2
    top_idx = torch.where(valid, top_idx, torch.zeros_like(top_idx))
    order = torch.argsort(torch.where(valid, top_idx, torch.full_like(top_idx, NSB + 1)),
                          dim=-1, stable=True)
    top_idx = torch.gather(top_idx, -1, order).to(torch.int32)
    valid = torch.gather(valid, -1, order)
    return top_idx, valid


def gates(params, x, num_heads: int):
    g = torch.sigmoid(x.float() @ params["w_gate"].float() + params["b_gate"].float())
    B, T = x.shape[0], x.shape[1]
    return g.reshape(B, T, 3, num_heads)          # (B,T,3,Hq): cmp, slc, win


# ---------------------------------------------------------------- prefill
def attend_train_nsa(params, cfg: ModelConfig, x, positions, chunk: int = 512):
    """Full-sequence NSA with exact semantics via masks (train / prefill).

    Returns (out (B,S,D), (k, v)). Chunked over queries only when
    ``S % chunk == 0``, as in the JAX package; otherwise one chunk builds
    S x S score tensors. The query at position p treats tokens < p as its
    committed prefix (the serve-consistent semantics ``nsa_verify_ref``
    computes with prefix_len == p). Differentiable: autograd gives the JAX
    gradients; the Top-n indices carry none, in either package. Every op
    has a deterministic CUDA implementation (the selection masks are
    comparisons, not scatters), so a train step can run under
    ``torch.use_deterministic_algorithms(True)``.
    """
    q, k, v = qkv(params, cfg, x, positions)
    k_cmp, v_cmp = compress_kv(params, k, v, cfg.nsa)
    out = attend_queries(cfg, q, gates(params, x, cfg.num_heads), positions, k, v,
                         k_cmp, v_cmp, chunk=chunk)
    return out @ params["wo"], (k, v)


def query_chunks(S: int, q0: int, q1: int, chunk: int = 512):
    """The query runs ``attend_queries`` takes for global positions
    ``[q0, q1)`` of an S-token sequence: the pieces of ``attend_train_nsa``'s
    chunks (S // chunk of them when ``chunk`` divides S, else one) that lie
    in the range, as (start, stop) pairs."""
    nchunk = max(1, S // chunk) if (chunk and S % chunk == 0) else 1
    Sc = S // nchunk
    return [(max(q0, i * Sc), min(q1, (i + 1) * Sc)) for i in range(q0 // Sc, -(-q1 // Sc))
            if max(q0, i * Sc) < min(q1, (i + 1) * Sc)]


def attend_queries(cfg: ModelConfig, q, g_all, positions, k, v, k_cmp, v_cmp, q0: int = 0,
                   chunk: int = 512):
    """NSA attention of the queries at global positions ``[q0, q0 + Tq)``
    over a whole S-token sequence: q (B, Tq, Hq, Dh) after RoPE, their gates
    g_all (B, Tq, 3, Hq) and positions (B, Tq); k, v (B, S, Hkv, Dh) and
    the sequence's compressed blocks k_cmp, v_cmp (B, NCB, Hkv, Dh). The
    queries run in ``query_chunks``' pieces, so the whole range (q0 = 0, Tq
    = S) is ``attend_train_nsa``'s computation and a slice of it the same
    rows of it. Returns the gated heads (B, Tq, Hq * Dh) in q's dtype,
    before the output projection."""
    nsa = cfg.nsa
    B, Tq = q.shape[0], q.shape[1]
    S = k.shape[1]
    Hq, Hkv, G, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    dev = q.device
    nsb = num_sel_blocks(S, nsa)
    scale = 1.0 / math.sqrt(Dh)
    kf, vf = k.float(), v.float()
    tok = torch.arange(S, device=dev)
    blk_of_tok = torch.div(tok, nsa.sel_block, rounding_mode="floor")
    neg = torch.full((), NEG_INF, device=dev)
    zero = torch.zeros((), device=dev)
    outs = []
    for a, b in query_chunks(S, q0, q0 + Tq, chunk):
        sl = slice(a - q0, b - q0)
        Sc = b - a
        qc, posc, gc = q[:, sl], positions[:, sl], g_all[:, sl]
        o_cmp, p_slc = routing(None, cfg, qc, k_cmp, v_cmp, posc - 1, S)
        idx, idx_valid = select_topn(p_slc, posc - 1, S, nsa)        # (B,Sc,Hkv,n)
        # token-granular selection mask: block-level hits, then per token
        hits = ((idx[..., None] == torch.arange(nsb, device=dev)) &
                idx_valid[..., None]).any(dim=3)                     # (B,Sc,Hkv,nsb)
        sel_mask = hits[..., blk_of_tok]                             # (B,Sc,Hkv,S)
        sel_mask = sel_mask & (tok < posc[..., None])[:, :, None, :]
        qg = qc.reshape(B, Sc, Hkv, G, Dh).float()
        logit = torch.einsum("bthgd,bkhd->bhgtk", qg, kf) * scale
        m_s = sel_mask.permute(0, 2, 1, 3)[:, :, None]
        p_s = torch.softmax(torch.where(m_s, logit, neg), dim=-1)
        p_s = torch.where(m_s, p_s, zero)
        o_slc = torch.einsum("bhgtk,bkhd->bthgd", p_s, vf).reshape(B, Sc, Hq, Dh)
        win_mask = (tok <= posc[..., None]) & (tok > posc[..., None] - nsa.window)
        p_w = torch.softmax(torch.where(win_mask[:, None, None], logit, neg), dim=-1)
        o_win = torch.einsum("bhgtk,bkhd->bthgd", p_w, vf).reshape(B, Sc, Hq, Dh)
        out = (gc[:, :, 0, :, None] * o_cmp + gc[:, :, 1, :, None] * o_slc +
               gc[:, :, 2, :, None] * o_win)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Tq, Hq * Dh)


# ---------------------------------------------------------------- verify (ref)
def gather_blocks(kv, idx, sel_block: int):
    """Selected-block gather through the KV view (dense or paged); invalid
    and unmapped blocks read zeros."""
    return kvstore.as_view(kv).gather_blocks(idx, sel_block)


def nsa_verify_ref(params, cfg: ModelConfig, x, cache, cmp_cache, prefix_len,
                   positions, tree_mask, sel_idx=None, sel_valid=None):
    """Plain NSA verification oracle over T draft tokens (the counterpart of
    the JAX ``nsa_verify_ref``). Returns (out (B,T,D), (k_new, v_new),
    (sel_idx, sel_valid)). Not on the served path: the served verify goes
    through ``kernels.nsa_verify.ops.nsa_verify_kernel_layer``. ``cache``
    is a ``{"k", "v"}`` dict or a ``kvstore.KVView`` (dense or paged);
    ``prefix_len`` an int or a 0-d / (B,) tensor."""
    nsa = cfg.nsa
    B, T, _ = x.shape
    Hq, Hkv, G, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    dev = x.device
    kv = kvstore.as_view(cache)
    q, k_new, v_new = qkv(params, cfg, x, positions)
    scale = 1.0 / math.sqrt(Dh)
    plen = torch.as_tensor(prefix_len, device=dev)
    ncb_valid = dyn_num_cmp_blocks(plen, nsa)
    g_all = gates(params, x, Hq)
    neg = torch.full((), NEG_INF, device=dev)
    zero = torch.zeros((), device=dev)

    o_cmp, p_slc = routing(params, cfg, q, cmp_cache["k_cmp"], cmp_cache["v_cmp"],
                           positions, kv_len=kv.max_len, ncb_valid=ncb_valid)
    if sel_idx is None:
        sel_idx, sel_valid = select_topn(p_slc, positions, plen, nsa)

    k_sel, v_sel = gather_blocks(kv, sel_idx, nsa.sel_block)
    n = sel_idx.shape[-1]
    tok_pos = sel_idx[..., None] * nsa.sel_block + torch.arange(nsa.sel_block, device=dev)
    qg = q.reshape(B, T, Hkv, G, Dh).float()
    logit_sel = torch.einsum("bthgd,bthnld->bthgnl", qg, k_sel.float()) * scale
    m_sel = (tok_pos >= 0) & (tok_pos < _rows(plen, dev, 5)) & \
        (tok_pos <= positions[:, :, None, None, None]) & sel_valid[..., None]
    logit_sel = torch.where(m_sel[:, :, :, None], logit_sel, neg)
    p_sel = torch.softmax(logit_sel.reshape(B, T, Hkv, G, n * nsa.sel_block), dim=-1)
    p_sel = torch.where(m_sel[:, :, :, None].reshape(B, T, Hkv, 1, -1), p_sel, zero)
    o_slc = torch.einsum("bthgk,bthkd->bthgd", p_sel,
                         v_sel.reshape(B, T, Hkv, n * nsa.sel_block, Dh).float())
    o_slc = o_slc.reshape(B, T, Hq, Dh)

    S_max = kv.max_len
    W = min(nsa.window, S_max)
    win_start = (plen - W).clamp(0, max(S_max - W, 0))
    k_win, v_win = kv.window(win_start, W)
    kpos = (win_start.reshape(-1, 1) + torch.arange(W, device=dev))[:, None, :]
    pmask = (kpos < _rows(plen, dev, 3)) & (kpos > positions[..., None] - nsa.window) & \
        (kpos <= positions[..., None])
    logit_p = torch.einsum("bthgd,bkhd->bthgk", qg, k_win.float()) * scale
    logit_p = torch.where(pmask[:, :, None, None], logit_p, neg)
    dist = positions[:, :, None] - positions[:, None, :]
    dmask = tree_mask & (dist < nsa.window) & (dist >= 0)
    logit_d = torch.einsum("bthgd,bkhd->bthgk", qg, k_new.float()) * scale
    logit_d = torch.where(dmask[:, :, None, None], logit_d, neg)
    p_w = torch.softmax(torch.cat([logit_p, logit_d], dim=-1), dim=-1)
    o_win = torch.einsum("bthgk,bkhd->bthgd", p_w[..., :W], v_win.float()) + \
        torch.einsum("bthgk,bkhd->bthgd", p_w[..., W:], v_new.float())
    o_win = o_win.reshape(B, T, Hq, Dh)

    out = (g_all[:, :, 0, :, None] * o_cmp + g_all[:, :, 1, :, None] * o_slc +
           g_all[:, :, 2, :, None] * o_win).to(x.dtype)
    out = out.reshape(B, T, Hq * Dh) @ params["wo"]
    return out, (k_new, v_new), (sel_idx, sel_valid)
