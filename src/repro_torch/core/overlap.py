"""Cross-query overlap machinery (paper §4) — the PyTorch counterparts of
``repro.core.overlap``:

  * overlap statistics — the Fig. 2 / Fig. 4 profiling quantities
    (``overlap_ratio``, ``adjacent_overlap``,
    ``pairwise_overlap_by_distance``), with set semantics;
  * ``group_queries`` — static grouping of the flattened tree into groups of
    C adjacent queries (host numpy, memoized);
  * ``merged_schedule`` (exact variant) — per-group sorted union of the
    members' selected blocks, deduplicated, with per-query ownership;
  * ``shared_index`` (approximate variant) — the representative query's
    indices broadcast to its whole group.

Merged schedules are padded to the group capacity C * n with a sentinel.
Every sort is stable, so equal keys keep the order ``jnp.argsort`` gives.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

SENTINEL = 2 ** 30


def pad_to_groups(T: int, C: int) -> int:
    return -(-T // C)


def _dedupe(idx, valid):
    """Sort and keep only first occurrences (set semantics for ratio math):
    (sorted keys with SENTINEL for invalid entries, first-occurrence mask)."""
    key = torch.where(valid, idx.to(torch.int64), torch.full((), SENTINEL, dtype=torch.int64,
                                                              device=idx.device))
    s, _ = torch.sort(key, dim=-1, stable=True)
    first = torch.cat([torch.ones(s.shape[:-1] + (1,), dtype=torch.bool, device=s.device),
                       s[..., 1:] != s[..., :-1]], dim=-1)
    return s, first & (s < SENTINEL)


def overlap_ratio(idx_a, valid_a, idx_b, valid_b):
    """|I_a ∩ I_b| / |I_a ∪ I_b| (set semantics) for two index sets (..., n);
    1.0 where both sets are empty. float32."""
    ia, va = _dedupe(idx_a, valid_a)
    ib, vb = _dedupe(idx_b, valid_b)
    eq = (ia[..., :, None] == ib[..., None, :]) & va[..., :, None] & vb[..., None, :]
    inter = eq.any(-1).sum(-1).to(torch.float32)
    na = va.sum(-1).to(torch.float32)
    nb = vb.sum(-1).to(torch.float32)
    union = na + nb - inter
    return torch.where(union > 0, inter / union.clamp_min(1), torch.ones_like(union))


def adjacent_overlap(sel_idx, sel_valid):
    """Mean selected-block overlap between adjacent verifier queries
    (Fig. 2). sel_idx: (B, T, Hkv, n). Returns (T-1,) per-adjacency means."""
    r = overlap_ratio(sel_idx[:, :-1], sel_valid[:, :-1], sel_idx[:, 1:], sel_valid[:, 1:])
    return r.mean(dim=(0, 2))


def pairwise_overlap_by_distance(sel_idx, sel_valid, positions, max_delta: int = 16):
    """Fig. 4: overlap ratio vs |token-position distance|. Returns
    (deltas (max_delta,) numpy, mean overlap (max_delta,), NaN where no pair
    lies at that distance)."""
    r = overlap_ratio(sel_idx[:, :, None], sel_valid[:, :, None],
                      sel_idx[:, None, :], sel_valid[:, None, :])     # (B,T,T,H)
    d = (positions[:, :, None] - positions[:, None, :]).abs()        # (B,T,T)
    out = []
    for delta in range(1, max_delta + 1):
        m = (d == delta)[..., None].expand(r.shape)
        cnt = m.sum()
        tot = torch.where(m, r, torch.zeros((), device=r.device)).sum()
        out.append(tot / cnt if cnt > 0 else torch.tensor(float("nan"), device=r.device))
    return np.arange(1, max_delta + 1), torch.stack(out)


@functools.lru_cache(maxsize=4096)
def group_queries(T: int, C: int):
    """ceil(T/C) groups of up to C adjacent queries; the tail pads with the
    last query (T - 1). Returns (qmap (G, C) read-only numpy, pad)."""
    ngroups = pad_to_groups(T, C)
    pad = ngroups * C - T
    qidx = np.concatenate([np.arange(T), np.full(pad, T - 1)])
    qmap = qidx.reshape(ngroups, C)
    qmap.setflags(write=False)
    return qmap, pad


@functools.lru_cache(maxsize=256)
def _qmap_on(T: int, C: int, device: str):
    qmap, _ = group_queries(T, C)
    return torch.as_tensor(np.array(qmap), dtype=torch.long, device=device)


def _qmap_tensor(T: int, C: int, device):
    """The group map as a device tensor, built once per (T, C, device): a
    host-to-device copy inside the serving step would wait on the stream."""
    return _qmap_on(T, C, str(device)), group_queries(T, C)[1]


def merged_schedule(sel_idx, sel_valid, C: int):
    """sel_idx/sel_valid (B, T, Hkv, n) ->
      merged  (B, G, Hkv, C*n) int32, sorted, SENTINEL-padded;
      own     (B, G, Hkv, C, C*n) bool — query c owns merged slot s;
      m_valid (B, G, Hkv, C*n) bool.
    """
    B, T, H, n = sel_idx.shape
    dev = sel_idx.device
    gi, pad = _qmap_tensor(T, C, dev)
    G = gi.shape[0]
    idx = sel_idx[:, gi].to(torch.int32)                             # (B,G,C,H,n)
    val = sel_valid[:, gi]
    if pad:
        padmask = torch.arange(G * C, device=dev).reshape(G, C) < T
        val = val & padmask[None, :, :, None, None]
    sent = torch.full((), SENTINEL, dtype=torch.int32, device=dev)
    idx = torch.where(val, idx, sent)
    flat = idx.permute(0, 1, 3, 2, 4).reshape(B, G, H, C * n)
    merged, _ = torch.sort(flat, dim=-1, stable=True)
    first = torch.cat([torch.ones(merged.shape[:-1] + (1,), dtype=torch.bool, device=dev),
                       merged[..., 1:] != merged[..., :-1]], dim=-1)
    m_valid = first & (merged < SENTINEL)
    merged = torch.where(m_valid, merged, sent)
    order = torch.argsort(merged, dim=-1, stable=True)
    merged = torch.gather(merged, -1, order)
    m_valid = torch.gather(m_valid, -1, order)
    cand = torch.where(val, idx, torch.full_like(idx, -1)).permute(0, 1, 3, 2, 4)
    own = (merged[:, :, :, None, :, None] == cand[:, :, :, :, None, :]).any(-1)
    return merged, own, m_valid


def shared_index(sel_idx, sel_valid, positions, C: int):
    """Every query in a group adopts the representative's selected blocks;
    the representative is the member with the longest prefix (max
    position, first on ties). Returns (idx, valid), shaped (B, T, Hkv, n)."""
    B, T, H, n = sel_idx.shape
    gi, _ = _qmap_tensor(T, C, sel_idx.device)
    G = gi.shape[0]
    gpos = positions[:, gi]                                          # (B, G, C)
    rep_c = torch.argmax(gpos, dim=-1)                               # (B, G)
    rep_q = torch.gather(gi[None].expand(B, G, C), -1, rep_c[..., None])[..., 0]
    rep_idx = sel_idx[torch.arange(B, device=sel_idx.device)[:, None], rep_q]
    rep_val = sel_valid[torch.arange(B, device=sel_idx.device)[:, None], rep_q]
    out_idx = rep_idx.repeat_interleave(C, dim=1)[:, :T]
    out_val = rep_val.repeat_interleave(C, dim=1)[:, :T]
    return out_idx, out_val
