"""Plain PyTorch version of the fused NSA verification kernel (the
counterpart of ``repro.kernels.nsa_verify.ref.ref_verify_batched``),
vectorized over batch, query groups and kv heads.

Per (batch b, query group g of C adjacent tree queries, kv head h), with
R = C*Gq query rows, three branches with independent softmax states and a
gated sum:

  cmp — compressed KV (block fully before the query, index < ncb_valid),
        or the routing launch's output ``o_cmp_in`` (partial fusion);
  slc — the group's merged selected blocks (exact: ownership restores
        per-query semantics; approx: every row owns every block);
  win — the trailing window [win_start, win_start + W) of the prefix plus
        the draft tokens under ``dmask`` (tree mask, window distance).

Under the paged store (``page_table`` given) k/v_cache are the shared pool
``(P, page_size, Hkv, Dh)`` and every cache read resolves through the row's
page table; an unmapped page reads zeros (the caller has already cleared
the validity of merged blocks on unmapped pages, so in the slc branch
only the window can meet one, and there its zeros pass the position mask,
as in the JAX paged window).

Branches with no visible key contribute 0. ``branch="slc"`` or ``"win"``
(the vanilla baseline, JAX ``combine=False``) returns that one branch,
ungated. The CPU path of ``ops.verify_groups`` runs this; on the card the
kernel is held against it.
"""
from __future__ import annotations

import torch

from repro_torch.core import kvstore

NEG = -1e30


def _branch(logits, mask, v):
    """Softmax attention with fully masked rows -> 0.
    logits (..., R, K); mask broadcastable; v (..., K, Dh)."""
    lg = torch.where(mask, logits, torch.full((), NEG, device=logits.device))
    m = lg.amax(-1, keepdim=True)
    p = torch.exp(lg - m) * mask
    l = p.sum(-1, keepdim=True)
    o = p @ v
    return torch.where(l > 0, o / l.clamp_min(1e-30), torch.zeros((), device=o.device))


def verify_groups_plain(q, k_cache, v_cache, k_cmp, v_cmp, k_draft, v_draft,
                        merged, mvalid, own, qmap, positions, prefix_len,
                        ncb_valid, win_start, dmask, gates, o_cmp_in=None, *,
                        sel_block: int, cmp_block: int, cmp_stride: int,
                        window: int, include_cmp: bool = True,
                        branch: str = "all", page_table=None):
    """q (B,T,Hq,Dh) pre-scaled; k/v_cache (B,S,Hkv,Dh); k/v_cmp
    (B,NCB,Hkv,Dh); k/v_draft (B,T,Hkv,Dh); merged/mvalid (B,G,Hkv,M);
    own (B,G,Hkv,C,M); qmap (G,C); positions (B,T); prefix_len, ncb_valid,
    win_start (B,); dmask (B,T,T) bool or int; gates (B,T,3,Hq); o_cmp_in
    (B,T,Hq,Dh) when include_cmp is False and branch is "all"; page_table
    (B, max_pages) int32 or None (dense). Returns (B,T,Hq,Dh) f32."""
    B, T, Hq, Dh = q.shape
    view = kvstore.KVView(k_cache, v_cache, page_table)
    S, Hkv = view.max_len, k_cache.shape[2]
    Gq = Hq // Hkv
    G, C = qmap.shape
    R = C * Gq
    dev = q.device
    qmap = qmap.long()

    def grp(x):
        """(B, T, Hq, *rest) -> (B, G, Hkv, R, *rest)."""
        rest = tuple(x.shape[3:])
        xs = x.reshape(B, T, Hkv, Gq, *rest)[:, qmap]          # (B,G,C,Hkv,Gq,..)
        perm = (0, 1, 3, 2, 4) + tuple(range(5, xs.ndim))
        return xs.permute(*perm).reshape(B, G, Hkv, R, *rest)

    def heads(x):
        """(B, N, Hkv, Dh) -> (B, 1, Hkv, N, Dh) f32."""
        return x.float().permute(0, 2, 1, 3)[:, None]

    qg = grp(q.float())                                          # (B,G,Hkv,R,Dh)
    pos_r = positions[:, qmap].repeat_interleave(Gq, dim=2)[:, :, None, :, None]
    plen = prefix_len.reshape(B, 1, 1, 1, 1)

    def ungroup(o):
        o = o.reshape(B, G, Hkv, C, Gq, Dh).permute(0, 1, 3, 2, 4, 5)
        return o.reshape(B, G * C, Hq, Dh)[:, :T]

    # ---- cmp
    if branch != "all":
        o_cmp = None
    elif include_cmp:
        NCB = k_cmp.shape[1]
        ids = torch.arange(NCB, device=dev)
        ends = ids * cmp_stride + cmp_block - 1
        cmask = (ends <= pos_r) & (ids < ncb_valid.reshape(B, 1, 1, 1, 1))
        logits = qg @ heads(k_cmp).transpose(-1, -2)
        o_cmp = _branch(logits, cmask, heads(v_cmp))
    else:
        o_cmp = grp(o_cmp_in.float())

    # ---- slc over the merged blocks
    if branch != "win":
        M = merged.shape[-1]
        k_sel, v_sel = view.gather_blocks(merged.clamp_min(0), sel_block)  # (B,G,Hkv,M,lb,Dh)
        k_sel = k_sel.reshape(B, G, Hkv, M * sel_block, Dh).float()
        v_sel = v_sel.reshape(B, G, Hkv, M * sel_block, Dh).float()
        tok = merged.clamp_min(0)[..., None].long() * sel_block + \
            torch.arange(sel_block, device=dev)                      # (B,G,Hkv,M,lb)
        tokc = tok.reshape(B, G, Hkv, M * sel_block)
        valid_tok = ((merged >= 0) & (mvalid > 0)).repeat_interleave(sel_block, dim=-1)
        own_tok = (own > 0).repeat_interleave(Gq, dim=3).repeat_interleave(sel_block, dim=-1)
        tk = tokc[:, :, :, None, :]
        smask = (tk < plen) & (tk <= pos_r) & valid_tok[:, :, :, None, :] & own_tok
        o_slc = _branch(qg @ k_sel.transpose(-1, -2), smask, v_sel)
        if branch == "slc":
            return ungroup(o_slc)

    # ---- win: trailing prefix slice + draft tokens
    W = min(window, S)
    kpos = win_start.reshape(B, 1).long() + torch.arange(W, device=dev)  # (B,W)
    k_win, v_win = view.gather_tokens(kpos)                       # (B,W,Hkv,Dh)
    kp = kpos.reshape(B, 1, 1, 1, W)
    wmask = (kp < plen) & (kp > pos_r - window) & (kp <= pos_r)
    drow = (dmask[:, qmap] > 0).repeat_interleave(Gq, dim=2)[:, :, None]  # (B,G,1,R,T)
    logits_w = torch.cat([qg @ heads(k_win).transpose(-1, -2),
                          qg @ heads(k_draft).transpose(-1, -2)], dim=-1)
    mask_w = torch.cat([wmask.expand(B, G, 1, R, W), drow], dim=-1)
    o_win = _branch(logits_w, mask_w,
                    torch.cat([heads(v_win), heads(v_draft)], dim=-2))
    if branch == "win":
        return ungroup(o_win)

    g = grp(gates.float().permute(0, 1, 3, 2))                    # (B,G,Hkv,R,3)
    return ungroup(g[..., 0:1] * o_cmp + g[..., 1:2] * o_slc + g[..., 2:3] * o_win)
