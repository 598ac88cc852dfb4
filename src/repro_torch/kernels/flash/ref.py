"""Plain PyTorch version of the flash tree-verification kernel (the
counterpart of ``repro.kernels.flash.ref.ref_flash_verify``).

Dense verification: T tree queries attend the committed prefix (causal,
optionally sliding-window limited) plus the draft tokens under the tree
mask, in one softmax over [prefix | draft]. A row that sees no key gives 0.

The CPU path of ``ops.flash_verify`` runs it; on the card it is what the
kernel is held against.
"""
from __future__ import annotations

import torch

NEG = -1e30


def ref_flash_verify(q, k_cache, v_cache, k_draft, v_draft, positions,
                     prefix_len, tree_mask, window: int = 0):
    """q: (B,T,Hq,Dh) pre-scaled; caches (B,S,Hkv,Dh); draft (B,T,Hkv,Dh);
    positions (B,T); prefix_len an int or a 0-d / (B,) tensor (one length
    per row); tree_mask (B,T,T). Returns (B,T,Hq,Dh) f32."""
    B, T, Hq, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    Gq = Hq // Hkv
    dev = q.device
    qg = q.reshape(B, T, Hkv, Gq, Dh).float()
    plen = torch.as_tensor(prefix_len, device=dev).reshape(-1, 1, 1)
    pos = positions.long()[..., None]                                  # (B,T,1)
    kpos = torch.arange(S, device=dev)[None, None, :]
    pmask = (kpos < plen) & (kpos <= pos)                              # (B,T,S)
    if window > 0:
        pmask = pmask & (kpos > pos - window)
    dist = positions[:, :, None] - positions[:, None, :]
    dmask = tree_mask.bool() & (dist >= 0)
    if window > 0:
        dmask = dmask & (dist < window)
    mask = torch.cat([pmask, dmask], dim=-1)[:, :, None, None]         # (B,T,1,1,S+T)
    lp = torch.einsum("bthgd,bkhd->bthgk", qg, k_cache.float())
    ld = torch.einsum("bthgd,bkhd->bthgk", qg, k_draft.float())
    logits = torch.where(mask, torch.cat([lp, ld], dim=-1),
                         torch.full((), NEG, device=dev))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bthgk,bkhd->bthgd", p[..., :S], v_cache.float()) + \
        torch.einsum("bthgk,bkhd->bthgd", p[..., S:], v_draft.float())
    o = torch.where(l > 0, o / l.clamp_min(1e-30), torch.zeros((), device=dev))
    return o.reshape(B, T, Hq, Dh)
