"""Plain PyTorch version of the routing kernel (the counterpart of
``repro.kernels.routing.ref.ref_routing``): compressed-branch attention and
GQA-shared selection-block scores.

The CPU path of ``ops.routing_fused`` runs it; on the card it is what the
kernel is held against.
"""
from __future__ import annotations

import torch

NEG = -1e30


def ref_routing(q, k_cmp, v_cmp, M, positions, ncb_valid, *, cmp_block: int,
                cmp_stride: int):
    """q: (B,T,Hq,Dh) pre-scaled; k_cmp/v_cmp (B,NCB,Hkv,Dh); M (NCB, NSB)
    overlap matrix; positions (B,T); ncb_valid an int or (B,)/0-d tensor.
    Returns (o_cmp (B,T,Hq,Dh) f32, p_slc (B,T,Hkv,NSB) f32)."""
    B, T, Hq, Dh = q.shape
    NCB, Hkv = k_cmp.shape[1], k_cmp.shape[2]
    Gq = Hq // Hkv
    dev = q.device
    qg = q.reshape(B, T, Hkv, Gq, Dh).float()
    ids = torch.arange(NCB, device=dev)
    ends = ids * cmp_stride + cmp_block - 1
    nv = torch.as_tensor(ncb_valid, device=dev).reshape(-1, 1, 1)
    vis = (ends <= positions[..., None]) & (ids < nv)                 # (B,T,NCB)
    logits = torch.einsum("bthgd,bkhd->bthgk", qg, k_cmp.float())
    mask = vis[:, :, None, None]
    logits = torch.where(mask, logits, torch.full((), NEG, device=dev))
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m) * mask
    l = e.sum(-1, keepdim=True)
    p = torch.where(l > 0, e / l.clamp_min(1e-30), torch.zeros((), device=dev))
    o_cmp = torch.einsum("bthgk,bkhd->bthgd", p, v_cmp.float())
    p_slc = torch.einsum("bthgk,ks->bths", p, M.float())
    return o_cmp.reshape(B, T, Hq, Dh), p_slc
