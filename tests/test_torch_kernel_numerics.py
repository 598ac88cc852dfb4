"""The arithmetic of the Hopper nsa_verify, flash_verify and routing
kernels, emulated in plain torch on the CPU and held against their plain
versions.

The kernels take f32 q and bf16 K/V and run both products on bf16 tensor
cores: q and the probabilities P are split into two bf16 terms (hi =
bf16(x), lo = bf16(x - hi)), each product is two bf16 x bf16 -> f32
products, K and V are exact in bf16. Each CTA walks its chunk of the work
list in units of 16 keys dealt to four warps in turn, each warp with its
own online softmax; the warps merge in order into the CTA's partial, and
the partials merge in chunk order (``ops.split_plan``; routing:
``ops.routing_plan``, with the chunk-local selection scores rescaled by
the same merge scales as o_cmp).
The emulation below repeats exactly that, at the full-width head dims and
head counts and at the zoo's query-head groups (routing's 16-head slabs at
Gq 16 and 48; nsa_verify's 16-row tiles at 24 and 96 rows), with inputs
drawn as ``chip_smoke.py``'s ``verify_inputs`` draws them.

Tolerance: rtol 2e-4, atol 2e-5, the f32 tolerance ``chip_smoke.py``'s
``TOL`` holds the kernels to. The split leaves a residual of about 2^-16 of
q and P (the lo term's own rounding), far inside rtol 2e-4, so the kernels
keep the f32 tolerance: nothing is loosened for bf16.
"""
import math

import pytest
import torch

from repro_torch.config import NSAConfig
from repro_torch.core.tree import build_topology
from repro_torch.kernels.flash import ops as fops, ref as fref
from repro_torch.kernels.nsa_verify import ops as vops, ref as vref
from repro_torch.kernels.routing import ops as rops, ref as rref
from repro_torch.models import nsa as nsa_lib

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

NSA = NSAConfig(cmp_block=32, cmp_stride=16, sel_block=64, n_selected=16, window=512)
RTOL, ATOL = 2e-4, 2e-5
NEG, UK, NW = -1e30, 16, 4
# floats of the smallest instance's ring scratch (online_softmax.cuh
# Walk::SCRATCH at bf16, Dh 64: 4 warps x 2 stages x 16 keys x (64 + 8) x 2
# tensors x 2 bytes), which holds the last CTA's merge table
SCRATCH_MIN = 4 * 2 * 16 * (64 + 8) * 2 * 2 // 4


def _split(x):
    """f32 -> (hi, lo), two bf16-valued f32 tensors with hi + lo ~= x."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _walk(q, k, v, mask, logits=None):
    """One CTA: q (P,R,Dh) f32; k, v (P,N,Dh) bf16-valued; mask (P,R,N),
    N a multiple of 16. Units of 16 keys go to warp u % 4; each warp keeps
    an online softmax; the warps merge in order. Returns (m, l, acc); each
    unit's raw logits (P,R,16), before the mask, go to the list
    ``logits`` when one is given (routing's hook)."""
    P, R, Dh = q.shape
    q_hi, q_lo = _split(q)
    m = torch.full((NW, P, R), NEG)
    l = torch.zeros((NW, P, R))
    acc = torch.zeros((NW, P, R, Dh))
    for u in range(k.shape[1] // UK):
        w, ks = u % NW, slice(u * UK, (u + 1) * UK)
        kt = k[:, ks].transpose(1, 2)
        s = q_hi @ kt + q_lo @ kt
        if logits is not None:
            logits.append(s)
        s = s.masked_fill(~mask[:, :, ks], -math.inf)
        m_new = torch.maximum(m[w], s.amax(-1))
        p = torch.where(mask[:, :, ks], torch.exp(s - m_new[..., None]), torch.zeros(()))
        alpha = torch.exp(m[w] - m_new)
        p_hi, p_lo = _split(p)
        l[w] = l[w] * alpha + p.sum(-1)
        acc[w] = acc[w] * alpha[..., None] + p_hi @ v[:, ks] + p_lo @ v[:, ks]
        m[w] = m_new
    live = l > 0
    M = torch.where(live, m, torch.full((), NEG)).amax(0)
    e = torch.where(live, torch.exp(m - M), torch.zeros(()))
    return M, (l * e).sum(0), (acc * e[..., None]).sum(0)


def _scales(parts):
    """The last CTA's scale of each partial [(m, l, acc)] per row,
    exp(m - M) / L over the partials with l > 0 (0 for the others and for
    rows that saw no key): (X, P, R)."""
    m = torch.stack([p[0] for p in parts])
    l = torch.stack([p[1] for p in parts])
    live = l > 0
    M = torch.where(live, m, torch.full((), NEG)).amax(0)
    L = (l * torch.where(live, torch.exp(m - M), torch.zeros(()))).sum(0)
    return torch.where(live & (L > 0), torch.exp(m - M) / L.clamp_min(1e-30), torch.zeros(()))


def _merge(parts):
    """The last CTA's merge of partials [(m, l, acc)] in chunk order; rows
    that saw no key give 0."""
    sc = _scales(parts)
    out = torch.zeros_like(parts[0][2])
    for i, p in enumerate(parts):
        out = out + sc[i][..., None] * p[2]
    return out


def _walk_tiles(q, k, v, mask):
    """A group's rows in tiles of 16, each tile walking the chunk as its own
    CTA (``vops.row_tiles``); rows are independent, so the tiles' partials
    side by side are the group's."""
    R = q.shape[1]
    assert -(-R // 16) == vops.row_tiles(1, R)
    outs = [_walk(q[:, i:i + 16], k, v, mask[:, i:i + 16]) for i in range(0, R, 16)]
    return tuple(torch.cat([o[j] for o in outs], 1) for j in range(3))


def _pad(k, v, mask):
    """Pad the key axis to a multiple of 16 with masked zero keys."""
    n = -k.shape[1] % UK
    if n:
        k = torch.cat([k, k.new_zeros(k.shape[0], n, k.shape[2])], 1)
        v = torch.cat([v, v.new_zeros(v.shape[0], n, v.shape[2])], 1)
        mask = torch.cat([mask, mask.new_zeros(mask.shape[0], mask.shape[1], n)], 2)
    return k, v, mask


def _chunks(M, NCB, W, T, sel_block, include_cmp, branch="all", rows=8):
    """The chunks of ``ops.split_plan`` in the kernel's order, one per CTA,
    as nsa_verify.cu cuts them: (branch, items) with branch 0 cmp, 1 slc,
    2 win, and items a list of cmp block indices, merged-slot indices, or
    ("w", window key) / ("d", draft token) pairs (the draft joins the last
    window chunk)."""
    n_cmp, n_slc, n_win, keys, blocks = vops.split_plan(M, NCB, W, sel_block, include_cmp,
                                                        branch, rows)
    out = [(0, list(range(x * keys, min(x * keys + keys, NCB)))) for x in range(n_cmp)]
    out += [(1, list(range(x * blocks, min(x * blocks + blocks, M)))) for x in range(n_slc)]
    for x in range(n_win):
        items = [("w", k) for k in range(x * keys, min(x * keys + keys, W))]
        if x == n_win - 1:
            items += [("d", d) for d in range(T)]
        out.append((2, items))
    return out


def _verify_inputs(Dh, prefixes, S, seed, Hq=32, Hkv=8):
    """chip_smoke.py's verify_inputs on the CPU: D4/k2 tree, Top-n on
    random scores, bf16 K/V, q scaled by 1/sqrt(Dh)."""
    g = torch.Generator().manual_seed(seed)
    topo = build_topology(4, 2, "bfs")
    plen = torch.tensor(prefixes, dtype=torch.int32)
    B, T = len(prefixes), topo.num_nodes
    pos = (plen[:, None] + torch.as_tensor(topo.depths)[None]).to(torch.int32)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dtype)

    NCB = nsa_lib.num_cmp_blocks(S, NSA)
    p_slc = torch.rand((B, T, Hkv, nsa_lib.num_sel_blocks(S, NSA)), generator=g)
    sel, val = nsa_lib.select_topn(p_slc, pos, plen, NSA)
    return dict(q=r(B, T, Hq, Dh, dtype=torch.float32) / Dh ** 0.5,
                k_cache=r(B, S, Hkv, Dh), v_cache=r(B, S, Hkv, Dh),
                k_cmp=r(B, NCB, Hkv, Dh), v_cmp=r(B, NCB, Hkv, Dh),
                k_draft=r(B, T, Hkv, Dh), v_draft=r(B, T, Hkv, Dh), sel=sel, val=val,
                pos=pos, plen=plen, ncb_valid=nsa_lib.dyn_num_cmp_blocks(plen, NSA),
                tree=torch.as_tensor(topo.mask)[None].expand(B, T, T),
                gates=torch.sigmoid(r(B, T, 3, Hq, dtype=torch.float32)),
                o_cmp=r(B, T, Hq, Dh, dtype=torch.float32))


def _verify_args(x, C, mode):
    """The kernel-boundary arguments (as nsa_verify_fused builds them)."""
    S = x["k_cache"].shape[1]
    merged, mvalid, own, qmap = vops.group_layouts(x["sel"], x["val"], x["pos"], C, mode)
    W = min(NSA.window, S)
    dist = x["pos"][:, :, None] - x["pos"][:, None, :]
    return dict(q=x["q"], k_cache=x["k_cache"], v_cache=x["v_cache"], k_cmp=x["k_cmp"],
                v_cmp=x["v_cmp"], k_draft=x["k_draft"], v_draft=x["v_draft"], merged=merged,
                mvalid=mvalid, own=own, qmap=qmap, positions=x["pos"], prefix_len=x["plen"],
                ncb_valid=x["ncb_valid"].reshape(-1).expand(x["q"].shape[0]),
                win_start=(x["plen"] - W).clamp(0, S - W),
                dmask=x["tree"] & (dist < NSA.window) & (dist >= 0), gates=x["gates"])


def _emulate_verify(a, o_cmp_in, include_cmp):
    """The nsa_verify kernel's arithmetic: per (row, group, kv head) the
    three branch lists, cut by the split plan, each chunk walked as a CTA,
    the partials merged per branch in chunk order, then the gates."""
    B, T, Hq, Dh = a["q"].shape
    S, Hkv = a["k_cache"].shape[1], a["k_cache"].shape[2]
    G, C = a["qmap"].shape
    Gq, M, NCB = Hq // Hkv, a["merged"].shape[-1], a["k_cmp"].shape[1]
    R, lb, W = C * Gq, NSA.sel_block, min(NSA.window, S)
    qmap = a["qmap"].long()
    P = B * G * Hkv

    def per_pair(t):                      # (B, G, Hkv, ...) -> (P, ...)
        return t.reshape(P, *t.shape[3:])

    qg = a["q"].reshape(B, T, Hkv, Gq, Dh)[:, qmap].permute(0, 1, 3, 2, 4, 5)
    qg = per_pair(qg.reshape(B, G, Hkv, R, Dh))
    qi = qmap.repeat_interleave(Gq, dim=1)                              # (G, R)
    c_of = torch.arange(R) // Gq
    pos = a["positions"].long()[:, qi][:, :, None, :].expand(B, G, Hkv, R)
    pos = per_pair(pos)                                                 # (P, R)
    bidx = torch.arange(B)[:, None, None].expand(B, G, Hkv).reshape(P)
    hidx = torch.arange(Hkv)[None, None, :].expand(B, G, Hkv).reshape(P)
    plen = a["prefix_len"].long()[bidx][:, None, None]                  # (P, 1, 1)

    def kv(src_k, src_v, tok):                      # tok (P, N) -> (P, N, Dh) f32
        t = tok.clamp(0, src_k.shape[1] - 1)
        return (src_k[bidx[:, None], t, hidx[:, None]].float(),
                src_v[bidx[:, None], t, hidx[:, None]].float())

    # cmp: key n = cmp block n
    n = torch.arange(NCB)
    ncbv = a["ncb_valid"].long()[bidx][:, None, None]
    k_c, v_c = kv(a["k_cmp"], a["v_cmp"], n[None].expand(P, NCB))
    m_c = (n[None, None] < ncbv) & (n * NSA.cmp_stride + NSA.cmp_block - 1 <= pos[..., None])
    # slc: slot mi holds keys mi*lb .. mi*lb + lb - 1 of its block
    blk = per_pair(a["merged"]).long()                                  # (P, M)
    ok = (blk >= 0) & (per_pair(a["mvalid"]) > 0)
    tok = (blk.clamp_min(0)[..., None] * lb + torch.arange(lb)).reshape(P, M * lb)
    k_s, v_s = kv(a["k_cache"], a["v_cache"], tok)
    own = per_pair(a["own"]) > 0                                        # (P, C, M)
    own_r = own[:, c_of].repeat_interleave(lb, dim=-1)                  # (P, R, M*lb)
    m_s = ((tok[:, None] < plen) & (tok[:, None] <= pos[..., None]) & (tok[:, None] < S) &
           ok.repeat_interleave(lb, dim=-1)[:, None] & own_r)
    # win: W window keys from win_start, then the T draft tokens
    kp = a["win_start"].long()[bidx][:, None] + torch.arange(W)        # (P, W)
    k_w, v_w = kv(a["k_cache"], a["v_cache"], kp)
    m_w = ((kp[:, None] < plen) & (kp[:, None] > pos[..., None] - NSA.window) &
           (kp[:, None] <= pos[..., None]))
    k_d, v_d = kv(a["k_draft"], a["v_draft"], torch.arange(T)[None].expand(P, T))
    dm = a["dmask"].bool()[:, qi]                                       # (B, G, R, T)
    m_d = per_pair(dm[:, :, None].expand(B, G, Hkv, R, T))

    parts = {0: [], 1: [], 2: []}
    for br, items in _chunks(M, NCB, W, T, lb, include_cmp, "all", R):
        if br == 0:
            idx = torch.tensor(items, dtype=torch.long)
            chunk = [(k_c[:, idx], v_c[:, idx], m_c[:, :, idx])]
        elif br == 1:
            idx = (torch.tensor(items, dtype=torch.long)[:, None] * lb + torch.arange(lb))
            idx = idx.reshape(-1)
            chunk = [(k_s[:, idx], v_s[:, idx], m_s[:, :, idx])]
        else:
            wi = torch.tensor([i for t, i in items if t == "w"], dtype=torch.long)
            di = torch.tensor([i for t, i in items if t == "d"], dtype=torch.long)
            chunk = [(k_w[:, wi], v_w[:, wi], m_w[:, :, wi]),   # the draft starts a unit
                     (k_d[:, di], v_d[:, di], m_d[:, :, di])]
        padded = [_pad(*c) for c in chunk if c[0].shape[1]]
        k, v = (torch.cat([c[i] for c in padded], 1) for i in (0, 1))
        m = torch.cat([c[2] for c in padded], 2)
        parts[br].append(_walk_tiles(qg, k, v, m))
    o = {br: _merge(ps) if ps else torch.zeros_like(qg) for br, ps in parts.items()}
    if not include_cmp:
        oc = o_cmp_in.reshape(B, T, Hkv, Gq, Dh)[:, qmap].permute(0, 1, 3, 2, 4, 5)
        o[0] = per_pair(oc.reshape(B, G, Hkv, R, Dh))
    gt = a["gates"].permute(0, 1, 3, 2).reshape(B, T, Hkv, Gq, 3)[:, qmap]
    gt = per_pair(gt.permute(0, 1, 3, 2, 4, 5).reshape(B, G, Hkv, R, 3))
    out = gt[..., 0:1] * o[0] + gt[..., 1:2] * o[1] + gt[..., 2:3] * o[2]
    out = out.reshape(B, G, Hkv, C, Gq, Dh).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(B, G * C, Hq, Dh)[:, :T]


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("C,mode,include_cmp,prefixes",
                         [(2, "exact", False, (3000,)),       # R = 8, refresh layer
                          (4, "approx", True, (2047, 40))])   # R = 16, reuse layer
def test_verify_arithmetic_matches_plain(Dh, C, mode, include_cmp, prefixes):
    """The emulated kernel (bf16 hi/lo tensor-core dots, split work list,
    chunk-order merge) against verify_groups_plain over a 4096-key cache;
    a 40-token prefix is shorter than one chunk."""
    x = _verify_inputs(Dh, prefixes, 4096, seed=Dh + C)
    a = _verify_args(x, C, mode)
    got = _emulate_verify(a, x["o_cmp"], include_cmp)
    want = vref.verify_groups_plain(
        **a, o_cmp_in=None if include_cmp else x["o_cmp"], sel_block=NSA.sel_block,
        cmp_block=NSA.cmp_block, cmp_stride=NSA.cmp_stride, window=NSA.window,
        include_cmp=include_cmp)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Hq,Hkv,C,mode,include_cmp",
                         [(48, 8, 4, "approx", True),     # mixtral approx C=4: 24 rows, 2 tiles
                          (48, 1, 2, "exact", False)],    # granite exact C=2: 96 rows, 6 tiles
                         ids=["rows24", "rows96"])
def test_verify_row_tiles_arithmetic_matches_plain(Hq, Hkv, C, mode, include_cmp):
    """Groups above 16 rows: each 16-row tile walks the group's whole work
    list as its own CTA and merges its own rows (Dh 128, a 2048-key
    cache, prefixes 1800 and 700: the merged blocks and the window each in
    more than one chunk)."""
    x = _verify_inputs(128, (1800, 700), 2048, seed=C + Hkv, Hq=Hq, Hkv=Hkv)
    a = _verify_args(x, C, mode)
    assert C * Hq // Hkv > 16
    got = _emulate_verify(a, x["o_cmp"], include_cmp)
    want = vref.verify_groups_plain(
        **a, o_cmp_in=None if include_cmp else x["o_cmp"], sel_block=NSA.sel_block,
        cmp_block=NSA.cmp_block, cmp_stride=NSA.cmp_stride, window=NSA.window,
        include_cmp=include_cmp)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Dh,Hq,Hkv,C,mode,include_cmp",
                         [(160, 32, 8, 2, "exact", False),     # pixtral: 8 rows
                          (192, 96, 8, 4, "approx", True),     # nemotron: 48 rows, 3 tiles
                          (256, 16, 1, 2, "exact", True)],     # recurrentgemma: 32 rows, 2 tiles
                         ids=["dh160", "dh192-gq12", "dh256-gq16"])
def test_verify_new_head_dims_arithmetic_matches_plain(Dh, Hq, Hkv, C, mode, include_cmp):
    """The emulated kernel at the head dims of pixtral, nemotron and
    recurrentgemma (their query-head groups too) against
    verify_groups_plain over a 1024-key cache (two merged-block chunks and
    two window chunks at 16+ rows), prefix 900."""
    x = _verify_inputs(Dh, (900,), 1024, seed=Dh, Hq=Hq, Hkv=Hkv)
    a = _verify_args(x, C, mode)
    got = _emulate_verify(a, x["o_cmp"], include_cmp)
    want = vref.verify_groups_plain(
        **a, o_cmp_in=None if include_cmp else x["o_cmp"], sel_block=NSA.sel_block,
        cmp_block=NSA.cmp_block, cmp_stride=NSA.cmp_stride, window=NSA.window,
        include_cmp=include_cmp)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _emulate_flash(q, kc, vc, kd, vd, pos, plen, tree, window):
    """The flash kernel's arithmetic: per (row, kv head, tile of 16 query
    rows) the cache in splits of ``split_keys(S)`` keys plus the draft split,
    each walked as a CTA, merged in split order."""
    B, T, Hq, Dh = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    Gq, R, KS = Hq // Hkv, T * Hq // Hkv, fops.split_keys(S)
    Rp = -(-R // 16) * 16                                        # row tiles of 16
    qr = q.reshape(B, T, Hkv, Gq, Dh).permute(0, 2, 1, 3, 4).reshape(B, Hkv, R, Dh)
    qr = torch.cat([qr, qr.new_zeros(B, Hkv, Rp - R, Dh)], 2).reshape(B * Hkv * (Rp // 16), 16, Dh)
    rpos = pos.long().repeat_interleave(Gq, dim=1)               # (B, R)
    rpos = torch.cat([rpos, rpos.new_zeros(B, Rp - R)], 1)
    valid = torch.arange(Rp) < R
    P = qr.shape[0]
    bi = torch.arange(B)[:, None, None].expand(B, Hkv, Rp // 16).reshape(P)
    hi = torch.arange(Hkv)[None, :, None].expand(B, Hkv, Rp // 16).reshape(P)
    ti = torch.arange(Rp // 16)[None, None].expand(B, Hkv, Rp // 16).reshape(P)
    rows = ti[:, None] * 16 + torch.arange(16)                   # (P, 16)
    rp = rpos[bi[:, None], rows]
    rv = valid[rows]
    parts = []
    for x in range(-(-S // KS)):
        keys = torch.arange(x * KS, min(x * KS + KS, S))
        k = kc[bi[:, None], keys[None], hi[:, None]].float()
        v = vc[bi[:, None], keys[None], hi[:, None]].float()
        m = (keys < plen.long()[bi][:, None, None]) & (keys <= rp[..., None]) & rv[..., None]
        if window > 0:
            m = m & (keys > rp[..., None] - window)
        parts.append(_walk(qr, *_pad(k, v, m)))
    dist = pos[:, :, None] - pos[:, None, :]
    dm = tree.bool() & (dist >= 0)
    if window > 0:
        dm = dm & (dist < window)
    dm = dm.repeat_interleave(Gq, dim=1)                         # (B, R, T)
    dm = torch.cat([dm, dm.new_zeros(B, Rp - R, T)], 1)[bi[:, None], rows]
    k = kd[bi[:, None], torch.arange(T)[None], hi[:, None]].float()
    v = vd[bi[:, None], torch.arange(T)[None], hi[:, None]].float()
    parts.append(_walk(qr, *_pad(k, v, dm)))
    out = _merge(parts).reshape(B, Hkv, Rp, Dh)[:, :, :R]
    return out.reshape(B, Hkv, T, Gq, Dh).permute(0, 2, 1, 3, 4).reshape(B, T, Hq, Dh)


@pytest.mark.parametrize("Dh,Hq,window", [(64, 8, 0), (128, 8, 0), (64, 8, 300)])
def test_flash_arithmetic_matches_plain(Dh, Hq, window):
    """The emulated flash kernel at the draft's shape (R = 31 rows, two
    tiles of 16) against ref_flash_verify over a 2048-key cache, two rows
    whose prefixes end mid-split and inside the first split."""
    g = torch.Generator().manual_seed(Dh + window)
    topo = build_topology(4, 2, "bfs")
    T, S, Hkv = topo.num_nodes, 2048, 8
    plen = torch.tensor([1234, 77], dtype=torch.int32)
    pos = (plen[:, None] + torch.as_tensor(topo.depths)[None]).to(torch.int32)
    tree = torch.as_tensor(topo.mask)[None].expand(2, T, T)
    r = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)
    args = (torch.randn((2, T, Hq, Dh), generator=g) / Dh ** 0.5, r(2, S, Hkv, Dh),
            r(2, S, Hkv, Dh), r(2, T, Hkv, Dh), r(2, T, Hkv, Dh), pos, plen, tree, window)
    torch.testing.assert_close(_emulate_flash(*args), fref.ref_flash_verify(*args),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("Dh,H", [(80, 3), (96, 2), (160, 8), (192, 24), (256, 4)],
                         ids=["smollm", "xlstm", "pixtral", "nemotron", "recurrentgemma"])
def test_flash_draft_head_dims_arithmetic_matches_plain(Dh, H):
    """The emulated flash kernel at the zoo drafts' head dims and heads
    (draft_config: as many kv heads as query heads) against
    ref_flash_verify over a 1024-key cache (two splits), prefixes 700 and
    77."""
    g = torch.Generator().manual_seed(Dh)
    topo = build_topology(4, 2, "bfs")
    T, S = topo.num_nodes, 1024
    plen = torch.tensor([700, 77], dtype=torch.int32)
    pos = (plen[:, None] + torch.as_tensor(topo.depths)[None]).to(torch.int32)
    tree = torch.as_tensor(topo.mask)[None].expand(2, T, T)
    r = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)
    args = (torch.randn((2, T, H, Dh), generator=g) / Dh ** 0.5, r(2, S, H, Dh),
            r(2, S, H, Dh), r(2, T, H, Dh), r(2, T, H, Dh), pos, plen, tree, 0)
    assert Dh in fops.HEAD_DIMS
    torch.testing.assert_close(_emulate_flash(*args), fref.ref_flash_verify(*args),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("M,NCB,W,T,sel_block,include_cmp,branch,rows",
                         [(32, 511, 512, 31, 64, False, "all", 8),    # exact C=2 refresh
                          (16, 511, 512, 31, 64, True, "all", 16),    # approx C=4 reuse
                          (13, 0, 0, 7, 16, True, "all", 8),          # empty cmp and window
                          (45, 100, 32, 7, 16, False, "slc", 4),      # M padded past a chunk
                          (16, 60, 700, 31, 64, False, "win", 4),
                          (32, 33280, 512, 31, 64, True, "all", 8),   # 524,800 tokens
                          (16, 33280, 512, 31, 64, True, "all", 16)])
def test_split_plan_covers_the_work_list_once(M, NCB, W, T, sel_block, include_cmp,
                                              branch, rows):
    """Every cmp block, merged slot, window key and draft token of a
    computed branch lies in exactly one chunk, chunks stay within the
    kernel's limits, and the plan depends on shapes only."""
    chunks = _chunks(M, NCB, W, T, sel_block, include_cmp, branch, rows)
    plan = vops.split_plan(M, NCB, W, sel_block, include_cmp, branch, rows)
    assert len(chunks) == sum(plan[:3]) <= vops.MAX_CHUNKS
    assert plan[4] <= vops.MAX_BLOCKS_PER_CHUNK
    assert [br for br, _ in chunks] == sorted(br for br, _ in chunks)
    seen = {0: [], 1: [], 2: []}
    for br, items in chunks:
        seen[br] += items
    want = {0: list(range(NCB)) if include_cmp else [],
            1: list(range(M)) if branch != "win" else [],
            2: ([("w", k) for k in range(W)] + [("d", d) for d in range(T)]
                if branch != "slc" else [])}
    assert seen == want
    # a computed branch has a chunk even when its list is empty
    for br, computed in ((0, include_cmp), (1, branch != "win"), (2, branch != "slc")):
        assert any(b == br for b, _ in chunks) == computed


def _emulate_routing(q, k_cmp, v_cmp, pos, ncb_valid, kv_len):
    """The routing kernel's arithmetic: per (row, query group, kv head,
    head slab) a CTA of Q queries x up to 16 heads (``rops.query_groups``;
    above 16 heads a query's heads are cut into slabs) walks each chunk of
    ``rops.routing_plan`` with the hook keeping its raw logits; the chunk's
    scores sum_n exp(s - m) ov(n, j) / cmp_block of its visible blocks
    cover ``span`` selection blocks from its first; the last CTA, slab by
    slab, scales o_cmp's partials and each chunk's scores by exp(m_x - M) /
    L, sums chunks, then the slab's rows of each query, and adds the slab's
    sum to the earlier slabs'."""
    B, T, Hq, Dh = q.shape
    NCB, Hkv = k_cmp.shape[1], k_cmp.shape[2]
    Gq, RT = Hq // Hkv, rops.ROWS_PER_CTA
    Q, G, HS = rops.query_groups(T, Gq)
    gs = min(Gq, RT)
    n_cmp, keys, span = rops.routing_plan(NCB, NSA)
    NSB = nsa_lib.num_sel_blocks(kv_len, NSA)
    ov = nsa_lib.overlap_tensor(n_cmp * keys, NSB, NSA, "cpu")   # (blocks, NSB)
    P = B * G * Hkv
    o_out = torch.zeros(B, T, Hq, Dh)
    p_out = torch.zeros(B, G * Q, Hkv, NSB)
    nv = ncb_valid.reshape(-1).long().expand(B)[:, None, None].expand(B, G, Hkv)
    nv = nv.reshape(P)[:, None, None]
    kk = k_cmp.permute(0, 2, 1, 3)[:, None].expand(B, G, Hkv, NCB, Dh).reshape(P, NCB, Dh)
    vv = v_cmp.permute(0, 2, 1, 3)[:, None].expand(B, G, Hkv, NCB, Dh).reshape(P, NCB, Dh)
    for sl in range(HS):
        nh = min(gs, Gq - sl * gs)                                  # heads of this slab
        r = torch.arange(RT)
        t = torch.arange(G)[:, None] * Q + r // nh                  # (G, RT) query of row r
        real = (r < Q * nh) & (t < T)
        tc = t.clamp(max=T - 1)
        head = torch.arange(Hkv)[:, None] * Gq + sl * gs + r % nh   # (Hkv, RT)
        qr = q[:, tc[None, :, :], head[:, None, :]]                 # (B, Hkv, G, RT, Dh)
        qr = (qr.permute(0, 2, 1, 3, 4) * real[None, :, None, :, None]).reshape(P, RT, Dh)
        rpos = pos.long()[:, tc].reshape(B, G, 1, RT).expand(B, G, Hkv, RT).reshape(P, RT)
        rreal = real[None, :, None].expand(B, G, Hkv, RT).reshape(P, RT)
        parts, scores = [], []
        for x in range(n_cmp):
            n = torch.arange(x * keys, min(x * keys + keys, NCB))
            mask = ((n < nv) & (n * NSA.cmp_stride + NSA.cmp_block - 1 <= rpos[..., None]) &
                    rreal[..., None])
            units = []
            part = _walk(qr, *_pad(kk[:, n].float(), vv[:, n].float(), mask), logits=units)
            s = torch.cat(units, 2)[:, :, :len(n)]
            live = part[1] > 0
            e = torch.where(mask & live[..., None], torch.exp(s - part[0][..., None]),
                            torch.zeros(()))
            sc = e @ ov[n]                                          # (P, RT, NSB)
            j0 = x * keys * NSA.cmp_stride // NSA.sel_block
            outside = torch.ones(NSB, dtype=torch.bool)
            outside[j0:j0 + span] = False
            assert not sc[..., outside].any()                       # span covers the chunk
            parts.append(part)
            scores.append(sc)
        scale = _scales(parts)                                      # (n_cmp, P, RT)
        o = sum(scale[i][..., None] * parts[i][2] for i in range(n_cmp))
        p_row = sum(scale[i][..., None] * scores[i] for i in range(n_cmp))
        o = o.reshape(B, G, Hkv, RT, Dh)
        m = real[None, :, None, :].expand(B, G, Hkv, RT)
        bi = torch.arange(B)[:, None, None, None].expand_as(m)
        o_out[bi[m], tc[None, :, None, :].expand_as(m)[m],
              head[None, None].expand_as(m)[m]] = o[m]
        p = p_row.reshape(B, G, Hkv, RT, NSB)[:, :, :, :Q * nh].reshape(B, G, Hkv, Q, nh, NSB)
        p_out += p.sum(4).permute(0, 1, 3, 2, 4).reshape(B, G * Q, Hkv, NSB)
    return o_out, p_out[:, :T]


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("prefixes", [(4096,), (4096, 3001)])
def test_routing_arithmetic_matches_plain(Dh, prefixes):
    """The emulated routing kernel (16-row CTAs of 4 queries x 4 heads,
    bf16 hi/lo tensor-core dots, 16-block units dealt to 4 warps, the
    chunk-order merge, scores rescaled by the merge scales) against
    ref_routing at full width (Hq 32, Hkv 8, T 31, an 8192-token cache),
    per-row ncb_valid; Top-n picks the same blocks from both."""
    x = _verify_inputs(Dh, prefixes, 8192, seed=Dh + len(prefixes))
    k_cmp = torch.cat([x["k_cmp"], x["k_cmp"][:, :1]], 1)          # padded to 512 blocks
    v_cmp = torch.cat([x["v_cmp"], x["v_cmp"][:, :1]], 1)
    nv = x["ncb_valid"].reshape(-1)
    got_o, got_p = _emulate_routing(x["q"], k_cmp, v_cmp, x["pos"], nv, 8192)
    M = nsa_lib.overlap_tensor(k_cmp.shape[1], nsa_lib.num_sel_blocks(8192, NSA), NSA, "cpu")
    want_o, want_p = rref.ref_routing(x["q"], k_cmp, v_cmp, M, x["pos"], nv,
                                      cmp_block=NSA.cmp_block, cmp_stride=NSA.cmp_stride)
    torch.testing.assert_close(got_o, want_o, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got_p, want_p, rtol=RTOL, atol=ATOL)
    for a, b in zip(nsa_lib.select_topn(got_p, x["pos"], x["plen"], NSA),
                    nsa_lib.select_topn(want_p, x["pos"], x["plen"], NSA)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Dh,Hq,Hkv", [(64, 64, 4), (128, 48, 1)], ids=["gq16", "gq48"])
def test_routing_head_slabs_arithmetic_matches_plain(Dh, Hq, Hkv):
    """The emulated routing kernel at qwen3-moe's Gq 16 (one query per CTA)
    and granite's Gq 48 (three 16-head slabs per query, their GQA sums
    added slab by slab) against ref_routing over a 4096-token cache (two
    chunks), two rows; Top-n picks the same blocks from both."""
    x = _verify_inputs(Dh, (3500, 2001), 4096, seed=Hq, Hq=Hq, Hkv=Hkv)
    k_cmp = torch.cat([x["k_cmp"], x["k_cmp"][:, :1]], 1)          # padded to 256 blocks
    v_cmp = torch.cat([x["v_cmp"], x["v_cmp"][:, :1]], 1)
    nv = x["ncb_valid"].reshape(-1)
    assert rops.query_groups(31, Hq // Hkv)[2] == (3 if Hq // Hkv == 48 else 1)
    assert rops.routing_plan(k_cmp.shape[1], NSA)[0] == 2
    got_o, got_p = _emulate_routing(x["q"], k_cmp, v_cmp, x["pos"], nv, 4096)
    M = nsa_lib.overlap_tensor(k_cmp.shape[1], nsa_lib.num_sel_blocks(4096, NSA), NSA, "cpu")
    want_o, want_p = rref.ref_routing(x["q"], k_cmp, v_cmp, M, x["pos"], nv,
                                      cmp_block=NSA.cmp_block, cmp_stride=NSA.cmp_stride)
    torch.testing.assert_close(got_o, want_o, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got_p, want_p, rtol=RTOL, atol=ATOL)
    for a, b in zip(nsa_lib.select_topn(got_p, x["pos"], x["plen"], NSA),
                    nsa_lib.select_topn(want_p, x["pos"], x["plen"], NSA)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Dh,Hq,Hkv", [(160, 32, 8), (192, 96, 8), (256, 16, 1)],
                         ids=["dh160", "dh192-gq12", "dh256-gq16"])
def test_routing_new_head_dims_arithmetic_matches_plain(Dh, Hq, Hkv):
    """The emulated routing kernel at the head dims (and query-head groups)
    of pixtral, nemotron and recurrentgemma against ref_routing over a
    4096-token cache (two chunks), one row; Top-n picks the same blocks."""
    x = _verify_inputs(Dh, (3000,), 4096, seed=Dh, Hq=Hq, Hkv=Hkv)
    nv = x["ncb_valid"].reshape(-1)
    k_cmp = torch.cat([x["k_cmp"], x["k_cmp"][:, :1]], 1)          # padded to 256 blocks
    v_cmp = torch.cat([x["v_cmp"], x["v_cmp"][:, :1]], 1)
    assert rops.routing_plan(k_cmp.shape[1], NSA)[0] == 2 and Dh in rops.HEAD_DIMS
    got_o, got_p = _emulate_routing(x["q"], k_cmp, v_cmp, x["pos"], nv, 4096)
    M = nsa_lib.overlap_tensor(k_cmp.shape[1], nsa_lib.num_sel_blocks(4096, NSA), NSA, "cpu")
    want_o, want_p = rref.ref_routing(x["q"], k_cmp, v_cmp, M, x["pos"], nv,
                                      cmp_block=NSA.cmp_block, cmp_stride=NSA.cmp_stride)
    torch.testing.assert_close(got_o, want_o, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got_p, want_p, rtol=RTOL, atol=ATOL)
    for a, b in zip(nsa_lib.select_topn(got_p, x["pos"], x["plen"], NSA),
                    nsa_lib.select_topn(want_p, x["pos"], x["plen"], NSA)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("NCB", [1, 8, 100, 512, 4096, 32768, 33280])
def test_routing_plan_covers_the_cmp_list_once(NCB):
    """The chunks of ``routing_plan`` cover the cmp blocks once, within the
    kernel's limits (16-block units, at most MAX_KEYS blocks and
    MAX_CHUNKS chunks), and ``span`` holds every selection block a chunk
    overlaps; query groups hold at most 16 rows (a query's heads cut into
    16-head slabs above 16 heads) and cover T once. At
    max_context 65536 (4096 blocks) the scratch of B=4 rows stays below
    nsa_verify's part_acc (exact C=2, full fusion) at the same shapes."""
    n_cmp, keys, span = rops.routing_plan(NCB, NSA)
    assert keys % 16 == 0 and 16 <= keys <= rops.MAX_KEYS and n_cmp <= rops.MAX_CHUNKS
    # the last CTA's merge table (m and l per chunk and row) fits the
    # smallest instance's ring scratch (bf16, Dh 64: 9,216 floats)
    assert 2 * rops.MAX_CHUNKS * 16 <= SCRATCH_MIN and 2 * vops.MAX_CHUNKS * 16 <= SCRATCH_MIN
    chunks = [range(x * keys, min(x * keys + keys, NCB)) for x in range(n_cmp)]
    assert [n for c in chunks for n in c] == list(range(NCB))
    for x, c in enumerate(chunks):
        if len(c):
            j0 = x * keys * NSA.cmp_stride // NSA.sel_block
            j1 = ((c[-1]) * NSA.cmp_stride + NSA.cmp_block - 1) // NSA.sel_block
            assert j1 - j0 + 1 <= span
    for Gq in (*range(1, 17), 24, 48, 96):
        for T in (1, 7, 31):
            Q, G, HS = rops.query_groups(T, Gq)
            assert Q * min(Gq, 16) <= rops.ROWS_PER_CTA and (G - 1) * Q < T <= G * Q
            assert HS * 16 >= Gq > (HS - 1) * 16 and (HS == 1 or Q == 1)
    if NCB == 4096:
        G_r = rops.query_groups(31, 4)[1]
        routing = G_r * n_cmp * 16 * (2 + 64 + span)
        nx = sum(vops.split_plan(32, NCB, 512, NSA.sel_block, True, "all", 8)[:3])
        assert routing <= 16 * nx * 16 * 64


@pytest.mark.parametrize("S", [1, 512, 8192, 33280, 130560, 131072, 524800, 2 ** 21])
def test_flash_splits_cover_the_cache_within_the_merge_table(S):
    """Flash cuts the cache into splits of ``split_keys(S)`` keys (512 up
    to 255 splits, then more per split, in 16-key units): the splits cover
    S once, and the last CTA's merge table, 2 x (splits + 1) x 16 floats,
    fits the smallest instance's ring scratch, as the kernel requires."""
    KS = fops.split_keys(S)
    NS = -(-S // KS)
    assert KS % 16 == 0 and NS <= fops.MAX_SPLITS and (NS - 1) * KS < S <= NS * KS
    assert 2 * (NS + 1) * 16 <= SCRATCH_MIN
    if S <= fops.KEYS_PER_SPLIT * fops.MAX_SPLITS:
        assert KS == fops.KEYS_PER_SPLIT


def test_flash_emulation_with_grown_splits(monkeypatch):
    """The kernel's arithmetic with splits grown past 512 keys (a cap of 3
    splits stands for 255): equal to the plain version."""
    monkeypatch.setattr(fops, "MAX_SPLITS", 3)
    topo = build_topology(3, 2, "bfs")
    g = torch.Generator()
    g.manual_seed(7)
    T, S, Hq, Hkv, Dh = topo.num_nodes, 2000, 4, 2, 64
    assert fops.split_keys(S) == 672
    q = torch.randn(1, T, Hq, Dh, generator=g) / Dh ** 0.5
    kc, vc, kd, vd = (torch.randn(1, n, Hkv, Dh, generator=g).to(torch.bfloat16)
                      for n in (S, S, T, T))
    pos = (torch.as_tensor(topo.depths)[None] + 1900).to(torch.int32)
    plen = torch.tensor([1900], dtype=torch.int32)
    tree = torch.as_tensor(topo.mask)[None]
    got = _emulate_flash(q, kc, vc, kd, vd, pos, plen, tree, 0)
    want = fref.ref_flash_verify(q, kc, vc, kd, vd, pos, plen, tree)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
