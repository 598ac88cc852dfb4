"""Wrappers around the fused NSA verification kernel (``csrc/nsa_verify.cu``)
— the counterparts of ``repro.kernels.nsa_verify.ops``.

``nsa_verify_fused`` takes model-level tensors plus the grouping strategy,
builds the merged-schedule (exact) or shared-index (approx) layouts and
ownership masks in PyTorch, and calls ``verify_groups``: CUDA tensors
launch the kernel (or raise), CPU tensors run the plain version in
``ref.py``. ``nsa_verify_kernel_layer`` is one NSA layer's verify through
the kernels: refresh layers run the routing kernel, Top-n selection and the
partially fused kernel; reuse layers run the fully fused kernel on
inherited indices. ``nsa_verify_vanilla_layer`` is the branch-wise vanilla
baseline: the routing kernel, Top-n, then two launches of the same kernel
that each write one ungated branch (slc, then win + draft), and the gated
combine in PyTorch. Under the paged KV store (``page_table`` given, or a
paged ``KVView``) the kernel reads K/V from the shared page pool through the
page table; the merged schedule stays logical and a merged block whose page
is unmapped is masked (``mvalid`` cleared), never clamped, as the JAX prep
(``ops.py:141-146``) does. Paged launches count under ``nsa_verify_paged``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.config import NSAConfig
from repro_torch.core import kvstore, overlap
from repro_torch.kernels import LaunchCounter, build, per_row
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.nsa_verify import ref
from repro_torch.kernels.routing import ops as routing_ops

FULL_LAUNCHES = LaunchCounter("nsa_verify_full")
PARTIAL_LAUNCHES = LaunchCounter("nsa_verify_partial")
VANILLA_LAUNCHES = LaunchCounter("nsa_verify_vanilla")
PAGED_LAUNCHES = LaunchCounter("nsa_verify_paged")
HEAD_DIMS = (64, 128, 160, 192, 256)   # csrc/nsa_verify.cu HEAD_DIMS
ROWS_PER_CTA = 16           # RT in the kernel: query rows per CTA (one row tile)
BRANCHES = {"all": 0, "slc": 1, "win": 2}   # the kernel's ``branch`` flag
KEYS_PER_CHUNK = 512        # keys per CTA at up to 8 rows (256 above: twice the dots)
MAX_BLOCKS_PER_CHUNK = 32   # MBMAX in the kernel
MAX_CHUNKS = 256            # NXMAX in the kernel (136 in full fusion at 524,800 tokens)


def split_plan(M: int, NCB: int, W: int, sel_block: int, include_cmp: bool,
               branch: str = "all", rows: int = 8):
    """The kernel's split of one (row, group, kv head) work list across
    CTAs, from shapes only: (n_cmp, n_slc, n_win, keys, blocks). The cmp
    list (NCB blocks) and the window (W keys) go in chunks of ``keys``
    (``KEYS_PER_CHUNK``, halved when the group has more than 8 query rows
    ``rows`` = C * Gq), the M merged blocks in chunks of ``blocks`` (about
    ``keys`` tokens); the draft tokens join the last window chunk. A
    branch that is computed has at least one chunk, possibly empty. Above
    16 rows each ``row_tiles`` tile of 16 walks these chunks."""
    keys = KEYS_PER_CHUNK if rows <= 8 else KEYS_PER_CHUNK // 2
    blocks = min(MAX_BLOCKS_PER_CHUNK, max(1, keys // sel_block))
    n_cmp = max(1, -(-NCB // keys)) if include_cmp else 0
    n_slc = max(1, -(-M // blocks)) if branch != "win" else 0
    n_win = max(1, -(-W // keys)) if branch != "slc" else 0
    return n_cmp, n_slc, n_win, keys, blocks


def row_tiles(C: int, Gq: int) -> int:
    """Row tiles of a group's C * Gq query rows (query c, head i at row
    c * Gq + i): one CTA per (row tile, chunk), each tile merged under its
    own ticket. Every tile walks the group's whole work list, so above 16
    rows the K/V of a chunk is read once per tile."""
    return -(-C * Gq // ROWS_PER_CTA)


@functools.lru_cache(maxsize=256)
def _qmap_i32(T: int, C: int, device: str):
    qmap, _ = overlap.group_queries(T, C)
    return torch.as_tensor(np.array(qmap), dtype=torch.int32, device=device)


def group_layouts(sel_idx, sel_valid, positions, C: int, mode: str):
    """-> (merged (B,G,Hkv,M) int32 with -1 for none, mvalid int32,
    own (B,G,Hkv,C,M) int32, qmap (G,C) int32)."""
    B, T, Hkv, n = sel_idx.shape
    qmap = _qmap_i32(T, C, str(sel_idx.device))
    if mode == "approx":
        idx2, val2 = overlap.shared_index(sel_idx, sel_valid, positions, C)
        first = qmap[:, 0].long()
        mvalid = val2[:, first]                                      # (B,G,Hkv,n)
        merged = torch.where(mvalid, idx2[:, first].to(torch.int32),
                             torch.full((), -1, dtype=torch.int32, device=sel_idx.device))
        own = torch.ones((B, qmap.shape[0], Hkv, C, n), dtype=torch.int32,
                         device=sel_idx.device)
        return merged, mvalid.to(torch.int32), own, qmap
    merged, own, mvalid = overlap.merged_schedule(sel_idx, sel_valid, C)
    merged = torch.where(mvalid, merged, torch.full_like(merged, -1))
    return merged, mvalid.to(torch.int32), own.to(torch.int32), qmap


def mask_unmapped_blocks(merged, mvalid, page_table, page_size: int, num_pages: int,
                         sel_block: int):
    """Clear ``mvalid`` of the merged (logical) blocks whose page is
    unmapped or past the pool, so they are masked, never clamped (the JAX
    paged prep, ``ops.py:141-146``). Returns (merged with -1 for the
    cleared blocks, mvalid)."""
    B, MP = page_table.shape
    lp = torch.div(merged.clamp_min(0).long() * sel_block, page_size,
                   rounding_mode="floor").clamp(0, MP - 1)
    phys = torch.gather(page_table.long(), 1, lp.reshape(B, -1)).reshape(lp.shape)
    mapped = (merged >= 0) & (phys >= 0) & (phys < num_pages)
    mvalid = torch.where(mapped, mvalid, torch.zeros_like(mvalid))
    return torch.where(mvalid > 0, merged, torch.full_like(merged, -1)), mvalid


def prepare_groups(q, gates, sel_idx, sel_valid, positions, C: int, mode: str):
    """The JAX ``prepare_groups`` layout: (q_grp (B,G,Hkv,R,Dh), gates_grp
    (B,G,Hkv,R,3), merged, mvalid, own, pos_grp (B,G,C), qmap). The kernel
    reads q and gates through ``qmap`` directly; this form is for callers
    that want the grouped tensors."""
    B, T, Hq, Dh = q.shape
    Hkv = sel_idx.shape[2]
    Gq = Hq // Hkv
    merged, mvalid, own, qmap = group_layouts(sel_idx, sel_valid, positions, C, mode)
    gi = qmap.long()
    G = gi.shape[0]
    q_grp = q.reshape(B, T, Hkv, Gq, Dh)[:, gi].permute(0, 1, 3, 2, 4, 5) \
        .reshape(B, G, Hkv, C * Gq, Dh)
    g_grp = gates.permute(0, 1, 3, 2).reshape(B, T, Hkv, Gq, 3)[:, gi] \
        .permute(0, 1, 3, 2, 4, 5).reshape(B, G, Hkv, C * Gq, 3)
    return q_grp, g_grp, merged, mvalid, own, positions[:, gi], qmap


def _lib():
    fn = build.library("nsa_verify").nsa_verify_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def verify_groups(q, k_cache, v_cache, k_cmp, v_cmp, k_draft, v_draft, merged,
                  mvalid, own, qmap, positions, prefix_len, ncb_valid,
                  win_start, dmask, gates, o_cmp_in, *, nsa: NSAConfig,
                  include_cmp: bool, branch: str = "all", page_table=None):
    """The kernel boundary. Shapes as in ``ref.verify_groups_plain``;
    prefix_len / ncb_valid / win_start are (B,) int32 device tensors.
    ``branch`` "slc" / "win" writes that one branch ungated (vanilla; needs
    include_cmp=False). ``page_table`` (B, max_pages) int32 makes k/v_cache
    the shared pool (P, page_size, Hkv, Dh). Returns (B,T,Hq,Dh) f32."""
    geo = dict(sel_block=nsa.sel_block, cmp_block=nsa.cmp_block,
               cmp_stride=nsa.cmp_stride, window=nsa.window)
    if q.device.type == "cpu":
        return ref.verify_groups_plain(
            q, k_cache, v_cache, k_cmp, v_cmp, k_draft, v_draft, merged,
            mvalid, own, qmap, positions, prefix_len, ncb_valid, win_start,
            dmask, gates, o_cmp_in, include_cmp=include_cmp, branch=branch,
            page_table=page_table, **geo)
    if q.device.type != "cuda":
        raise ValueError(f"verify_groups: unsupported device {q.device}")
    return launch(q, k_cache, v_cache, k_cmp, v_cmp, k_draft, v_draft, merged,
                  mvalid, own, qmap, positions, prefix_len, ncb_valid,
                  win_start, dmask, gates, o_cmp_in, nsa=nsa,
                  include_cmp=include_cmp, branch=branch, page_table=page_table)


def launch(q, k_cache, v_cache, k_cmp, v_cmp, k_draft, v_draft, merged, mvalid,
           own, qmap, positions, prefix_len, ncb_valid, win_start, dmask,
           gates, o_cmp_in, *, nsa: NSAConfig, include_cmp: bool,
           branch: str = "all", page_table=None):
    """Launch the CUDA kernel (CUDA tensors only); checks every input. The
    paged pool is shared: it is never copied per row. The CTAs of one
    (row, group, kv head) merge their partials through a ticket that each
    call leaves at 0, in a buffer per device and stream (shared with the
    flash kernel: calls on one stream never overlap)."""
    B, T, Hq, Dh = q.shape
    Hkv = k_cache.shape[2]
    paged = page_table is not None
    if paged:
        P, ps = k_cache.shape[0], k_cache.shape[1]
        MP = page_table.shape[1] if page_table.dim() == 2 else -1
        if ps % nsa.sel_block:
            raise ValueError(f"page size {ps} must be a multiple of sel_block {nsa.sel_block}")
        S = MP * ps
        kv_shape = (P, ps, Hkv, Dh)
    else:
        S = k_cache.shape[1]
        kv_shape = (B, S, Hkv, Dh)
    G, C = qmap.shape
    M = merged.shape[-1]
    NCB = k_cmp.shape[1]
    dev = q.device
    if Dh not in HEAD_DIMS:
        raise ValueError(f"nsa_verify kernel is built for head_dim in {HEAD_DIMS}, got {Dh}")
    if branch not in BRANCHES or (branch != "all" and include_cmp):
        raise ValueError(f"branch {branch!r}: one of {tuple(BRANCHES)}; a single "
                         "branch runs without the cmp branch (include_cmp=False)")
    if Hkv < 1 or Hq % Hkv or C < 1:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32 (pre-scaled), got {q.dtype}")
    kv_t = k_cache.dtype
    if kv_t not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K/V must be float32 or bfloat16, got {kv_t}")
    shapes = {"k_cache": (k_cache, kv_shape, kv_t),
              "v_cache": (v_cache, kv_shape, kv_t),
              "k_cmp": (k_cmp, (B, NCB, Hkv, Dh), kv_t),
              "v_cmp": (v_cmp, (B, NCB, Hkv, Dh), kv_t),
              "k_draft": (k_draft, (B, T, Hkv, Dh), kv_t),
              "v_draft": (v_draft, (B, T, Hkv, Dh), kv_t),
              "merged": (merged, (B, G, Hkv, M), torch.int32),
              "mvalid": (mvalid, (B, G, Hkv, M), torch.int32),
              "own": (own, (B, G, Hkv, C, M), torch.int32),
              "qmap": (qmap, (G, C), torch.int32),
              "positions": (positions, (B, T), torch.int32),
              "prefix_len": (prefix_len, (B,), torch.int32),
              "ncb_valid": (ncb_valid, (B,), torch.int32),
              "win_start": (win_start, (B,), torch.int32),
              "dmask": (dmask, (B, T, T), torch.int32),
              "gates": (gates, (B, T, 3, Hq), torch.float32)}
    if paged:
        shapes["page_table"] = (page_table, (B, MP), torch.int32)
    if not include_cmp and branch == "all":
        if o_cmp_in is None:
            raise ValueError("partial fusion (include_cmp=False) needs o_cmp_in")
        shapes["o_cmp_in"] = (o_cmp_in, (B, T, Hq, Dh), torch.float32)
    for name, (t, shape, dt) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dt}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name in ("k_cache", "v_cache", "k_cmp", "v_cmp", "k_draft", "v_draft", "o_cmp_in"):
        if name in shapes and shapes[name][0].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte K/V loads)")
        if name in shapes and shapes[name][0].numel() >= 2 ** 31:
            raise ValueError(f"{name} must hold fewer than 2^31 elements (32-bit offsets)")
    plan = split_plan(M, NCB, min(nsa.window, S), nsa.sel_block, include_cmp, branch,
                      C * (Hq // Hkv))
    NX = sum(plan[:3])
    if NX > MAX_CHUNKS:
        raise ValueError(f"nsa_verify kernel splits a work list into at most {MAX_CHUNKS} "
                         f"chunks, these shapes need {NX}")
    NRT = row_tiles(C, Hq // Hkv)
    slabs = B * G * Hkv * NRT * NX * ROWS_PER_CTA
    part_ml = torch.empty(slabs * 2, dtype=torch.float32, device=dev)
    part_acc = torch.empty(slabs * Dh, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = flash_ops._ticket_buffer(B * G * Hkv * NRT, dev, stream)
    out = torch.empty((B, T, Hq, Dh), dtype=torch.float32, device=dev)
    tensors = [q, k_cache, v_cache, k_cmp, v_cmp, k_draft, v_draft, merged,
               mvalid, own, qmap, positions, prefix_len, ncb_valid, win_start,
               dmask, gates]
    ptrs = [t.data_ptr() for t in tensors]
    has_cmp_in = not include_cmp and branch == "all"
    ptrs += [o_cmp_in.data_ptr() if has_cmp_in else None, out.data_ptr(),
             page_table.data_ptr() if paged else None, part_ml.data_ptr(),
             part_acc.data_ptr(), tickets.data_ptr()]
    ints = [B, T, S, Hkv, Hq // Hkv, C, G, M, NCB, min(nsa.window, S),
            nsa.sel_block, nsa.cmp_block, nsa.cmp_stride, nsa.window,
            int(include_cmp), BRANCHES[branch], Dh,
            ps if paged else 0, MP if paged else 0, P if paged else 0, *plan, NRT]
    err = _lib()((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
                 0 if kv_t == torch.float32 else 1, stream)
    if err != 0:
        raise RuntimeError(f"nsa_verify kernel launch failed: cudaError {err}")
    if paged:
        PAGED_LAUNCHES.add()
    elif branch != "all":
        VANILLA_LAUNCHES.add()
    else:
        (FULL_LAUNCHES if include_cmp else PARTIAL_LAUNCHES).add()
    return out


def nsa_verify_fused(q, k_cache, v_cache, k_cmp, v_cmp, k_draft, v_draft,
                     sel_idx, sel_valid, positions, prefix_len, ncb_valid,
                     tree_mask, gates, nsa: NSAConfig, C: int = 2,
                     mode: str = "exact", include_cmp: bool = True,
                     o_cmp_in=None, branch: str = "all", page_table=None):
    """Fused grouped-query NSA verification.

    q (B,T,Hq,Dh) ALREADY rope'd and scaled by 1/sqrt(Dh); prefix_len and
    ncb_valid are ints or device tensors (0-d or (B,)). ``branch`` "slc" or
    "win" computes that branch alone, ungated (the JAX ``combine=False``
    with ``include_sel`` / ``include_win``). ``page_table`` (B, max_pages)
    int32 switches k/v_cache to the shared page pool (P, page_size, Hkv,
    Dh): ``merged`` stays logical and blocks on unmapped pages are masked.
    Returns (B,T,Hq,Dh) f32."""
    B, T, Hq, Dh = q.shape
    dev = q.device
    merged, mvalid, own, qmap = group_layouts(sel_idx, sel_valid, positions, C, mode)
    if page_table is None:
        S = k_cache.shape[1]
    else:
        P, ps = k_cache.shape[0], k_cache.shape[1]
        if page_table.dim() != 2 or page_table.shape[0] != B:
            raise ValueError(f"page_table has shape {tuple(page_table.shape)}, "
                             f"expected ({B}, max_pages)")
        S = page_table.shape[1] * ps
        page_table = page_table.to(torch.int32).contiguous()
        merged, mvalid = mask_unmapped_blocks(merged, mvalid, page_table, ps, P,
                                              nsa.sel_block)
    W = min(nsa.window, S)
    plen = per_row(prefix_len, B, dev)
    win_start = (plen - W).clamp(0, max(S - W, 0)).to(torch.int32)
    dist = positions[:, :, None] - positions[:, None, :]
    dmask = tree_mask & (dist < nsa.window) & (dist >= 0)
    if dev.type == "cuda":
        dmask = dmask.to(torch.int32)
        positions = positions.to(torch.int32).contiguous()
        gates = gates.float().contiguous()
        q = q.float().contiguous()
        if o_cmp_in is not None:
            o_cmp_in = o_cmp_in.float().contiguous()
    return verify_groups(q, k_cache, v_cache, k_cmp, v_cmp, k_draft.contiguous(),
                         v_draft.contiguous(), merged.contiguous(),
                         mvalid.contiguous(), own.contiguous(), qmap, positions,
                         plen, per_row(ncb_valid, B, dev), win_start, dmask,
                         gates, o_cmp_in, nsa=nsa, include_cmp=include_cmp,
                         branch=branch, page_table=page_table)


def _layer_inputs(params, cfg, x, prefix_len, positions):
    """What every NSA verify layer starts from: qkv, the pre-scaled q
    (1/sqrt(Dh)), the gates and the device lengths."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import nsa as nsa_lib

    q, k_new, v_new = attn_lib.qkv(params, cfg, x, positions)
    q_s = (q / math.sqrt(cfg.head_dim)).float().contiguous()
    g_all = nsa_lib.gates(params, x, cfg.num_heads)
    plen = torch.as_tensor(prefix_len, device=x.device)
    return q_s, k_new, v_new, g_all, plen, nsa_lib.dyn_num_cmp_blocks(plen, cfg.nsa)


def _route(q_s, cmp_cache, positions, plen, ncb_valid, nsa, kv_len):
    """Routing kernel -> (o_cmp, fresh Top-n sel_idx, sel_valid)."""
    from repro_torch.models import nsa as nsa_lib

    o_cmp, p_slc = routing_ops.routing_fused(q_s, cmp_cache["k_cmp"], cmp_cache["v_cmp"],
                                             positions, ncb_valid, nsa, kv_len=kv_len)
    return (o_cmp,) + tuple(nsa_lib.select_topn(p_slc, positions, plen, nsa))


def nsa_verify_kernel_layer(params, cfg, x, cache, cmp_cache, prefix_len,
                            positions, tree_mask, sel_idx=None, sel_valid=None,
                            C: int = 2, mode: str = "exact", reuse: bool = False,
                            page_table=None):
    """One NSA layer's tree verification through the kernels.

    reuse=False (refresh layer): routing kernel on the pre-scaled q ->
      Top-n -> (approx, C > 1: shared index, so the carried indices are the
      ones the JAX model path carries) -> partially fused verify kernel.
    reuse=True: inherited ``sel_idx`` -> fully fused verify kernel.
    ``cache`` is a ``{"k", "v"}`` dict (dense, or the pool with
    ``page_table``) or a ``kvstore.KVView``; the routing ``kv_len`` is the
    view's logical capacity (max_pages * page_size when paged).
    Returns (out (B,T,D), (k_new, v_new), (sel_idx, sel_valid)).
    """
    kv = kvstore.as_view(cache, page_table)
    nsa = cfg.nsa
    B, T, _ = x.shape
    q_s, k_new, v_new, g_all, plen, ncb_valid = _layer_inputs(params, cfg, x, prefix_len,
                                                              positions)
    common = (q_s, kv.k, kv.v, cmp_cache["k_cmp"], cmp_cache["v_cmp"], k_new, v_new)
    if reuse:
        if sel_idx is None:
            raise ValueError("reuse layers inherit indices: pass sel_idx")
        out = nsa_verify_fused(*common, sel_idx, sel_valid, positions, plen, ncb_valid,
                               tree_mask, g_all, nsa, C=C, mode=mode, include_cmp=True,
                               page_table=kv.pages)
    else:
        o_cmp, sel_idx, sel_valid = _route(q_s, cmp_cache, positions, plen, ncb_valid,
                                           nsa, kv.max_len)
        if mode == "approx" and C > 1:
            sel_idx, sel_valid = overlap.shared_index(sel_idx, sel_valid, positions, C)
        out = nsa_verify_fused(*common, sel_idx, sel_valid, positions, plen, ncb_valid,
                               tree_mask, g_all, nsa, C=C, mode=mode,
                               include_cmp=False, o_cmp_in=o_cmp, page_table=kv.pages)
    out = out.to(x.dtype).reshape(B, T, -1) @ params["wo"]
    return out, (k_new, v_new), (sel_idx, sel_valid)


def nsa_verify_vanilla_layer(params, cfg, x, cache, cmp_cache, prefix_len,
                             positions, tree_mask):
    """Vanilla-NSA baseline execution (paper Fig. 6(a)), the counterpart of
    the JAX ``nsa_verify_vanilla_layer``: no grouping (C=1), fresh indices,
    per-branch launches with the branch outputs materialized. The routing
    kernel gives o_cmp and p_slc, Top-n selects, then two launches of the
    verify kernel write the ungated slc and win + draft outputs, and the
    gates combine the three in PyTorch before ``wo``.
    Returns (out (B,T,D), (k_new, v_new), (sel_idx, sel_valid))."""
    kv = kvstore.as_view(cache)
    nsa = cfg.nsa
    B, T, _ = x.shape
    q_s, k_new, v_new, g_all, plen, ncb_valid = _layer_inputs(params, cfg, x, prefix_len,
                                                              positions)
    o_cmp, sel_idx, sel_valid = _route(q_s, cmp_cache, positions, plen, ncb_valid, nsa,
                                       kv.max_len)
    common = (q_s, kv.k, kv.v, cmp_cache["k_cmp"], cmp_cache["v_cmp"], k_new, v_new,
              sel_idx, sel_valid, positions, plen, ncb_valid, tree_mask, g_all, nsa)
    o_slc = nsa_verify_fused(*common, C=1, mode="exact", include_cmp=False,
                             branch="slc")
    o_win = nsa_verify_fused(*common, C=1, mode="exact", include_cmp=False,
                             branch="win")
    out = g_all[:, :, 0, :, None] * o_cmp + g_all[:, :, 1, :, None] * o_slc + \
        g_all[:, :, 2, :, None] * o_win
    out = out.to(x.dtype).reshape(B, T, -1) @ params["wo"]
    return out, (k_new, v_new), (sel_idx, sel_valid)
