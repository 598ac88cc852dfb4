"""Wrapper of the routing kernel (``csrc/routing.cu``) — the counterpart of
``repro.kernels.routing.ops.routing_fused``, with the same contract.

CUDA tensors launch the kernel on the current stream (or raise); CPU
tensors run the plain version in ``ref.py``. There is no switch between the
two on the card and no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.config import NSAConfig
from repro_torch.kernels import LaunchCounter, build, per_row
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.routing import ref
from repro_torch.models.nsa import num_sel_blocks, overlap_tensor

LAUNCHES = LaunchCounter("routing")
HEAD_DIMS = (64, 128, 160, 192, 256)   # csrc/routing.cu HEAD_DIMS
ROWS_PER_CTA = 16           # RT in the kernel: query rows per CTA
KEYS_PER_CHUNK = 128        # cmp blocks per CTA while the cache is short
MAX_KEYS = 512              # KMAX in the kernel (its logit buffer)
SPLITS = 8                  # chunks per work list up to NCB = SPLITS * MAX_KEYS
MAX_CHUNKS = 256            # NXMAX in the kernel (65 chunks at 524,800 tokens)


def query_groups(T: int, Gq: int):
    """(Q, G, HS): a CTA holds Q consecutive tree queries x up to
    ``ROWS_PER_CTA`` query heads of one kv head; G groups cover T. Above
    ``ROWS_PER_CTA`` heads (Gq 48 under MQA) a query's heads are cut into HS
    head slabs of up to 16 heads, one CTA each, and Q is 1; the last CTA
    adds the slabs' GQA sums of the selection scores in slab order."""
    Q = max(1, min(ROWS_PER_CTA // Gq, T))
    return Q, -(-T // Q), -(-Gq // ROWS_PER_CTA)


def routing_plan(NCB: int, nsa: NSAConfig):
    """The kernel's split of one (row, query group, kv head) cmp list across
    CTAs, from shapes only: (n_cmp, keys, span). Chunks of ``keys`` blocks
    (``KEYS_PER_CHUNK``, grown in units of 16 up to ``MAX_KEYS`` so that a
    long list keeps at most ``SPLITS`` chunks); ``span`` bounds the
    selection blocks one chunk overlaps (its chunk-local scores). Past
    ``SPLITS`` x ``MAX_KEYS`` blocks the chunks stay at ``MAX_KEYS`` and
    grow in number (65 at 33,280 blocks, a 524,800-token cache). A list has
    at least one chunk, possibly empty."""
    keys = min(MAX_KEYS, max(KEYS_PER_CHUNK, 16 * -(-NCB // (16 * SPLITS))))
    n_cmp = max(1, -(-NCB // keys))
    span = ((keys - 1) * nsa.cmp_stride + nsa.cmp_block + nsa.sel_block - 2) \
        // nsa.sel_block + 1
    return n_cmp, keys, span


def _lib():
    fn = build.library("routing").routing_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def routing_fused(q, k_cmp, v_cmp, positions, ncb_valid, nsa: NSAConfig,
                  kv_len: int):
    """q: (B,T,Hq,Dh) f32, pre-scaled by 1/sqrt(Dh) and rope'd; k_cmp/v_cmp
    (B,NCB,Hkv,Dh); positions (B,T); ncb_valid an int or a (B,)/0-d tensor.
    Returns (o_cmp (B,T,Hq,Dh) f32, p_slc (B,T,Hkv,NSB) f32) with
    NSB = num_sel_blocks(kv_len)."""
    B, T, Hq, Dh = q.shape
    NCB, Hkv = k_cmp.shape[1], k_cmp.shape[2]
    NSB = num_sel_blocks(kv_len, nsa)
    if q.device.type == "cpu":
        M = overlap_tensor(NCB, max(NSB, 1), nsa, "cpu")
        return ref.ref_routing(q, k_cmp, v_cmp, M, positions, ncb_valid,
                               cmp_block=nsa.cmp_block, cmp_stride=nsa.cmp_stride)
    if q.device.type != "cuda":
        raise ValueError(f"routing_fused: unsupported device {q.device}")
    return launch(q, k_cmp, v_cmp, positions, ncb_valid, nsa, NSB)


def launch(q, k_cmp, v_cmp, positions, ncb_valid, nsa: NSAConfig, NSB: int):
    """Launch the CUDA kernel (CUDA tensors only). The CTAs of one (row,
    query group, kv head), every head slab and chunk, merge their partials
    through a ticket that each
    call leaves at 0, in the buffer per device and stream that the flash
    and nsa_verify kernels use (calls on one stream never overlap)."""
    B, T, Hq, Dh = q.shape
    NCB, Hkv = k_cmp.shape[1], k_cmp.shape[2]
    dev = q.device
    if Dh not in HEAD_DIMS:
        raise ValueError(f"routing kernel is built for head_dim in {HEAD_DIMS}, got {Dh}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32 (pre-scaled), got {q.dtype}")
    if k_cmp.dtype not in (torch.float32, torch.bfloat16) or v_cmp.dtype != k_cmp.dtype:
        raise TypeError("k_cmp/v_cmp must both be float32 or both bfloat16")
    if v_cmp.shape != k_cmp.shape or k_cmp.shape[0] != B or k_cmp.shape[3] != Dh:
        raise ValueError("k_cmp/v_cmp must be (B, NCB, Hkv, Dh)")
    for name, t in (("q", q), ("k_cmp", k_cmp), ("v_cmp", v_cmp)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_cmp", k_cmp), ("v_cmp", v_cmp)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte K/V loads)")
    if NCB * Hkv * Dh >= 2 ** 31:
        raise ValueError("a row of k_cmp must hold fewer than 2^31 elements (32-bit offsets)")
    if tuple(positions.shape) != (B, T):
        raise ValueError("positions must be (B, T)")
    Gq = Hq // Hkv
    Q, G, HS = query_groups(T, Gq)
    n_cmp, keys, span = routing_plan(NCB, nsa)
    if n_cmp > MAX_CHUNKS:
        raise ValueError(f"routing kernel splits a cmp list into at most {MAX_CHUNKS} "
                         f"chunks, {NCB} blocks need {n_cmp}")
    pos = positions.to(device=dev, dtype=torch.int32).contiguous()
    nv = per_row(ncb_valid, B, dev)
    o = torch.empty((B, T, Hq, Dh), dtype=torch.float32, device=dev)
    p_slc = torch.empty((B, T, Hkv, NSB), dtype=torch.float32, device=dev)
    slabs = B * G * Hkv * HS * n_cmp * ROWS_PER_CTA
    part_ml = torch.empty(slabs * 2, dtype=torch.float32, device=dev)
    part_acc = torch.empty(slabs * Dh, dtype=torch.float32, device=dev)
    part_sc = torch.empty(slabs * span, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = flash_ops._ticket_buffer(B * G * Hkv, dev, stream)
    ptrs = [t.data_ptr() for t in (q, k_cmp, v_cmp, pos, nv, o, p_slc, part_ml, part_acc,
                                   part_sc, tickets)]
    ints = [B, T, Hkv, Gq, Q, G, NCB, NSB, nsa.cmp_block, nsa.cmp_stride, nsa.sel_block,
            n_cmp, keys, span, HS]
    err = _lib()((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
                 0 if k_cmp.dtype == torch.float32 else 1, Dh, stream)
    if err != 0:
        raise RuntimeError(f"routing kernel launch failed: cudaError {err}")
    LAUNCHES.add()
    return o, p_slc
