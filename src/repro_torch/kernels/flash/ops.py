"""Wrapper of the flash tree-verification kernel (``csrc/flash_verify.cu``)
— the counterpart of ``repro.kernels.flash.ops.flash_verify``, with the
same contract.

CUDA tensors launch the kernel on the current stream (or raise); CPU
tensors run the plain version in ``ref.py``. There is no switch between the
two on the card and no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import LaunchCounter, build, per_row
from repro_torch.kernels.flash import ref

LAUNCHES = LaunchCounter("flash_verify")
HEAD_DIMS = (64, 80, 96, 128, 160, 192, 256)   # csrc/flash_verify.cu HEAD_DIMS
ROWS_PER_CTA = 16           # RT in the kernel
KEYS_PER_SPLIT = 512        # cache keys per CTA (KS in the kernel) up to MAX_SPLITS splits
# cache splits per (row, kv head, row tile): the last CTA's merge table, 2 x
# (splits + 1) x 16 floats, must fit the ring scratch of every instance
# (9,216 floats at bf16 Dh 64; the kernel refuses a launch past it)
MAX_SPLITS = 255

_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}
# buffers that a larger request replaced: a captured CUDA graph may still
# write to one, so none is ever freed
_retired: List[torch.Tensor] = []


def _lib():
    fn = build.library("flash_verify").flash_verify_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ticket_buffer(n: int, dev, stream: int) -> torch.Tensor:
    """At least ``n`` merge tickets for the kernels of one stream (flash's
    per (row, kv head, row tile), nsa_verify's per (row, group, kv head),
    routing's per (row, query group, kv head)):
    zeroed once, and each call's last CTA resets its tickets. Calls on one
    stream run one after another, so each finds its tickets at 0; calls on
    two streams get two buffers. A buffer that grows is replaced, and the
    old one is kept alive (``_retired``): a CUDA graph captured with it
    goes on using it, after each replay at 0 again."""
    key = (dev, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        if t is not None:
            _retired.append(t)
        t = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return t


def split_keys(S: int) -> int:
    """Cache keys per split (KS) for a cache of S keys: ``KEYS_PER_SPLIT``
    while that gives at most ``MAX_SPLITS`` splits, else the fewest keys
    (a multiple of the 16-key unit) that keep ``MAX_SPLITS`` (2,064 at a
    524,800-key cache, 255 splits)."""
    if -(-S // KEYS_PER_SPLIT) <= MAX_SPLITS:
        return KEYS_PER_SPLIT
    return 16 * -(-S // (16 * MAX_SPLITS))


def draft_mask(tree_mask, positions, Gq: int, window: int = 0):
    """(B,T,T) tree mask -> the kernel's (B, T*Gq, T) int32 draft mask: tree
    mask & pos_i >= pos_j (& pos_i - pos_j < window), row t*Gq + g of query
    t's g-th head (``repro.kernels.flash.ops`` lines 42-47)."""
    dist = positions[:, :, None] - positions[:, None, :]
    dmask = tree_mask.bool() & (dist >= 0)
    if window > 0:
        dmask = dmask & (dist < window)
    return dmask.repeat_interleave(Gq, dim=1).to(torch.int32).contiguous()


def flash_verify(q, k_cache, v_cache, k_draft, v_draft, positions, prefix_len,
                 tree_mask, window: int = 0):
    """q: (B,T,Hq,Dh) pre-scaled by 1/sqrt(Dh) and rope'd; k/v cache
    (B,S,Hkv,Dh); k/v draft (B,T,Hkv,Dh); positions (B,T); prefix_len an int
    or a 0-d / (B,) device tensor (rows may differ); tree_mask (B,T,T).
    Returns (B,T,Hq,Dh) f32.

    On the card the kernel runs on the current stream. Its CTAs merge their
    partial softmax states through counters (tickets) that each call leaves
    at 0; every stream has its own, so calls on different streams may
    overlap. A launch that faults leaves the device unusable, so no later
    call can see a ticket it left behind."""
    if q.device.type == "cpu":
        return ref.ref_flash_verify(q, k_cache, v_cache, k_draft, v_draft,
                                    positions, prefix_len, tree_mask, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_verify: unsupported device {q.device}")
    B, T, Hq, _ = q.shape
    Gq = Hq // max(k_cache.shape[2], 1)
    return launch(q, k_cache, v_cache, k_draft.contiguous(), v_draft.contiguous(),
                  positions.to(torch.int32).contiguous(),
                  per_row(prefix_len, B, q.device),
                  draft_mask(tree_mask, positions, Gq, window), window)


def launch(q, k_cache, v_cache, k_draft, v_draft, positions, prefix_len, dmask,
           window: int):
    """Launch the CUDA kernel (CUDA tensors only); checks every input."""
    B, T, Hq, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_verify kernel is built for head_dim in {HEAD_DIMS}, got {Dh}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32 (pre-scaled), got {q.dtype}")
    kv_t = k_cache.dtype
    if kv_t not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K/V must be float32 or bfloat16, got {kv_t}")
    Gq = Hq // Hkv
    shapes = {"q": (q, (B, T, Hq, Dh), torch.float32),
              "k_cache": (k_cache, (B, S, Hkv, Dh), kv_t),
              "v_cache": (v_cache, (B, S, Hkv, Dh), kv_t),
              "k_draft": (k_draft, (B, T, Hkv, Dh), kv_t),
              "v_draft": (v_draft, (B, T, Hkv, Dh), kv_t),
              "positions": (positions, (B, T), torch.int32),
              "prefix_len": (prefix_len, (B,), torch.int32),
              "dmask": (dmask, (B, T * Gq, T), torch.int32)}
    for name, (t, shape, dt) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dt}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("k_cache", "v_cache", "k_draft", "v_draft"):
        if shapes[name][0].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte K/V loads)")
        if shapes[name][0].numel() >= 2 ** 31:
            raise ValueError(f"{name} must hold fewer than 2^31 elements (32-bit offsets)")
    KS = split_keys(S)
    NX = -(-S // KS) + 1
    NRT = -(-T * Gq // ROWS_PER_CTA)
    slabs = B * Hkv * NRT * NX * ROWS_PER_CTA
    part_ml = torch.empty(slabs * 2, dtype=torch.float32, device=dev)
    part_acc = torch.empty(slabs * Dh, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _ticket_buffer(B * Hkv * NRT, dev, stream)
    out = torch.empty((B, T, Hq, Dh), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (q, k_cache, v_cache, k_draft, v_draft, positions,
                                   prefix_len, dmask, part_ml, part_acc, tickets, out)]
    ints = [B, T, S, Hkv, Gq, window, Dh, KS]
    err = _lib()((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
                 0 if kv_t == torch.float32 else 1, stream)
    if err != 0:
        raise RuntimeError(f"flash_verify kernel launch failed: cudaError {err}")
    LAUNCHES.add()
    return out
