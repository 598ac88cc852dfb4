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
from repro_torch.kernels.routing import ref
from repro_torch.models.nsa import num_sel_blocks, overlap_tensor

LAUNCHES = LaunchCounter("routing")
HEAD_DIMS = (64, 128)
MAX_GQ = 8


def _lib():
    lib = build.library("routing")
    fn = lib.routing_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
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
    """Launch the CUDA kernel (CUDA tensors only)."""
    B, T, Hq, Dh = q.shape
    NCB, Hkv = k_cmp.shape[1], k_cmp.shape[2]
    dev = q.device
    if Dh not in HEAD_DIMS:
        raise ValueError(f"routing kernel is built for head_dim in {HEAD_DIMS}, got {Dh}")
    if Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GQ:
        raise ValueError(f"routing kernel takes 1..{MAX_GQ} query heads per kv head")
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
    if tuple(positions.shape) != (B, T):
        raise ValueError("positions must be (B, T)")
    pos = positions.to(device=dev, dtype=torch.int32).contiguous()
    nv = per_row(ncb_valid, B, dev)
    o = torch.empty((B, T, Hq, Dh), dtype=torch.float32, device=dev)
    p_slc = torch.empty((B, T, Hkv, NSB), dtype=torch.float32, device=dev)
    err = _lib()(q.data_ptr(), k_cmp.data_ptr(), v_cmp.data_ptr(),
                 pos.data_ptr(), nv.data_ptr(), o.data_ptr(), p_slc.data_ptr(),
                 B, T, Hkv, Hq // Hkv, NCB, NSB, nsa.cmp_block, nsa.cmp_stride,
                 nsa.sel_block, 0 if k_cmp.dtype == torch.float32 else 1, Dh,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"routing kernel launch failed: cudaError {err}")
    LAUNCHES.add()
    return o, p_slc
