"""KV storage behind the serving caches — the dense paths of
``repro.core.kvstore.KVView``.

The dense layout keeps per-request ``(B, max_context, Hkv, Dh)`` K/V buffers.
Out-of-range or negative token / block indices read exact zeros, never a
clamped neighbour (the adversarial-index contract of the JAX store). The
paged backend (page pool + page tables) is not ported yet.

Unlike the JAX store, ``write`` updates the buffers in place: the engine
owns one cache per model and never needs the pre-write version, so an
in-place write saves a max_context-sized copy per layer and step.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class KVView:
    """Per-layer dense K/V storage handle: k/v are (B, S, Hkv, Dh)."""

    k: Any
    v: Any

    @property
    def max_len(self) -> int:
        return self.k.shape[1]

    @property
    def batch(self) -> int:
        return self.k.shape[0]

    def gather_tokens(self, tok):
        """tok (B, *rest) absolute positions -> (k, v) of shape
        (B, *rest, Hkv, Dh); invalid positions read exact zeros."""
        S = self.k.shape[1]
        B = self.k.shape[0]
        ok = ((tok >= 0) & (tok < S))[..., None, None]
        idx = tok.clamp(0, S - 1)
        bidx = torch.arange(B, device=tok.device).reshape((B,) + (1,) * (tok.ndim - 1))
        zero = torch.zeros((), dtype=self.k.dtype, device=self.k.device)
        return (torch.where(ok, self.k[bidx, idx], zero),
                torch.where(ok, self.v[bidx, idx], zero))

    def gather_blocks(self, idx, sel_block: int):
        """idx (B, T, Hkv, n) block indices -> k/v (B, T, Hkv, n, sel_block,
        Dh); invalid / out-of-range blocks read exact zeros."""
        B, T, Hkv, n = idx.shape
        tok = idx[..., None] * sel_block + torch.arange(sel_block, device=idx.device)
        S = self.k.shape[1]
        ok = ((tok >= 0) & (tok < S))[..., None]
        tokc = tok.clamp(0, S - 1)
        bidx = torch.arange(B, device=idx.device).reshape(B, 1, 1, 1, 1)
        hidx = torch.arange(Hkv, device=idx.device).reshape(1, 1, Hkv, 1, 1)
        zero = torch.zeros((), dtype=self.k.dtype, device=self.k.device)
        return (torch.where(ok, self.k[bidx, tokc, hidx], zero),
                torch.where(ok, self.v[bidx, tokc, hidx], zero))

    def window(self, win_start, W: int):
        """Trailing window [win_start, win_start + W) -> k/v (B, W, Hkv, Dh).
        ``win_start`` is an int or a 0-d device tensor; like the JAX dynamic
        slice, the start is clamped into [0, S - W]."""
        S = self.k.shape[1]
        start = torch.as_tensor(win_start, device=self.k.device).reshape(())
        idx = start.clamp(0, S - W) + torch.arange(W, device=self.k.device)
        return self.k.index_select(1, idx), self.v.index_select(1, idx)

    def full(self):
        return self.k, self.v

    def write(self, k_new, v_new, start):
        """Insert (B, T, Hkv, Dh) at ``start`` in place; returns (k, v).
        The caller keeps ``start + T <= S`` (asserted by the engine from its
        host-side length): torch indexing neither clamps nor drops."""
        T = k_new.shape[1]
        S = self.k.shape[1]
        if isinstance(start, int):
            if not 0 <= start <= S - T:
                raise ValueError(f"write of {T} tokens at {start} overruns {S}")
            idx = torch.arange(start, start + T, device=self.k.device)
        else:
            idx = start.to(torch.long).reshape(()) + torch.arange(T, device=self.k.device)
        self.k.index_copy_(1, idx, k_new.to(self.k.dtype))
        self.v.index_copy_(1, idx, v_new.to(self.v.dtype))
        return self.k, self.v


def as_view(kv) -> KVView:
    """Normalize a raw ``{"k", "v"}`` cache dict or a view into a KVView."""
    if isinstance(kv, KVView):
        return kv
    return KVView(kv["k"], kv["v"])
