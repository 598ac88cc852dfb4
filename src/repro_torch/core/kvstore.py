"""KV storage behind the serving caches — the counterpart of
``repro.core.kvstore``.

Two backends behind one view:

  dense — per-request ``(B, max_context, Hkv, Dh)`` K/V buffers;
  paged — a physical page pool ``(num_pages, page_size, Hkv, Dh)`` shared
      by every request, plus a per-row page table ``(B, max_pages)`` int32
      mapping logical page -> physical page (-1 = unmapped). Admission
      allocates a request's pages from a host-side free list
      (``PageAllocator``); commits write the accepted tokens into the row's
      own pages; completion returns the pages to the pool. The page size is
      a multiple of the NSA selection block, so a selected block is one
      page-table lookup.

Adversarial-index contract (the JAX store's): a read from a negative or
out-of-range position, an unmapped page or a page id past the pool reads
exact zeros, never a clamped neighbour; a write there is dropped.

Unlike the JAX store, ``write`` updates the buffers in place: the engine
owns one cache per model and never needs the pre-write version, so an
in-place write saves a max_context-sized copy per layer and step. A paged
write drops its invalid entries without a host sync: each one repeats a
valid entry's write (same index, same value), so it changes nothing (the
JAX store redirects them to a past-the-end sentinel instead).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch


# ------------------------------------------------------------------ config
@dataclasses.dataclass(frozen=True)
class KVStoreConfig:
    backend: str = "dense"        # "dense" | "paged"
    page_size: int = 0            # tokens per page (0 -> model's nsa.sel_block)
    num_pages: int = 0            # physical pool pages (0 -> slots * max_pages)

    def __post_init__(self):
        if self.backend not in ("dense", "paged"):
            raise ValueError(f"unknown kv backend {self.backend!r}; "
                             "choose dense or paged")

    @property
    def is_paged(self) -> bool:
        return self.backend == "paged"

    def resolved_page_size(self, model_cfg) -> int:
        ps = self.page_size or (model_cfg.nsa.sel_block
                                if model_cfg.attention == "nsa" else 64)
        if model_cfg.attention == "nsa" and ps % model_cfg.nsa.sel_block:
            raise ValueError(
                f"page_size={ps} must be a multiple of nsa.sel_block="
                f"{model_cfg.nsa.sel_block}: selected-block gather resolves "
                "through the page table, so pages must tile selection blocks")
        return ps

    def logical_pages(self, max_len: int, page_size: int) -> int:
        if max_len % page_size:
            raise ValueError(f"max_context={max_len} must be a multiple of "
                             f"page_size={page_size}")
        return max_len // page_size

    def resolved_num_pages(self, num_slots: int, max_pages_row: int) -> int:
        return self.num_pages or num_slots * max_pages_row


DENSE = KVStoreConfig()


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages covering ``n_tokens`` committed tokens (at least one page so an
    admitted row always owns a write target)."""
    return max(1, -(-int(n_tokens) // int(page_size)))


# ------------------------------------------------------------------ view
@dataclasses.dataclass
class KVView:
    """Per-layer K/V storage handle.

    dense: k/v are ``(B, S, Hkv, Dh)`` and ``pages`` is None.
    paged: k/v are the pool ``(P, page_size, Hkv, Dh)`` and ``pages`` is the
    shared ``(B, max_pages)`` int32 page table.
    """

    k: Any
    v: Any
    pages: Any = None

    @property
    def is_paged(self) -> bool:
        return self.pages is not None

    @property
    def page_size(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        if self.is_paged:
            return self.pages.shape[1] * self.page_size
        return self.k.shape[1]

    @property
    def batch(self) -> int:
        return self.pages.shape[0] if self.is_paged else self.k.shape[0]

    # ---- address resolution
    def _phys_flat(self, tok):
        """tok (B, ...) absolute positions -> flat pool-token index, -1 for
        an out-of-range position or an unmapped / out-of-pool page."""
        ps, P = self.page_size, self.k.shape[0]
        B, MP = self.pages.shape
        tok = tok.long()
        lp = torch.div(tok, ps, rounding_mode="floor").clamp(0, MP - 1)
        phys = torch.gather(self.pages.long(), 1, lp.reshape(B, -1)).reshape(lp.shape)
        ok = (tok >= 0) & (tok < MP * ps) & (phys >= 0) & (phys < P)
        return torch.where(ok, phys * ps + tok % ps, torch.full_like(tok, -1))

    def _flat(self, tok):
        """tok (B, ...) -> (flat (B, ...) index into ``_rows()``, valid)."""
        if self.is_paged:
            flat = self._phys_flat(tok)
            return flat.clamp_min(0), flat >= 0
        B, S = self.k.shape[:2]
        tok = tok.long()
        ok = (tok >= 0) & (tok < S)
        b = torch.arange(B, device=tok.device).reshape((B,) + (1,) * (tok.ndim - 1))
        return b * S + tok.clamp(0, S - 1), ok

    def _rows(self):
        """k/v viewed as token rows: (B*S or P*ps, Hkv, Dh)."""
        return (self.k.reshape(-1, *self.k.shape[2:]),
                self.v.reshape(-1, *self.v.shape[2:]))

    # ---- reads
    def gather_tokens(self, tok):
        """tok (B, *rest) absolute positions -> (k, v) of shape
        (B, *rest, Hkv, Dh); invalid positions read exact zeros."""
        idx, ok = self._flat(tok)
        kf, vf = self._rows()
        ok = ok[..., None, None]
        zero = torch.zeros((), dtype=self.k.dtype, device=self.k.device)
        return (torch.where(ok, kf[idx], zero), torch.where(ok, vf[idx], zero))

    def gather_blocks(self, idx, sel_block: int):
        """idx (B, T, Hkv, n) block indices -> k/v (B, T, Hkv, n, sel_block,
        Dh); invalid / out-of-range / unmapped blocks read exact zeros."""
        B, T, Hkv, n = idx.shape
        tok = idx.long()[..., None] * sel_block + torch.arange(sel_block, device=idx.device)
        flat, ok = self._flat(tok)
        kf, vf = self._rows()
        hidx = torch.arange(Hkv, device=idx.device).reshape(1, 1, Hkv, 1, 1)
        ok = ok[..., None]
        zero = torch.zeros((), dtype=self.k.dtype, device=self.k.device)
        return (torch.where(ok, kf[flat, hidx], zero), torch.where(ok, vf[flat, hidx], zero))

    def window(self, win_start, W: int):
        """Trailing window [win_start, win_start + W) -> k/v (B, W, Hkv, Dh).
        ``win_start`` is an int or a 0-d / (B,) device tensor, clamped into
        [0, max_len - W] like the JAX dynamic slice. Paged: each position
        resolves through the page table (the JAX view gathers the
        ``ceil(W/ps) + 1`` covering pages and slices; the positions are the
        same); an unmapped page reads zeros."""
        S = self.max_len
        dev = self.k.device
        start = torch.as_tensor(win_start, device=dev).long().reshape(-1, 1)
        tok = start.clamp(0, S - W) + torch.arange(W, device=dev)
        return self.gather_tokens(tok.expand(self.batch, W))

    def full(self):
        """The logical (B, max_len, Hkv, Dh) K/V. Paged: materialized from
        the row's pages (unmapped pages read zeros; readers mask by
        length), as the JAX view does for whole-cache readers (the dense
        draft's flash verify)."""
        if not self.is_paged:
            return self.k, self.v
        P = self.k.shape[0]
        B, MP = self.pages.shape
        pg = self.pages.long()
        ok = ((pg >= 0) & (pg < P))[..., None, None, None]
        pgc = pg.clamp(0, P - 1)
        zero = torch.zeros((), dtype=self.k.dtype, device=self.k.device)
        kf = torch.where(ok, self.k[pgc], zero)                     # (B,MP,ps,H,D)
        vf = torch.where(ok, self.v[pgc], zero)
        return (kf.reshape(B, MP * self.page_size, *kf.shape[3:]),
                vf.reshape(B, MP * self.page_size, *vf.shape[3:]))

    # ---- writes
    def write(self, k_new, v_new, start, row_mask=None):
        """Insert (B, T, Hkv, Dh) at ``start`` (an int, or a 0-d / (B,)
        device tensor: one start per row), in place; returns (k, v).

        Dense: the caller keeps ``start + T <= S`` (the engines check it from
        their host-side lengths): torch indexing neither clamps nor drops,
        and an int start that breaks it raises. Paged: positions past the
        row's mapped pages, and rows with ``row_mask`` False (released slots
        whose pages may already belong to another request), are dropped.
        ``row_mask`` is paged-only, as in the JAX store."""
        B, T = k_new.shape[:2]
        dev = self.k.device
        if not self.is_paged:
            if row_mask is not None:
                raise ValueError("row_mask is only meaningful for the paged "
                                 "backend; dense writes are never dropped")
            S = self.k.shape[1]
            if isinstance(start, int) and not 0 <= start <= S - T:
                raise ValueError(f"write of {T} tokens at {start} overruns {S}")
            st = torch.as_tensor(start, device=dev).long().reshape(-1, 1)
            pos = (st + torch.arange(T, device=dev)).expand(B, T)
            b = torch.arange(B, device=dev)[:, None].expand(B, T)
            self.k.index_put_((b, pos), k_new.to(self.k.dtype))
            self.v.index_put_((b, pos), v_new.to(self.v.dtype))
            return self.k, self.v
        st = torch.as_tensor(start, device=dev).long().reshape(-1, 1).expand(B, 1)
        flat = self._phys_flat(st + torch.arange(T, device=dev))        # (B, T)
        if row_mask is not None:
            flat = torch.where(row_mask.reshape(B, 1).to(dev), flat, torch.full_like(flat, -1))
        flat = flat.reshape(-1)
        kn = k_new.reshape(B * T, *k_new.shape[2:]).to(self.k.dtype)
        vn = v_new.reshape(B * T, *v_new.shape[2:]).to(self.v.dtype)
        kf, vf = self._rows()
        # drop the invalid entries without a host sync: each repeats the
        # first valid entry's write (same index, same value); with no valid
        # entry, it rewrites row 0 with its own value
        # (a (1,) index: a 0-d tensor index would read its value on the host)
        ok = flat >= 0
        first = ok.to(torch.int8).argmax().reshape(1)
        any_ok = ok.any()
        rep_idx = torch.where(any_ok, flat.index_select(0, first), 0)
        ok2 = ok[:, None, None]
        rep_k = torch.where(any_ok, kn.index_select(0, first), kf[:1])
        rep_v = torch.where(any_ok, vn.index_select(0, first), vf[:1])
        idx = torch.where(ok, flat, rep_idx)
        kf.index_copy_(0, idx, torch.where(ok2, kn, rep_k))
        vf.index_copy_(0, idx, torch.where(ok2, vn, rep_v))
        return self.k, self.v


def as_view(kv, pages=None) -> KVView:
    """Normalize a raw ``{"k", "v"}`` cache dict or a view into a KVView
    bound to ``pages`` (the paged store's page table, None = dense)."""
    if isinstance(kv, KVView):
        return kv
    return KVView(kv["k"], kv["v"], pages)


# ------------------------------------------------------------------ init
def init_kv(cfg, batch: int, max_len: int, dtype, device, store: KVStoreConfig = DENSE):
    """One layer's K/V storage: dense rows or the shared page pool."""
    if not store.is_paged:
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    else:
        ps = store.resolved_page_size(cfg)
        mp = store.logical_pages(max_len, ps)
        shape = (store.resolved_num_pages(batch, mp), ps, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def empty_page_table(batch: int, max_pages: int, device):
    return torch.full((batch, max_pages), -1, dtype=torch.int32, device=device)


def kv_cache_bytes(caches) -> int:
    """Raw-KV footprint of a model's caches (pool or dense leaves; a
    recurrent layer's state is not K/V and is not counted)."""
    return sum(t.numel() * t.element_size()
               for c in caches["layers"] if "kv" in c for t in c["kv"].values())


# ------------------------------------------------------------------ admission
@torch.no_grad()
def admit_row_dense(batch_caches, row_caches, row: int) -> None:
    """Land a freshly prefilled single-request cache (batch 1) into row
    ``row`` of dense batch caches, in place (the JAX
    ``admit_row_segments``): K/V, the compressed cache and recurrent
    states; other rows are untouched."""
    for bc, rc in zip(batch_caches["layers"], row_caches["layers"]):
        for part in bc:
            for name, t in bc[part].items():
                t[row].copy_(rc[part][name][0])


@torch.no_grad()
def admit_row_paged(batch_caches, row_caches, row: int, pages_row) -> None:
    """Land a freshly prefilled single-request cache (dense, batch 1) into
    batch row ``row`` of paged caches, in place — the counterpart of the
    JAX ``admit_row_paged``. Each layer's dense K/V is re-blocked into
    logical pages and copied into the pool at the row's physical pages
    (``pages_row`` (max_pages,) host int array, -1 entries dropped); the
    compressed cache and recurrent states are copied into row ``row``. Pool
    pages of other rows are untouched (the allocator never double-assigns).
    The page table itself is the engine's to update."""
    pages_row = np.asarray(pages_row).reshape(-1)
    keep = np.nonzero(pages_row >= 0)[0]
    for bc, rc in zip(batch_caches["layers"], row_caches["layers"]):
        if "state" in bc:
            for name, t in bc["state"].items():
                t[row].copy_(rc["state"][name][0])
            continue
        pool_k = bc["kv"]["k"]
        ps = pool_k.shape[1]
        dev = pool_k.device
        phys = torch.as_tensor(pages_row[keep], dtype=torch.long, device=dev)
        lp = torch.as_tensor(keep, dtype=torch.long, device=dev)
        for name in ("k", "v"):
            dense = rc["kv"][name][0]                                   # (S, Hkv, Dh)
            blocked = dense.reshape(-1, ps, *dense.shape[1:])
            bc["kv"][name].index_copy_(0, phys, blocked.index_select(0, lp)
                                       .to(bc["kv"][name].dtype))
        if "cmp" in bc:
            for name, t in bc["cmp"].items():
                t[row].copy_(rc["cmp"][name][0])


# ------------------------------------------------------------------ allocator
class PageAllocator:
    """Host-side free-list page allocator.

    Invariants (as the JAX allocator's):
      * a page is owned by at most one allocation at a time;
      * ``alloc`` returns ``None`` — and changes nothing — when the pool
        cannot satisfy the request (callers keep the request queued);
      * ``free`` rejects pages that are not currently allocated.
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))  # pop() -> 0,1,2,...
        self._allocated: set = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._allocated)

    @property
    def occupancy(self) -> float:
        return len(self._allocated) / self.num_pages

    def can_alloc(self, n: int) -> bool:
        return 0 < n <= len(self._free)

    def alloc(self, n: int) -> Optional[np.ndarray]:
        """n physical pages, or None (state unchanged) if the pool is
        exhausted — admission then leaves the request pending."""
        if n < 1:
            raise ValueError(f"alloc of {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        return np.asarray(pages, np.int32)

    def free(self, pages: Sequence[int]) -> None:
        pages = [int(p) for p in np.asarray(pages).reshape(-1)]
        for p in pages:
            if p not in self._allocated:
                raise ValueError(f"freeing page {p} that is not allocated")
        for p in pages:
            self._allocated.remove(p)
            self._free.append(p)
