"""Decoder-only model over attention and MoE blocks — the training and
serving paths of ``repro.models.model`` in PyTorch.

Parameters are plain dicts of tensors with the JAX names, but unstacked:
``params["layers"]`` is a list with one block dict per layer (the JAX
package stacks each segment along a leading axis; ``repro_torch.bridge``
unstacks). Caches are ``{"layers": [{"kv": {"k", "v"}, "cmp": {...}}, ...],
"length": (B,) int32 device tensor[, "pages": (B, max_pages) int32]}``:
one committed length per row; a recurrent layer's entry is
``{"state": {...}}``, its (B, ...) state leaves. Under the paged KV store
each layer's ``kv`` is the shared page pool and ``"pages"`` the row page
table (shared by the target and the draft); the compressed cache and the
recurrent states stay row-dense.

Paths:
  * ``loss_fn`` / ``forward_train`` — full-sequence causal training forward
    (chunked attention, one recomputed layer at a time under ``remat``, and
    the chunked vocab cross-entropy); differentiable by autograd;
  * ``prefill``     — full prompt forward that builds the KV / compressed
    caches;
  * ``verify_step`` — T tree-masked draft tokens; NSA layers run the
    refresh/reuse schedule and exact/approx grouping through the Hopper
    kernels (``kernels.nsa_verify.ops.nsa_verify_kernel_layer``); dense
    layers run the flash kernel (``attention.attend_verify``); recurrent
    layers replay their state over the tree (``recurrent.verify_states``);
  * ``commit``      — append each row's accepted path's K/V at its own
    length, update the compressed cache, take each recurrent layer's state
    after the deepest accepted node, advance each length (all on the
    device);
  * ``decode_step`` — one autoregressive token (verify with T=1 + commit).
Blocks are ``"attn"`` (attention + FFN), ``"moe"`` (attention + the MoE
FFN of ``models.moe``) or recurrent (``"rglru"``, ``"mlstm"``,
``"slstm"``: ``models.recurrent``, with an FFN when ``cfg.d_ff``);
attention is NSA, dense or sliding-window (``"swa"``: ``cfg.window``
reaches every attention call, as in JAX). A modality frontend
(``cfg.frontend_dim``) projects precomputed frames in front of the tokens;
tied embeddings unembed through the embedding table.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, SSVConfig
from repro_torch.core import kvstore
from repro_torch.device import dtype_of
from repro_torch.kernels.nsa_verify import ops as nsa_ops
from repro_torch.models import attention, layers, moe as moe_lib, nsa as nsa_lib
from repro_torch.models import recurrent, train_sharded

RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


def segments(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(group kinds, n_groups)] — tiles block_pattern over num_layers (the
    JAX stacked-parameter layout, which the bridge unstacks)."""
    pat = tuple(cfg.block_pattern)
    m = len(pat)
    full = cfg.num_layers // m
    segs: List[Tuple[Tuple[str, ...], int]] = []
    if full > 0:
        segs.append((pat, full))
    rem = cfg.num_layers - full * m
    if rem:
        segs.append((tuple(cfg.layer_kinds()[full * m:]), 1))
    return segs


def check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds()) - set(RECURRENT_KINDS) - {"attn", "moe"}
    if kinds:
        raise NotImplementedError(f"{cfg.name}: unknown block kinds {sorted(kinds)}")
    if cfg.attention not in ("nsa", "dense", "swa"):
        raise NotImplementedError(f"attention={cfg.attention!r} is not ported yet")


def logits_fn(params, cfg: ModelConfig, hidden):
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], hidden)
    return layers.lm_head(params["lm_head"], hidden)


def _attn_window(cfg: ModelConfig) -> int:
    return cfg.window if cfg.attention == "swa" else 0


def _apply_ffn(bp, cfg: ModelConfig, kind: str, x, moe_per_row: bool = False,
               moe_by_expert: bool = False, moe_stats=None, moe_group: int = 0,
               moe_gather_ids=None):
    """Returns (y, aux): the MoE FFN and its load-balancing loss for a
    ``"moe"`` block (dispatch groups per row with ``moe_per_row``; experts
    one by one, reading counts on the host, with ``moe_by_expert``; the
    loss's statistics summed by ``moe_stats``; the group size
    ``moe_group`` and the ids' gather ``moe_gather_ids`` of the cells
    across ranks: see ``moe.moe_apply``), else the dense FFN and None (no
    loss term, and no launch for a zero). A recurrent block without an FFN
    (``cfg.d_ff == 0``) adds zeros."""
    if kind == "moe":
        return moe_lib.moe_apply(bp["ffn"], cfg, x, per_row=moe_per_row,
                                 by_expert=moe_by_expert, stats_sum=moe_stats,
                                 group=moe_group, gather_ids=moe_gather_ids)
    if "ffn" not in bp:
        return torch.zeros_like(x), None
    return layers.ffn(bp["ffn"], x, cfg.activation), None


# ------------------------------------------------------------------ train fwd
def block_apply_train(bp, cfg: ModelConfig, kind: str, x, positions, chunk: int, i: int,
                      layer_params, moe_stats, split=None):
    """One block (layer ``i``) over the full sequence, or over the rank's
    positions with ``split``. Returns (y, aux): aux is the MoE
    load-balancing loss of a ``"moe"`` block, else None. The hooks are
    ``forward_train``'s; ``layer_params`` runs here, so under ``remat`` it
    runs again in the recompute."""
    if layer_params is not None:
        bp = layer_params(i, bp)
    h = layers.rmsnorm(bp["norm1"], x, cfg.norm_eps)
    window = _attn_window(cfg)
    if split is not None:
        mix = (train_sharded.RECURRENT[kind](bp["mix"], cfg, h, split)
               if kind in RECURRENT_KINDS else
               train_sharded.attention_mix(bp["mix"], cfg, h, positions, split, chunk))
    elif kind in RECURRENT_KINDS:
        mix = recurrent.TRAIN[kind](bp["mix"], cfg, h)
    elif cfg.attention == "nsa":
        mix, _ = nsa_lib.attend_train_nsa(bp["mix"], cfg, h, positions, chunk=chunk)
    elif cfg.attention_impl == "flash":
        mix, _ = attention.attend_train_flash(bp["mix"], cfg, h, positions, window=window)
    elif cfg.attention_impl == "online":
        mix, _ = attention.attend_train_online(bp["mix"], cfg, h, positions, window=window)
    else:
        mix, _ = attention.attend_train(
            bp["mix"], cfg, h, positions, window=window, chunk=chunk,
            remat_chunks=(cfg.attention_impl == "chunked_remat"))
    x = x + mix
    y, aux = _apply_ffn(bp, cfg, kind, layers.rmsnorm(bp["norm2"], x, cfg.norm_eps),
                        moe_stats=moe_stats,
                        moe_gather_ids=None if split is None else split.moe_ids)
    return x + y, aux


def embed_inputs(params, cfg: ModelConfig, tokens, frontend=None, a: int = 0,
                 b: Optional[int] = None):
    """Returns (x (B, b - a, d), positions (B, b - a) int32, n_prefix): the
    stream's positions ``[a, b)``, by default all of them. With a frontend
    (B, F, frontend_dim) and a ``frontend_proj``, its projected frames come
    first and n_prefix = F. Of the frames and tokens only those at
    ``[a, b)`` are projected and embedded; either part may be empty and is
    computed all the same, so that every training rank's graph
    (``forward_train``'s ``split``) reaches ``frontend_proj`` and the
    embedding table."""
    parts, n_prefix = [], 0
    if frontend is not None and "frontend_proj" in params:
        n_prefix = frontend.shape[1]
    b = n_prefix + tokens.shape[1] if b is None else b
    if n_prefix:
        parts.append(frontend[:, min(a, n_prefix):min(b, n_prefix)].to(
            params["embed"]["table"].dtype) @ params["frontend_proj"]["w"])
    parts.append(layers.embed(params["embed"], tokens[:, max(a, n_prefix) - n_prefix:
                                                      max(b, n_prefix) - n_prefix]))
    x = torch.cat(parts, dim=1)
    positions = torch.arange(a, b, dtype=torch.int32, device=tokens.device)
    return x, positions[None].expand(x.shape[0], b - a), n_prefix


def forward_train(params, cfg: ModelConfig, tokens, frontend=None, remat: bool = True,
                  attn_chunk: int = 512, layer_params=None, moe_stats=None, split=None):
    """tokens (B, S) int64 -> (hidden (B, S_total, d), aux 0-d f32 (the MoE
    layers' load-balancing losses summed), n_prefix (frontend frames)).
    ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``, as the JAX package wraps each segment
    body in ``jax.checkpoint``), so only the layers' inputs stay alive.

    Training across ranks (``runtime.sharded``) passes three hooks, all
    None on one device: ``layer_params(i, block)`` returns layer i's
    weights whole from this rank's blocks, inside the layer's function (so
    a recompute gathers again); ``moe_stats(t)`` sums the MoE
    load-balancing statistics over the ranks; ``split`` (a
    ``runtime.sharded.SeqSplit``) makes this rank embed and run every layer
    on its positions ``[split.a, split.b)`` only, and hidden is then
    (B, split.b - split.a, d)."""
    check_supported(cfg)
    x, positions, n_prefix = embed_inputs(params, cfg, tokens, frontend,
                                          *(() if split is None else (split.a, split.b)))
    aux_total = torch.zeros((), device=x.device)
    for i, (bp, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        args = (bp, cfg, kind, x, positions, attn_chunk, i, layer_params, moe_stats, split)
        if remat:
            x, aux = attention.remat(block_apply_train, *args)
        else:
            x, aux = block_apply_train(*args)
        if aux is not None:
            aux_total = aux_total + aux
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux_total, n_prefix


def loss_fn(params, cfg: ModelConfig, tokens, frontend=None, remat: bool = True,
            loss_chunk: int = 512, aux_weight: float = 0.01, attn_chunk: int = 512,
            layer_params=None, moe_stats=None, split=None):
    """Next-token cross-entropy, chunked over the sequence so the (chunk, V)
    logits working set stays bounded. Logits come out in the parameter
    dtype and are cast to float32 before the log-sum-exp, as in JAX.
    ``layer_params`` / ``moe_stats`` / ``split``: ``forward_train``'s hooks.
    With ``split`` the loss is this rank's part of its data rank's: the sum
    over the predictions whose hidden position it holds, divided by the
    data rank's B * (S_tok - 1), plus 1 / m of the load-balancing term,
    which every one of the m ``model`` ranks computes whole."""
    hidden, aux, n_prefix = forward_train(params, cfg, tokens, frontend, remat, attn_chunk,
                                          layer_params, moe_stats, split)
    B, S_tok = tokens.shape
    a, b, aux_share = (0, hidden.shape[1], 1) if split is None else (split.a, split.b, split.m)
    lo = max(a, n_prefix)
    hi = max(min(b, n_prefix + S_tok - 1), lo)           # lo == hi: no prediction here
    chunk = min(loss_chunk, S_tok - 1)
    while (S_tok - 1) % chunk:
        chunk -= 1
    h_pred = hidden[:, lo - a:hi - a]
    labels = tokens[:, lo - n_prefix + 1:hi - n_prefix + 1].long()
    total = torch.zeros((), device=hidden.device)
    for c0 in range(0, max(hi - lo, 1), chunk):
        sl = slice(c0, c0 + chunk)
        logits = logits_fn(params, cfg, h_pred[:, sl]).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, sl, None])[..., 0]
        total = total + (logz - gold).sum()
    return total / (B * (S_tok - 1)) + aux_weight * aux / aux_share


# ------------------------------------------------------------------ caches
def init_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                store: kvstore.KVStoreConfig = kvstore.DENSE):
    """Zeroed caches for ``batch`` rows, lengths 0, recurrent states at
    their initial values. Paged: raw K/V are the shared page pool and
    ``"pages"`` an empty (batch, max_pages) table; the engine maps pages at
    admission and may share one table between models."""
    dtype = dtype_of(cfg.dtype)
    out = []
    for kind in cfg.layer_kinds():
        if kind in RECURRENT_KINDS:
            out.append({"state": recurrent.STATE_INITS[kind](cfg, batch, device)})
            continue
        c = {"kv": attention.init_cache(cfg, batch, max_len, dtype, device, store)}
        if cfg.attention == "nsa":
            c["cmp"] = nsa_lib.init_cmp_cache(cfg, batch, max_len, dtype, device)
        out.append(c)
    caches = {"layers": out, "length": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if store.is_paged:
        ps = store.resolved_page_size(cfg)
        caches["pages"] = kvstore.empty_page_table(batch, store.logical_pages(max_len, ps),
                                                   device)
    return caches


@torch.no_grad()
def clear_caches(cfg: ModelConfig, caches) -> None:
    """Reset ``caches`` in place to ``init_caches``' values: K/V, the
    compressed cache and the lengths to 0, recurrent states to their
    initial values, a page table to unmapped (CUDA graphs that read these
    tensors stay valid)."""
    for kind, layer in zip(cfg.layer_kinds(), caches["layers"]):
        if "state" in layer:
            init = recurrent.STATE_INITS[kind](cfg, 1, "cpu")
            for name, t in layer["state"].items():
                t.copy_(init[name].expand_as(t))
            continue
        for part in layer.values():
            for t in part.values():
                t.zero_()
    caches["length"].zero_()
    if "pages" in caches:
        caches["pages"].fill_(-1)


# ------------------------------------------------------------------ prefill
@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, max_len: int, frontend=None,
            attn_chunk: int = 512, slstm_graphs: Optional[recurrent.SlstmGraphs] = None):
    """Run the full prompt (after the frontend's frames, if any) and build
    the caches. tokens (B, S) on the model's device; MoE experts run one
    by one over their kept tokens (a host sync per MoE layer: a prefill is
    never captured); an RG-LRU layer scans the prompt in log2(S) doubling
    steps, an mLSTM runs chunkwise and an sLSTM steps once per
    position (replaying the caller's captured chunks with
    ``slstm_graphs``). Returns (hidden (B, S_total, d), caches)."""
    check_supported(cfg)
    dev = tokens.device
    x, positions, _ = embed_inputs(params, cfg, tokens, frontend)
    B, S, _ = x.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len={max_len}")
    caches = init_caches(cfg, B, max_len, dev)
    window = _attn_window(cfg)
    for bp, cache, kind in zip(params["layers"], caches["layers"], cfg.layer_kinds()):
        hn = layers.rmsnorm(bp["norm1"], x, cfg.norm_eps)
        if kind in RECURRENT_KINDS:
            if kind == "slstm":
                mix, state = recurrent.slstm_prefill(bp["mix"], cfg, hn, slstm_graphs)
            else:
                mix, state = recurrent.PREFILL[kind](bp["mix"], cfg, hn)
            for name, t in cache["state"].items():
                t.copy_(state[name])
            x = x + mix
            x = x + _apply_ffn(bp, cfg, kind, layers.rmsnorm(bp["norm2"], x, cfg.norm_eps))[0]
            continue
        if cfg.attention == "nsa":
            mix, (k, v) = nsa_lib.attend_train_nsa(bp["mix"], cfg, hn, positions,
                                                   chunk=attn_chunk)
            k_cmp, v_cmp = nsa_lib.compress_kv(bp["mix"], k, v, cfg.nsa)
            ncb = k_cmp.shape[1]
            if ncb:
                cache["cmp"]["k_cmp"][:, :ncb] = k_cmp.to(cache["cmp"]["k_cmp"].dtype)
                cache["cmp"]["v_cmp"][:, :ncb] = v_cmp.to(cache["cmp"]["v_cmp"].dtype)
        elif cfg.attention_impl == "flash":
            mix, (k, v) = attention.attend_train_flash(bp["mix"], cfg, hn, positions,
                                                       window=window)
        else:
            q, k, v = attention.qkv(bp["mix"], cfg, hn, positions)
            heads = attention.attend_queries(cfg, q, k, v, 0, window, attn_chunk)
            mix = heads @ bp["mix"]["wo"]
        attention.write_cache(cache["kv"], k, v, 0)
        x = x + mix
        x = x + _apply_ffn(bp, cfg, kind, layers.rmsnorm(bp["norm2"], x, cfg.norm_eps),
                           moe_by_expert=True)[0]
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    caches["length"] = torch.full((B,), S, dtype=torch.int32, device=dev)
    return x, caches


# ------------------------------------------------------------------ verify
def _reuse_layer_flags(cfg: ModelConfig, ssv: Optional[SSVConfig]) -> np.ndarray:
    """Per-layer bool: True if the layer REUSES inherited indices. Layer 0
    is a mandatory refresh (paper §5.2)."""
    L = cfg.num_layers
    flags = np.zeros((L,), bool)
    if ssv is not None:
        for i in ssv.refresh_schedule:
            if 0 <= i < L:
                flags[i] = True
    flags[0] = False
    return flags


def _grouping(ssv: Optional[SSVConfig]) -> Tuple[int, str]:
    """(C, mode) the verify kernel runs with. No strategy (decode, AR) and
    group_mode "none" verify per query (C=1)."""
    if ssv is None or ssv.group_mode == "none":
        return 1, "exact"
    return max(1, ssv.group_size), ssv.group_mode


def _mix_verify(bp, cfg: ModelConfig, kind: str, h, cache, prefix_len, positions,
                tree_mask, parents, carry_idx, reuse: bool, ssv: Optional[SSVConfig],
                pages=None):
    """Sequence-mix one block in verify mode; ``pages`` is the paged
    store's page table (None = dense). Returns (mix_out, {"k_new",
    "v_new"} or a recurrent layer's {"state_buf"}, new_carry_idx)."""
    if kind in RECURRENT_KINDS:
        outs, buf = recurrent.verify_states(kind, bp["mix"], cfg, h, parents,
                                            cache["state"])
        return outs, {"state_buf": buf}, carry_idx
    kv = kvstore.as_view(cache["kv"], pages)
    if cfg.attention == "nsa":
        C, mode = _grouping(ssv)
        sel_idx, sel_valid = carry_idx if reuse else (None, None)
        out, (k_new, v_new), carry_idx = nsa_ops.nsa_verify_kernel_layer(
            bp["mix"], cfg, h, kv, cache["cmp"], prefix_len, positions,
            tree_mask, sel_idx=sel_idx, sel_valid=sel_valid, C=C, mode=mode,
            reuse=reuse)
        return out, {"k_new": k_new, "v_new": v_new}, carry_idx
    out, (k_new, v_new) = attention.attend_verify(bp["mix"], cfg, h, kv, prefix_len,
                                                  positions, tree_mask,
                                                  window=_attn_window(cfg))
    return out, {"k_new": k_new, "v_new": v_new}, carry_idx


@torch.no_grad()
def verify_step(params, cfg: ModelConfig, caches, draft_tokens, positions,
                tree_mask, parents=None, ssv: Optional[SSVConfig] = None,
                moe_per_row: bool = False):
    """Verify T draft tokens against the committed caches.

    draft_tokens (B, T); positions (B, T) absolute; tree_mask (B, T, T);
    each row verifies against its own committed length. ``parents`` (T,)
    host ints, the tree's (-1: the root hangs off the committed prefix),
    drive the recurrent layers' state replay; None means a chain (node i's
    parent is i - 1). ``moe_per_row`` cuts MoE dispatch groups from each
    row's T tokens, as the JAX batched engine's per-row ``vmap`` does; without it
    the B*T tokens are flattened, as a direct JAX call does. MoE experts
    run all at once with no host sync, so a step can be captured in a CUDA
    graph. Returns (logits (B, T, V), per-layer updates)."""
    if parents is None:
        parents = range(-1, draft_tokens.shape[1] - 1)
    prefix_len = caches["length"]
    pages = caches.get("pages")
    x = layers.embed(params["embed"], draft_tokens)
    flags = _reuse_layer_flags(cfg, ssv)
    carry = (None, None)
    updates = []
    for li, (bp, cache, kind) in enumerate(zip(params["layers"], caches["layers"],
                                               cfg.layer_kinds())):
        hn = layers.rmsnorm(bp["norm1"], x, cfg.norm_eps)
        mix, up, carry = _mix_verify(bp, cfg, kind, hn, cache, prefix_len, positions,
                                     tree_mask, parents, carry, bool(flags[li]), ssv, pages)
        x = x + mix
        x = x + _apply_ffn(bp, cfg, kind, layers.rmsnorm(bp["norm2"], x, cfg.norm_eps),
                           moe_per_row)[0]
        updates.append(up)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), updates


# ------------------------------------------------------------------ commit
def _gather_accepted(up, accepted):
    """(B, T, Hkv, Dh) draft K/V -> the accepted path's (B, T_acc, Hkv, Dh)."""
    idx = accepted.long()[:, :, None, None].expand(-1, -1, *up["k_new"].shape[2:])
    return torch.gather(up["k_new"], 1, idx), torch.gather(up["v_new"], 1, idx)


@torch.no_grad()
def commit(params, cfg: ModelConfig, caches, updates, accepted, n_accepted):
    """Commit each row's accepted path into the caches, on the device.

    accepted (B, T_acc) node indices (root-to-leaf, padded with its last
    entry); n_accepted (B,) how many are real. Row b's K/V are written in
    place at its own old length (the padded tail lands past its new length
    and is masked by it), compressed blocks the commit completes are added,
    a recurrent layer takes the state after the row's deepest accepted node
    (``recurrent.pick_state``), and its length advances by n_accepted[b].
    A row with n_accepted == 0 is a no-op that leaves every byte of its
    caches as it was: its length stays frozen (batched serving freezes
    finished rows and steps rows outside an execution group this way). The
    dense store writes such a row's current K/V back in place of the path
    (at a start clamped into the row, so a finished row near the end of its
    cache writes in range).

    Paged caches (``"pages"`` present): the K/V go into the row's pages
    through the page table, and a row with n_accepted == 0 writes nothing
    (``row_mask``): a released slot's pages may already belong to another
    request. This one in-place commit stands for the JAX
    ``commit_paged_prepare`` + ``commit_apply_paged`` pair, which splits
    only because of ``vmap``; the compression update reads the written pool
    (see ``nsa.update_cmp_cache_dyn``). The dense caller keeps
    ``length + T_acc <= max_len`` for every committing row (the engines
    check it from their host-side lengths).

    Everything is written in place, the lengths too (``caches["length"]``
    keeps its tensor), so a CUDA graph that captured the step goes on
    reading the buffers the engine holds. Returns the caches dict."""
    old_len = caches["length"]
    pages = caches.get("pages")
    B, T_acc = accepted.shape
    new_len = (old_len + n_accepted.to(old_len.dtype)).to(torch.int32)
    live = n_accepted > 0
    row_mask = live if pages is not None else None
    max_new_cmp = T_acc // cfg.nsa.cmp_stride + 2
    start = old_len
    kv_layers = [c for c in caches["layers"] if "kv" in c]
    if pages is None and kv_layers:
        # the same (row, position) pairs in every layer
        S = kv_layers[0]["kv"]["k"].shape[1]
        start = torch.where(live, old_len, old_len.clamp(max=S - T_acc))
        rows = torch.arange(B, device=old_len.device)[:, None]
        pos = start.long()[:, None] + torch.arange(T_acc, device=old_len.device)
        keep = live[:, None, None, None]
    for bp, cache, up in zip(params["layers"], caches["layers"], updates):
        if "state" in cache:
            recurrent.pick_state(cache["state"], up["state_buf"], accepted, n_accepted)
            continue
        k_acc, v_acc = _gather_accepted(up, accepted)
        view = kvstore.as_view(cache["kv"], pages)
        if pages is None:
            k_acc = torch.where(keep, k_acc.to(view.k.dtype), view.k[rows, pos])
            v_acc = torch.where(keep, v_acc.to(view.v.dtype), view.v[rows, pos])
        view.write(k_acc, v_acc, start, row_mask=row_mask)
        if "cmp" in cache:
            new_cmp = nsa_lib.update_cmp_cache_dyn(bp["mix"], view, cache["cmp"],
                                                   old_len, new_len, max_new_cmp,
                                                   cfg.nsa)
            cache["cmp"]["k_cmp"].copy_(new_cmp["k_cmp"])
            cache["cmp"]["v_cmp"].copy_(new_cmp["v_cmp"])
    caches["length"].copy_(new_len)
    return caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, caches, tokens, ssv: Optional[SSVConfig] = None):
    """One autoregressive step: tokens (B, 1). Returns (logits, caches)."""
    B = tokens.shape[0]
    dev = tokens.device
    positions = caches["length"].reshape(-1, 1).expand(B, 1).to(torch.int32)
    tree_mask = torch.ones((B, 1, 1), dtype=torch.bool, device=dev)
    logits, updates = verify_step(params, cfg, caches, tokens, positions, tree_mask,
                                  [-1], ssv)
    caches = commit(params, cfg, caches, updates,
                    accepted=torch.zeros((B, 1), dtype=torch.long, device=dev),
                    n_accepted=torch.ones((B,), dtype=torch.int32, device=dev))
    return logits, caches
