"""Sequence-sharded NSA decode over torch ranks — the counterpart of
``repro.models.nsa_sharded`` (the split-KV path of batch-1 long-context
serving), with ``torch.distributed`` all-reduces in place of ``shard_map``'s
``pmax`` / ``psum``.

Each rank owns a contiguous slice of the raw and of the compressed cache
(``launch.sharding.cache_specs(shard_sequence=True)``: the sequence split
over the ``seq_axes`` of the mesh, row-major) and computes over its slice
only:

  1. local routing: q . K_cmp over the rank's compressed blocks -> the cmp
     branch's online-softmax state (m, l, acc) and the partial selection
     mass of each query head;
  2. all-reduces that give every rank the same global Top-n
     (``nsa.select_topn``, mandatory blocks included): the max logit and
     the softmax sum of each head (they are also the cmp branch's merge),
     then the sum of the (B, Hkv, NSB) selection scores;
  3. the slc branch by token-granular ownership (a selected block may
     straddle two slices), the rank's segment of the sliding window, and
     the new token itself on the rank of index 0 only;
  4. log-sum-exp merges of the slc and win states and the gated sum.

Five all-reduces per layer and token: MAX and SUM for the cmp branch, SUM
of the selection scores, MAX and SUM for the slc and win branches. The new
K/V row is written on the rank that owns position ``prefix_len``. The
reference leaves the compressed cache read-only here (the serving engine's
commit owns that update); the port writes it, as ``model.decode_step``'s
commit does, so that N tokens equal N ``decode_step``s (the JAX dry run's
``decode_32k`` step is ``model.decode_step``): ``commit_cmp_sharded``
writes the block that a token completes on the rank that owns it. A token
completes a block once in ``cmp_stride`` tokens; only when the block's
``cmp_block`` rows straddle two slices, or lie on another rank than the
block, does the write cost one more all-reduce (``collectives`` counts
them, and the embedding's sum over ``model`` when the weights are
``runtime.sharded.ServeWeights``).

The same code serves the batched decode (``cache_specs(shard_sequence=
False)``: the rows over the data axes, the sequence over ``model``, and
``seq_axes = ("model",)`` within each data group) with the weights under
``param_specs`` (``ServeWeights``: each layer gathered just in time, the
logits a vocab slice per ``model`` rank), and there the dense and
sliding-window archs too: ``decode_step_sharded`` sends their layers to
``attention_sharded.attend_decode_sharded`` and a MoE layer's expert ids
across the data ranks (``ids_gather``). A recurrent layer (recurrentgemma,
xlstm) steps its state, which every rank of a row holds whole, with no
collective.

Where the reference differs from itself, the port takes the single-device
side. ``repro.models.nsa_sharded`` sums ``exp(l - m)`` over the query heads
of a kv group without dividing by each head's softmax sum, so with more
than one query head per kv head it can rank the selection blocks unlike
``nsa.routing``, which sums each head's normalised probabilities. Here each
head's mass is divided by its all-reduced sum before the group sum, so the
Top-n equals ``routing`` + ``select_topn`` on one device, and the output
equals ``nsa.nsa_verify_ref`` at T = 1 up to reduction order.

The per-rank compute is plain PyTorch, as the reference's is plain
``jnp``: no TPU kernel lies on this path. Each rank builds only its rows of
the cmp -> selection-block overlap matrix, and of those only the band of
columns they reach.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers
from repro_torch.models.attention import NEG_INF, qkv
from repro_torch.models.nsa import (_pool_project, dyn_num_cmp_blocks, gates, num_cmp_blocks,
                                    num_sel_blocks, select_topn)

_COUNT = [0]


def collectives() -> int:
    """All-reduces issued since the last ``reset_collectives``."""
    return _COUNT[0]


def reset_collectives() -> None:
    _COUNT[0] = 0


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` reduced in place over ``group``; counted."""
    _COUNT[0] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` in the order of the group's
    ranks, which is the order of their shard index (``shard_of``); counted."""
    _COUNT[0] += 1
    out = t.new_empty((n,) + tuple(t.shape))
    dist.all_gather_into_tensor(out.view(-1), t.contiguous().view(-1), group=group)
    return out


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """t (n, ...) -> the sum over the group of every rank's t[i], on the
    rank of shard index i; counted."""
    _COUNT[0] += 1
    out = t.new_empty(tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out.view(-1), t.contiguous().view(-1), group=group)
    return out


# ---------------------------------------------------------------- geometry
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple] = {}


def shard_of(mesh, seq_axes: Sequence[str]) -> Tuple[object, int, int]:
    """(process group, this rank's index, shard count) of ``seq_axes``;
    the group is made once per mesh (every rank makes it alike)."""
    key = (id(mesh), tuple(seq_axes))
    if key not in _GROUPS:
        idx, n = mesh_lib.axes_index(mesh, seq_axes)
        group = mesh_lib.axes_group(mesh, seq_axes)
        if dist.get_group_rank(group, dist.get_rank()) != idx:
            raise RuntimeError(f"the group of {tuple(seq_axes)} does not order its ranks by "
                               "their shard index")
        _GROUPS[key] = (mesh, group, idx, n)
    _, group, idx, n = _GROUPS[key]
    return group, idx, n


def check_shards(S: int, NCB: int, nshards: int) -> None:
    """Raises unless the raw slots ``S`` and the compressed blocks ``NCB``
    both divide by the shard count, naming the one that does not."""
    bad = [f"{name} = {v}" for name, v in (("S", S), ("NCB", NCB)) if v % nshards]
    if bad:
        raise ValueError(f"{' and '.join(bad)} do not divide by {nshards} shards"
                         if len(bad) > 1 else f"{bad[0]} does not divide by {nshards} shards")


def overlap_band(row0: int, nrows: int, nsb: int, l: int, d: int,
                 lp: int) -> Tuple[int, np.ndarray]:
    """Rows ``row0 .. row0 + nrows`` of ``nsa.overlap_matrix`` restricted to
    the columns they reach: (first column, the (nrows, ncols) block). The
    same arithmetic as the full matrix, so each value is the same."""
    c0 = min(row0 * d // lp, nsb)
    c1 = min(nsb, ((row0 + nrows - 1) * d + l - 1) // lp + 1) if nrows else c0
    i = np.arange(row0, row0 + nrows)[:, None]
    j = np.arange(c0, c1)[None, :]
    lo = np.maximum(i * d, j * lp)
    hi = np.minimum(i * d + l, (j + 1) * lp)
    return c0, (np.maximum(0, hi - lo) / float(l)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_tensor(row0: int, nrows: int, nsb: int, l: int, d: int, lp: int, device: str):
    c0, m = overlap_band(row0, nrows, nsb, l, d, lp)
    return c0, torch.from_numpy(m).to(device)


def _state(logits, mask):
    """Local softmax state of masked logits (B,Hkv,G,K): the max m
    (B,Hkv,G) and exp(logits - m) where ``mask``, else 0."""
    lm = torch.where(mask, logits, torch.full((), NEG_INF, device=logits.device))
    m = lm.amax(-1)
    p = torch.where(mask, torch.exp(lm - m[..., None]), torch.zeros((), device=logits.device))
    return m, p


def _merge(m, l, acc, group):
    """LSE-merge per-rank states (m (…), l (…), acc (…, Dh)) across the
    group: two all-reduces. Returns the merged, normalised output."""
    m_max = all_reduce(m.clone(), dist.ReduceOp.MAX, group)
    s = torch.exp(m - m_max)
    buf = torch.cat([(l * s)[..., None], acc * s[..., None]], dim=-1)
    all_reduce(buf, dist.ReduceOp.SUM, group)
    l_g, acc_g = buf[..., 0], buf[..., 1:]
    return torch.where(l_g[..., None] > 0, acc_g / l_g.clamp(min=1e-30)[..., None],
                       torch.zeros((), device=acc.device))


# ---------------------------------------------------------------- one layer
@torch.no_grad()
def nsa_attend_decode_sharded(params, cfg: ModelConfig, mesh, x, cache_local, cmp_local,
                              prefix_len, seq_axes: Sequence[str], return_sel: bool = False):
    """One-token NSA attention + raw K/V commit over a sequence-sharded cache.

    x: (B, 1, D), the same on every rank. ``cache_local`` {"k", "v"}: this
    rank's (B, S / n, Hkv, Dh) slice; ``cmp_local`` {"k_cmp", "v_cmp"}:
    its (B, NCB / n, Hkv, Dh) slice (n = the shard count of ``seq_axes``).
    ``prefix_len``: an int or a 0-d / (B,) tensor, the same on every rank.
    Returns (out (B, 1, D), cache_local with the new row written in place
    on the owning rank, cmp_local unchanged), and with ``return_sel`` the
    global Top-n (sel_idx, sel_valid), each (B, Hkv, n)."""
    nsa = cfg.nsa
    group, idx, nshards = shard_of(mesh, seq_axes)
    B, dev = x.shape[0], x.device
    Hq, Hkv, G, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    k_c, v_c = cache_local["k"], cache_local["v"]
    k_cm, v_cm = cmp_local["k_cmp"], cmp_local["v_cmp"]
    S_loc, NCB_loc = k_c.shape[1], k_cm.shape[1]
    S = S_loc * nshards
    NSB = num_sel_blocks(S, nsa)
    off, cmp_off = idx * S_loc, idx * NCB_loc
    neg = torch.full((), NEG_INF, device=dev)
    zero = torch.zeros((), device=dev)

    pos = torch.as_tensor(prefix_len, device=dev).to(torch.int32).reshape(-1).expand(B)
    positions = pos[:, None]                                              # (B, 1)
    q, k_new, v_new = qkv(params, cfg, x, positions)
    g_all = gates(params, x, Hq)                                          # (B,1,3,Hq)
    scale = 1.0 / math.sqrt(Dh)
    ncb_valid = dyn_num_cmp_blocks(pos, nsa)                              # (B,)
    qg = q.reshape(B, Hkv, G, Dh).float()

    # ---- 1. local routing: the cmp branch's state and per-head mass
    cmp_ids = cmp_off + torch.arange(NCB_loc, device=dev)
    ends = cmp_ids * nsa.cmp_stride + nsa.cmp_block - 1
    cvis = (ends[None] <= pos[:, None]) & (cmp_ids[None] < ncb_valid[:, None])  # (B, NCB_loc)
    lc = torch.einsum("bhgd,bkhd->bhgk", qg, k_cm.float()) * scale
    cmask = cvis[:, None, None, :]
    lc = torch.where(cmask, lc, neg)
    # ---- 2. each head's global max and softmax sum (also the cmp merge)
    m_glob = all_reduce(lc.amax(-1), dist.ReduceOp.MAX, group)
    p_c = torch.where(cmask, torch.exp(lc - m_glob[..., None]), zero)     # exp(l - m_glob)
    acc_c = torch.einsum("bhgk,bkhd->bhgd", p_c, v_cm.float())
    buf = torch.cat([p_c.sum(-1)[..., None], acc_c], dim=-1)
    all_reduce(buf, dist.ReduceOp.SUM, group)
    l_glob, acc_glob = buf[..., 0], buf[..., 1:]
    o_cmp = torch.where(l_glob[..., None] > 0, acc_glob / l_glob.clamp(min=1e-30)[..., None],
                        zero)
    # each head's normalised probabilities, summed over the group's heads
    pn = torch.where(l_glob[..., None] > 0, p_c / l_glob.clamp(min=1e-30)[..., None], zero)
    pm = pn.sum(dim=2)                                                    # (B,Hkv,NCB_loc)
    c0, band = _band_tensor(cmp_off, NCB_loc, max(NSB, 1), nsa.cmp_block, nsa.cmp_stride,
                            nsa.sel_block, str(dev))
    p_slc = torch.zeros((B, Hkv, max(NSB, 1)), dtype=torch.float32, device=dev)
    p_slc[..., c0:c0 + band.shape[1]] = torch.einsum("bhk,ks->bhs", pm, band)
    all_reduce(p_slc, dist.ReduceOp.SUM, group)
    sel_idx, sel_valid = select_topn(p_slc[:, None], positions, pos, nsa)
    sel_idx, sel_valid = sel_idx[:, 0], sel_valid[:, 0]                  # (B,Hkv,n)

    # ---- 3a. slc branch: the selected tokens this rank owns
    lp = nsa.sel_block
    n = sel_idx.shape[-1]
    tok = (sel_idx[..., None].long() * lp + torch.arange(lp, device=dev)).reshape(B, Hkv, n * lp)
    own = (tok >= off) & (tok < off + S_loc) & (tok < pos[:, None, None].long()) & \
        sel_valid.repeat_interleave(lp, dim=-1)
    loc = (tok - off).clamp(0, S_loc - 1)
    bidx = torch.arange(B, device=dev)[:, None, None]
    hidx = torch.arange(Hkv, device=dev)[None, :, None]
    k_sel, v_sel = k_c[bidx, loc, hidx], v_c[bidx, loc, hidx]            # (B,Hkv,K,Dh)
    ls = torch.einsum("bhgd,bhkd->bhgk", qg, k_sel.float()) * scale
    m_s, p_s = _state(ls, own[:, :, None])
    l_s = p_s.sum(-1)
    acc_s = torch.einsum("bhgk,bhkd->bhgd", p_s, v_sel.float())

    # ---- 3b. win branch: the rank's window segment, and the new token on rank 0
    W = min(nsa.window, S_loc)
    wstart = (pos.long() - nsa.window + 1).clamp(0, S - 1)                # (B,)
    lstart = (wstart - off).clamp(0, max(S_loc - W, 0))
    wl = lstart[:, None] + torch.arange(W, device=dev)                   # (B, W)
    brow = torch.arange(B, device=dev)[:, None]
    k_w, v_w = k_c[brow, wl], v_c[brow, wl]                              # (B,W,Hkv,Dh)
    wpos = off + wl
    wmask = (wpos < pos[:, None].long()) & (wpos >= wstart[:, None])
    lw = torch.einsum("bhgd,bkhd->bhgk", qg, k_w.float()) * scale
    lnew = torch.einsum("bhgd,bkhd->bhgk", qg, k_new.float()) * scale     # (B,Hkv,G,1)
    lwin = torch.cat([lw, lnew], dim=-1)
    mwin = torch.cat([wmask, torch.full((B, 1), idx == 0, device=dev)], dim=-1)
    m_w, p_w = _state(lwin, mwin[:, None, None, :])
    l_w = p_w.sum(-1)
    acc_w = torch.einsum("bhgk,bkhd->bhgd", p_w[..., :W], v_w.float()) + \
        torch.einsum("bhgk,bkhd->bhgd", p_w[..., W:], v_new.float())

    # ---- 4. merges and gates
    o_sw = _merge(torch.stack([m_s, m_w]), torch.stack([l_s, l_w]),
                  torch.stack([acc_s, acc_w]), group)
    o_slc, o_win = o_sw[0], o_sw[1]
    g = g_all[:, 0].reshape(B, 3, Hkv, G)
    o = (g[:, 0, :, :, None] * o_cmp + g[:, 1, :, :, None] * o_slc +
         g[:, 2, :, :, None] * o_win).to(x.dtype)
    out = o.reshape(B, 1, Hq * Dh) @ params["wo"]

    # ---- the raw K/V row, on the rank that owns position prefix_len
    in_range = ((pos >= off) & (pos < off + S_loc))[:, None, None]
    wr = (pos.long() - off).clamp(0, S_loc - 1)
    rows = torch.arange(B, device=dev)
    k_c[rows, wr] = torch.where(in_range, k_new[:, 0].to(k_c.dtype), k_c[rows, wr])
    v_c[rows, wr] = torch.where(in_range, v_new[:, 0].to(v_c.dtype), v_c[rows, wr])
    if return_sel:
        return out, cache_local, cmp_local, (sel_idx, sel_valid)
    return out, cache_local, cmp_local


# ---------------------------------------------------------------- the compressed write
@torch.no_grad()
def commit_cmp_sharded(params, cfg: ModelConfig, mesh, cache_local, cmp_local, prefix_len,
                       seq_axes: Sequence[str], lengths: Sequence[int]) -> None:
    """After the token at ``prefix_len`` was written (``nsa_attend_decode_
    sharded``): the compressed block that it completes, as
    ``model.commit``'s ``update_cmp_cache_dyn`` computes it, written in
    place by the rank whose slice of the compressed cache holds it.

    ``lengths``: ``prefix_len`` on the host, one per row. They are the same on every rank of the group, so every rank
    decides alike, with no collective: when no row completes a block,
    nothing is done; when each completed block's rows all lie in the slice
    of the rank that owns the block, that rank computes it from its own
    rows; otherwise each rank puts the blocks' rows that it holds into a
    zeroed (2, B, l, Hkv, Dh) buffer and one all-reduce SUM gives every
    rank all of them (each row is held once, so the sum is exact)."""
    nsa = cfg.nsa
    group, idx, _ = shard_of(mesh, seq_axes)
    k_c, v_c = cache_local["k"], cache_local["v"]
    B, S_loc = k_c.shape[0], k_c.shape[1]
    NCB_loc = cmp_local["k_cmp"].shape[1]
    blocks = [num_cmp_blocks(p, nsa) for p in lengths
              if num_cmp_blocks(p + 1, nsa) > num_cmp_blocks(p, nsa)]
    owners = {j // NCB_loc for j in blocks}
    shared = any(j * nsa.cmp_stride // S_loc != j // NCB_loc or
                 (j * nsa.cmp_stride + nsa.cmp_block - 1) // S_loc != j // NCB_loc
                 for j in blocks)
    if not shared and idx not in owners:
        return
    off, cmp_off = idx * S_loc, idx * NCB_loc
    dev = k_c.device
    pos = torch.as_tensor(prefix_len, device=dev).to(torch.int32).reshape(-1).expand(B)
    j = dyn_num_cmp_blocks(pos, nsa)                                      # (B,)
    done = dyn_num_cmp_blocks(pos + 1, nsa) > j
    rows = j[:, None].long() * nsa.cmp_stride + torch.arange(nsa.cmp_block, device=dev)
    loc = (rows - off).clamp(0, S_loc - 1)
    brow = torch.arange(B, device=dev)[:, None]
    buf = torch.stack([k_c[brow, loc], v_c[brow, loc]]).float()          # (2,B,l,Hkv,Dh)
    if shared:
        mine = (rows >= off) & (rows < off + S_loc)                       # (B, l)
        buf = torch.where(mine[None, :, :, None, None], buf, torch.zeros((), device=dev))
        all_reduce(buf, dist.ReduceOp.SUM, group)
    k_new, v_new = _pool_project(params, buf[0][:, None], buf[1][:, None], torch.float32)
    own = (done & (j >= cmp_off) & (j < cmp_off + NCB_loc))[:, None, None]
    slot = (j - cmp_off).clamp(0, NCB_loc - 1).long()
    b = torch.arange(B, device=dev)
    for name, new in (("k_cmp", k_new), ("v_cmp", v_new)):
        t = cmp_local[name]
        t[b, slot] = torch.where(own, new[:, 0].to(t.dtype), t[b, slot])


# ---------------------------------------------------------------- full model
def ids_gather(mesh, seq_axes: Sequence[str]):
    """The MoE decode's hook (``moe.moe_apply(gather_ids=)``) when the rows
    lie over data axes outside ``seq_axes`` and those hold more than one
    rank: topk_idx (N, K) -> (every data rank's ids in the order of their
    rows, this rank's run of tokens among them), one counted all-gather.
    None otherwise (every rank holds the whole group)."""
    axes = tuple(a for a in mesh_lib.dp_axes(mesh) if a not in seq_axes)
    if not axes or mesh_lib.axes_index(mesh, axes)[1] == 1:
        return None
    group, idx, n = shard_of(mesh, axes)

    def gather(ids):
        t0 = idx * ids.shape[0]
        return all_gather(ids, group, n).reshape(-1, ids.shape[-1]), ((t0, t0 + ids.shape[0]),)
    return gather


@torch.no_grad()
def decode_step_sharded(params, cfg: ModelConfig, mesh, caches, tokens,
                        seq_axes: Sequence[str]):
    """Full-model one-token decode with sequence-sharded attention: the
    semantics of ``model.decode_step`` for stacks of ``"attn"`` / ``"moe"``
    and recurrent blocks. Each layer's attention goes by ``cfg.attention``:
    NSA (``nsa_attend_decode_sharded``, the compressed cache written by the
    owner of each block a token completes) or dense / ``"swa"``
    (``attention_sharded.attend_decode_sharded``). A MoE layer whose rows
    lie over more than one data rank counts its capacity over the whole
    batch's group, as one device does (``ids_gather``). A recurrent layer
    steps its state on the rank's rows (``recurrent.STEPS``) with no
    collective: the state lies whole on every rank of a row, replicated
    over ``model`` (and at batch 1 over every axis), as ``cache_specs``
    lays it out, so each rank along ``seq_axes`` repeats that small step,
    as GSPMD's replicated layout does.

    ``params``: whole weights (the batch-1 long-context cells) or this
    rank's ``runtime.sharded.ServeWeights`` (the batched cells, each layer
    gathered when it runs). ``caches``: this rank's slices
    (``init_local_caches``), with the (B,) ``"length"`` the same on every
    rank of a row; tokens (B, 1), the rank's rows. Writes each layer's new
    row on its owning rank and advances the length in place. Returns
    (logits (B, 1, V) or, with ``ServeWeights``, the rank's vocab slice
    (B, 1, V / model), caches).

    Collectives a token (``collectives``): 1 for the embedding with
    ``ServeWeights``; per layer 5 for NSA (6 when a completed compressed
    block's rows lie on another rank) or 2 for dense / ``swa``, 0 for a
    recurrent layer; 1 more for a MoE layer under ``ids_gather``."""
    from repro_torch.models import attention_sharded, model as model_lib, recurrent
    from repro_torch.runtime.sharded import WholeWeights
    kinds = cfg.layer_kinds()
    if cfg.attention not in ("nsa", "dense", "swa") or \
            set(kinds) - {"attn", "moe", *model_lib.RECURRENT_KINDS}:
        raise NotImplementedError(f"{cfg.name}: the sharded decode takes attention, MoE and "
                                  "recurrent stacks")
    w = params if hasattr(params, "layer_params") else WholeWeights(params, cfg)
    prefix_len = caches["length"]
    nsa = cfg.attention == "nsa"
    # which rows complete a compressed block, on the host
    lengths = prefix_len.tolist() if nsa else None
    gather = ids_gather(mesh, seq_axes) if "moe" in kinds else None
    window = model_lib._attn_window(cfg)
    x = w.embed(tokens)
    for i, (cache, kind) in enumerate(zip(caches["layers"], kinds)):
        bp = w.layer_params(i)
        hn = layers.rmsnorm(bp["norm1"], x, cfg.norm_eps)
        if kind in model_lib.RECURRENT_KINDS:
            mix, state = recurrent.STEPS[kind](bp["mix"], cfg, hn, cache["state"])
            for name, t in cache["state"].items():
                t.copy_(state[name])
        elif nsa:
            mix, _, _ = nsa_attend_decode_sharded(bp["mix"], cfg, mesh, hn, cache["kv"],
                                                  cache["cmp"], prefix_len, seq_axes)
            commit_cmp_sharded(bp["mix"], cfg, mesh, cache["kv"], cache["cmp"], prefix_len,
                               seq_axes, lengths)
        else:
            mix, _ = attention_sharded.attend_decode_sharded(bp["mix"], cfg, mesh, hn,
                                                             cache["kv"], prefix_len, seq_axes,
                                                             window)
        x = x + mix
        x = x + model_lib._apply_ffn(bp, cfg, kind,
                                     layers.rmsnorm(bp["norm2"], x, cfg.norm_eps),
                                     moe_gather_ids=gather)[0]
        del bp
    x = layers.rmsnorm(w.final_norm, x, cfg.norm_eps)
    logits = w.logits(x)
    caches["length"].copy_(prefix_len + 1)
    return logits, caches


def init_local_caches(cfg: ModelConfig, batch: int, max_len: int, mesh,
                      seq_axes: Sequence[str], device, shard_sequence: bool = True) -> Dict:
    """This rank's slices of ``model.init_caches(cfg, batch, max_len)``
    under ``sharding.cache_specs(shard_sequence=...)``: with True (the
    batch-1 long-context cells) the sequence over ``seq_axes`` (every
    axis), with False (the batched cells) the rows over the data axes and
    the sequence over ``seq_axes`` = ("model",). K/V and compressed slices
    are zeros; a recurrent layer's state, whole along the sequence, holds
    the initial state of the rank's rows (all of them at batch 1).
    ``"global_rows"`` gives the rows of the whole cache that it holds: "kv"
    and "cmp" along the sequence (a stack with no attention layer holds
    none, but the ranges stay those its K/V would have), "batch" the batch
    rows. The (rows,) ``"length"`` is 0. Raises when S, the batch or (a
    stack with compressed caches) NCB does not divide."""
    from repro_torch.device import dtype_of
    from repro_torch.launch import sharding
    from repro_torch.models import model as model_lib, recurrent
    from repro_torch.models.nsa import init_cmp_cache
    _, idx, n = shard_of(mesh, seq_axes)
    full = model_lib.init_caches(cfg, batch, max_len, "meta")
    NCB = init_cmp_cache(cfg, 1, max_len, torch.float32, "meta")["k_cmp"].shape[1]
    check_shards(max_len, NCB if any("cmp" in c for c in full["layers"]) else 0, n)
    specs = sharding.cache_specs(full, mesh, shard_sequence=shard_sequence)
    for lspec in specs["layers"]:
        if "kv" in lspec:
            seq = lspec["kv"]["k"][1]
            if (seq if isinstance(seq, tuple) else (seq,)) != tuple(seq_axes):
                raise ValueError(f"the cache splits its sequence over {seq}, not "
                                 f"{tuple(seq_axes)}")
            break
    shape = mesh_lib.mesh_shape(mesh)
    b0, nb = 0, 1
    if not shard_sequence:
        b0, nb = mesh_lib.axes_index(mesh, mesh_lib.dp_axes(mesh))
        if batch % nb:
            raise ValueError(f"a batch of {batch} rows does not divide over {nb} data ranks")
    rows = batch // nb
    dtype = dtype_of(cfg.dtype)
    out = []
    for kind, layer, lspec in zip(cfg.layer_kinds(), full["layers"], specs["layers"]):
        if "state" in layer:
            local = sharding.local_shape(next(iter(layer["state"].values())).shape,
                                         next(iter(lspec["state"].values())), shape)
            out.append({"state": recurrent.STATE_INITS[kind](cfg, local[0], device)})
            continue
        out.append({part: {name: torch.zeros(
            sharding.local_shape(t.shape, lspec[part][name], shape),
            dtype=dtype, device=device) for name, t in leaves.items()}
            for part, leaves in layer.items()})
    return {"layers": out, "length": torch.zeros((rows,), dtype=torch.int32, device=device),
            "global_rows": {"kv": (idx * max_len // n, (idx + 1) * max_len // n),
                            "cmp": (idx * NCB // n, (idx + 1) * NCB // n),
                            "batch": (b0 * rows, (b0 + 1) * rows)}}
