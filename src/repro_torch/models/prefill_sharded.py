"""The prefill across ranks — what GSPMD makes of the JAX dry run's
``prefill_32k`` step (``repro.launch.specs.build_cell``: ``model.prefill``
under ``param_specs`` with the residual stream constrained by
``activation_constraint``), written out for ``torch.distributed``, for
every stack of attention (NSA, dense or sliding-window), MoE and recurrent
(RG-LRU, mLSTM, sLSTM) blocks.

The layout is the JAX one: the tokens' rows over the data axes, the
residual stream's sequence over ``model`` (``sharding.activation_spec``'s
"sp"), the caches out under ``cache_specs(shard_sequence=False)`` (rows
over the data axes, the sequence over ``model``) and the last position's
logits vocab-split over ``model``. A rank of a data group holds the chunk
``[i * S / m, (i + 1) * S / m)`` of the stream of each of its rows (i its
``model`` index, m the axis' size; S counts a frontend's frames in front
of the tokens, as ``model.embed_inputs`` puts them) and, per layer:

  1. gathers the layer's weights (``runtime.sharded.ServeWeights``);
  2. computes q, k and v of its own chunk;
  3. all-gathers k and v over ``model`` (collective 1);
  4. NSA only: builds its own slice of the compressed blocks with
     ``nsa.compress_kv`` from the gathered rows (a block may straddle two
     chunks) and all-gathers the slices over ``model`` (collective 2), so
     every rank holds every block;
  5. runs attention for its own queries over the whole K/V, on the single
     device's 512-query chunks on their global boundaries: NSA's
     ``nsa.attend_queries`` (and the compressed K/V), or dense / windowed
     ``attention.attend_queries`` (a query's window may reach into the
     previous ranks' chunks);
  6. keeps its slice of the K/V rows (and of the compressed blocks) in its
     caches;
  7. runs the FFN on its own chunk: a MoE layer cuts its dispatch groups
     from the chunk, and they are the single device's groups because the
     single device's group size must divide the chunk (else it raises).

A recurrent layer gathers no K/V: it runs its chunk from the state the
chunks before it leave, passed along the ``model`` ranks
(``recurrent_sharded``: one all-gather for an RG-LRU or an mLSTM, g + m - 1
for an sLSTM's relay over g row groups), keeps the state after the whole
sequence (the same on every rank of the group) in its caches and runs its
FFN, if any, on its chunk as in step 7.

Before the layers each rank embeds the ids in its vocab rows and a
reduce-scatter over ``model`` sums and cuts the chunks (collective 0; a
frontend's frames are projected by the rank whose chunk holds them, from
the ``frontend_proj`` every rank holds); after them the last position's
hidden state, which the last ``model`` rank holds, reaches the others in
one all-reduce (the last), and each computes its vocab slice of the
logits. So 2 (NSA) or 1 (dense, windowed, RG-LRU, mLSTM) or g + m - 1
(sLSTM) per layer and 2 more activation collectives a prefill
(``nsa_sharded.collectives``), besides the weights' gathers
(``MeshLayout.counts``). No work repeats along ``model``. The per-row work
(steps 2, 5, 7 and the recurrent chunks) runs one row at a time, to bound
the attention's (chunk, S) score tensors and a row's sequence tensors; the
collectives carry all rows.

The per-rank compute is plain PyTorch: the JAX prefill runs
``attend_train_nsa`` / ``attend_train`` and its recurrent blocks in plain
``jnp``, no TPU kernel lies on this path.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.launch import mesh as mesh_lib, sharding
from repro_torch.models import attention, layers, model as model_lib, moe as moe_lib
from repro_torch.models import nsa as nsa_lib, nsa_sharded, recurrent, recurrent_sharded
from repro_torch.models.attention import qkv

SEQ_AXES = ("model",)


def takes(cfg: ModelConfig) -> bool:
    """Whether the sharded prefill and the sharded decode take ``cfg``:
    stacks of ``"attn"`` / ``"moe"`` blocks over NSA, dense or
    sliding-window attention and of recurrent blocks."""
    return cfg.attention in ("nsa", "dense", "swa") and \
        set(cfg.layer_kinds()) <= {"attn", "moe", *model_lib.RECURRENT_KINDS}


def moe_group(cfg: ModelConfig, rows: int, S: int, m: int) -> int:
    """The single device's MoE dispatch group for ``rows`` x ``S`` positions
    (0 without MoE layers); raises, naming the arch, S and the group, when
    it does not divide a rank's ``S / m`` positions of a row."""
    if "moe" not in cfg.layer_kinds():
        return 0
    G = moe_lib.group_size(rows * S, cfg.moe)
    if (S // m) % G:
        raise ValueError(f"{cfg.name}: a {S}-position prompt cut over {m} model ranks gives "
                         f"{S // m} positions a rank, which the MoE dispatch group of {G} "
                         "does not divide")
    return G


@torch.no_grad()
def prefill_sharded(view, cfg: ModelConfig, mesh, tokens, max_len: int, chunk: int = 512,
                    frontend=None, trace=None):
    """The rank's part of ``model.prefill(params, cfg, tokens, max_len,
    frontend)`` followed by the logits of the last position (the JAX
    ``prefill_step``).

    ``view``: the rank's ``ServeWeights``; ``tokens`` (B, S): the rank's
    rows (the batch over the data axes), whole along the sequence;
    ``frontend`` (B, F, frontend_dim) their frames, or None. Returns
    (logits (B, 1, V / model): the rank's vocab slice, caches): the rank's
    slices (``nsa_sharded.init_local_caches(shard_sequence=False)``, with
    ``"global_rows"``) holding what ``model.prefill``'s caches hold there,
    lengths F + S. ``trace(i)``, when given, is called after each layer i
    (the dry run's ``--trace`` prints a line per rank there)."""
    if not takes(cfg):
        raise NotImplementedError(f"{cfg.name}: the sharded prefill takes attention, MoE and "
                                  "recurrent stacks")
    window = model_lib._attn_window(cfg)
    group, idx, m = nsa_sharded.shard_of(mesh, SEQ_AXES)
    B = tokens.shape[0]
    F = frontend.shape[1] if frontend is not None else 0
    S = F + tokens.shape[1]
    if S % m:
        raise ValueError(f"a prompt of {S} positions ({F} frames) does not divide over {m} "
                         "model ranks")
    if S > max_len:
        raise ValueError(f"prompt of {S} positions exceeds max_len={max_len}")
    q0, q1 = sharding.seq_chunk(S, m, idx)
    Sl = q1 - q0
    dev = tokens.device
    n_dp = mesh_lib.axes_index(mesh, mesh_lib.dp_axes(mesh))[1]
    G = moe_group(cfg, B * n_dp, S, m)
    caches = nsa_sharded.init_local_caches(cfg, B * n_dp, max_len, mesh, SEQ_AXES, dev,
                                           shard_sequence=False)
    x = view.embed_chunk(tokens, frontend)                                # (B, Sl, D)
    positions = (q0 + torch.arange(Sl, dtype=torch.int32, device=dev))[None]  # (1, Sl)
    for i, (cache, kind) in enumerate(zip(caches["layers"], cfg.layer_kinds())):
        bp = view.layer_params(i)
        if kind in model_lib.RECURRENT_KINDS:
            hn = layers.rmsnorm(bp["norm1"], x, cfg.norm_eps)
            out, state = recurrent_sharded.PREFILL[kind](
                bp["mix"], cfg, hn, recurrent.STATE_INITS[kind](cfg, B, dev), group, idx, m)
            for name, t in cache["state"].items():
                t.copy_(state[name])
            mixed = lambda b, out=out: out[b:b + 1]
            del hn, out, state
        else:
            mixed = _attention_layer(bp, cfg, x, cache, positions, q0, caches["global_rows"],
                                     group, m, window, chunk)
        for b in range(B):
            h = x[b:b + 1] + mixed(b)
            x[b:b + 1] = h + model_lib._apply_ffn(
                bp, cfg, kind, layers.rmsnorm(bp["norm2"], h, cfg.norm_eps),
                moe_by_expert=True, moe_group=G)[0]
        del bp, mixed
        if trace is not None:
            trace(i)
    last = layers.rmsnorm(view.final_norm, x[:, -1:], cfg.norm_eps)
    if idx != m - 1:
        last = torch.zeros_like(last)
    last = nsa_sharded.all_reduce(last, torch.distributed.ReduceOp.SUM, group)
    caches["length"].fill_(S)
    return view.logits(last), caches


def _attention_layer(bp, cfg: ModelConfig, x, cache, positions, q0: int, rows, group, m: int,
                     window: int, chunk: int):
    """Steps 2-6 of an attention layer on the rank's chunk x (B, Sl, D):
    the K/V (and NSA's compressed blocks) all-gathered over ``model``, the
    rank's slices written into ``cache``. Returns ``mixed(b)``: row b's
    attention output (1, Sl, D) for the rank's queries. ``rows``: the
    caches' ``"global_rows"``.

    Only the gathered K/V of all rows stay alive through the layer: each
    row's K/V are written into the send buffer as they are computed, and
    a row's whole sequence of K/V and its queries are made again when the
    row's turn comes. (Holding every row's queries and a second, permuted
    copy of the gathered K/V took pixtral-12b x ``prefill_32k`` at 32 rows
    to the edge of the card on four of them, where a rank ran out of
    memory.)"""
    mix, nsa = bp["mix"], cfg.nsa
    B, Sl, _ = x.shape
    S = Sl * m
    (r0, r1), (c0, c1) = rows["kv"], rows["cmp"]
    norm = lambda b: layers.rmsnorm(bp["norm1"], x[b:b + 1], cfg.norm_eps)
    send = None
    for b in range(B):
        _, k, v = qkv(mix, cfg, norm(b), positions)
        if send is None:
            send = k.new_empty((2, B) + tuple(k.shape[1:]))
        send[0, b], send[1, b] = k[0], v[0]
    kv = nsa_sharded.all_gather(send, group, m)                         # (m, 2, B, Sl, H, Dh)
    del send, k, v

    def row_kv(b):
        """Row b's K/V over the whole sequence, (1, S, H, Dh) each."""
        return tuple(kv[:, i, b].reshape(1, S, *kv.shape[-2:]) for i in (0, 1))

    ncb = nsa_lib.num_cmp_blocks(S, nsa)
    c_hi = min(c1, ncb)
    for b in range(B):
        k, v = row_kv(b)
        if S > r0:
            cache["kv"]["k"][b, :min(r1, S) - r0] = k[0, r0:min(r1, S)]
            cache["kv"]["v"][b, :min(r1, S) - r0] = v[0, r0:min(r1, S)]
        if cfg.attention == "nsa" and c_hi > c0:
            a, z = c0 * nsa.cmp_stride, (c_hi - 1) * nsa.cmp_stride + nsa.cmp_block
            kc, vc = nsa_lib.compress_kv(mix, k[:, a:z], v[:, a:z], nsa)
            cache["cmp"]["k_cmp"][b, :c_hi - c0] = kc[0].to(cache["cmp"]["k_cmp"].dtype)
            cache["cmp"]["v_cmp"][b, :c_hi - c0] = vc[0].to(cache["cmp"]["v_cmp"].dtype)
        del k, v
    if cfg.attention != "nsa":
        def mixed(b):
            q = qkv(mix, cfg, norm(b), positions)[0]
            k, v = row_kv(b)
            heads = attention.attend_queries(cfg, q, k[:, :q0 + Sl], v[:, :q0 + Sl], q0,
                                             window, chunk)
            return heads @ mix["wo"]
        return mixed
    cmp = cache["cmp"]
    every = nsa_sharded.all_gather(torch.stack([cmp["k_cmp"], cmp["v_cmp"]]), group, m)
    every = every.permute(1, 2, 0, 3, 4, 5).reshape(2, B, -1, *every.shape[-2:])
    k_cmp, v_cmp = every[0][:, :ncb], every[1][:, :ncb]
    del every

    def mixed(b):
        hn = norm(b)
        q = qkv(mix, cfg, hn, positions)[0]
        k, v = row_kv(b)
        heads = nsa_lib.attend_queries(
            cfg, q, nsa_lib.gates(mix, hn, cfg.num_heads), positions,
            k, v, k_cmp[b:b + 1], v_cmp[b:b + 1], q0=q0, chunk=chunk)
        return heads @ mix["wo"]
    return mixed
