"""The train step's sequence mixers on a rank's positions: the
differentiable counterpart of ``prefill_sharded._attention_layer``, without
caches. ``model.block_apply_train`` runs them when ``runtime.sharded``
splits each row's positions over ``model`` (``split``: a
``runtime.sharded.SeqSplit``; the rank holds positions ``[a, b)`` of an
S-position stream).

  * **Attention.** q, k and v of the rank's chunk; k and v all-gathered
    over ``model`` together, in one ``split.gather`` (its backward pass
    reduce-scatters their gradient). NSA builds every compressed block from
    the gathered K/V (``nsa.compress_kv``) and attends for its own queries
    on the single device's query chunks (``nsa.attend_queries(q0=a)``);
    dense and sliding-window layers run ``attention.attend_queries`` over
    the keys up to b (a window may reach into earlier ranks' chunks). Then
    ``wo``.
  * **A recurrent mixer** runs on the chunk alone; the state it enters
    with reaches it from the ``model`` ranks before it, and the gradient
    of that state goes back to them (``recurrent_sharded``'s training
    carries, each a ``torch.autograd.Function`` whose backward pass issues
    its collectives on every rank):

      - RG-LRU: one pass over the chunk (``w_in``, the gate, the conv, the
        coefficients, the scan from h = 0). The conv's window is the
        previous rank's last cw - 1 rows of ``u0`` (``split.carry`` with
        ``previous_window``: an all-gather, reduce-scattered back), and
        the incoming h the fold of the predecessors' (A, h) at their last
        position (``rglru_fold``); the chunk's h is then hh + A h_in, as
        ``recurrent.rglru_prefill`` enters a state. Every chunk a rank
        after it reads must hold cw - 1 positions (else this raises on
        every rank, naming the chunk).
      - mLSTM: the projections once; the chunk's summary from the initial
        state (``mlstm_summary``), folded with ``mlstm_combine`` over the
        predecessors (``mlstm_fold``); the chunk's scan from that state.
      - sLSTM: the lockstep relay and its reverse (``SlstmRelay``) over
        ``split.row_groups`` groups of the rows.

    A layer's activation collectives (a pass of the forward, again in a
    ``remat`` recompute, then the backward): RG-LRU 2 all-gathers and 2
    reduce-scatters, of (m, B, cw - 1, sd) and (m, B, 2, sd) float32;
    mLSTM 1 and 1, of (m, B, H, dh^2 + dh + 2); sLSTM g + m - 1
    all-gathers of (m, 4, B / g, d) each way.

Each rank computes the single device's layer output at its own
positions. Beyond the single device's work an mLSTM computes its chunk's
summary and an sLSTM reruns its chunk's scan in the backward pass (the
relay keeps only each row group's incoming state). The compressed blocks
are rebuilt on every rank from the whole K/V but enter only that rank's
queries' outputs, so the gradient a rank sends back through them (to the
K/V and to ``w_cmp_k`` / ``w_cmp_v``) is its queries' share, and the sums
over ``model`` (``SeqGather``'s backward pass, the weights'
``reduce_grad``) add every share once. The Top-n indices carry no
gradient, as in both packages.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.config import ModelConfig
from repro_torch.launch import sharding
from repro_torch.models import attention, layers, nsa, recurrent, recurrent_sharded


def attention_mix(params, cfg: ModelConfig, h, positions, split, chunk: int = 512):
    """h (B, b - a, d) normed chunk, positions (B, b - a) -> the attention
    output at the chunk's positions (B, b - a, d)."""
    Dh = cfg.head_dim
    q, k, v = attention.qkv(params, cfg, h, positions)
    kv = split.gather(torch.cat([k, v], dim=-1))                  # (B, S, Hkv, 2 Dh)
    k, v = kv[..., :Dh], kv[..., Dh:]
    if cfg.attention == "nsa":
        k_cmp, v_cmp = nsa.compress_kv(params, k, v, cfg.nsa)
        heads = nsa.attend_queries(cfg, q, nsa.gates(params, h, cfg.num_heads), positions,
                                   k, v, k_cmp, v_cmp, q0=split.a, chunk=chunk)
    else:
        window = cfg.window if cfg.attention == "swa" else 0
        heads = attention.attend_queries(cfg, q, k[:, :split.b], v[:, :split.b], split.a,
                                         window, chunk)
    return heads @ params["wo"]


def _check_window(split, rows: int) -> None:
    """Raise, on every rank alike, when a chunk whose last ``rows``
    positions the next rank reads holds fewer."""
    for j in range(split.m - 1):
        a, b = sharding.seq_chunk(split.S, split.m, j)
        if b - a < rows:
            raise ValueError(
                f"the chunk [{a}, {b}) of model rank {j} holds {b - a} positions, fewer than the "
                f"{rows} rows of the RG-LRU conv window that rank {j + 1} reads from it")


def rglru_mix(params, cfg: ModelConfig, h, split):
    """h (B, b - a, d) normed chunk -> the RG-LRU block's output there."""
    cw = params["conv"].shape[0]
    _check_window(split, cw - 1)
    u0 = h @ params["w_in"]
    gate = layers.gelu(h @ params["w_gate_branch"])
    window = split.carry(u0[:, u0.shape[1] - (cw - 1):], recurrent_sharded.previous_window)
    u, _ = recurrent._causal_conv(params["conv"], u0, window)
    a, b = recurrent._rglru_coeffs(params, u)
    A, hh = recurrent._linear_scan(a, b)
    h_in = split.carry(torch.stack([A[:, -1], hh[:, -1]], dim=1), recurrent_sharded.rglru_fold)
    hh = hh + A * h_in[:, None]
    return (hh * gate.float()).to(h.dtype) @ params["w_out"]


def mlstm_mix(params, cfg: ModelConfig, h, split, chunk: int = recurrent.MLSTM_CHUNK):
    """h (B, b - a, d) normed chunk -> the mLSTM block's output there."""
    B, n, d = h.shape
    dh = d // recurrent.mlstm_heads(cfg)
    q, k, v, it, ft = recurrent._mlstm_qkvif(params, cfg, h)
    st = split.carry(recurrent_sharded.mlstm_summary(k, v, it, ft),
                     functools.partial(recurrent_sharded.mlstm_fold, dh=dh))
    hs, _ = recurrent.mlstm_scan(q, k, v, it, ft, recurrent_sharded.mlstm_unpack(st, dh), chunk)
    return recurrent._mlstm_out(params, h, hs.reshape(B, n, d))


def slstm_mix(params, cfg: ModelConfig, h, split):
    """h (B, b - a, d) normed chunk -> the sLSTM block's output there."""
    pre_x = h.float() @ params["w_x"].float()
    hs = recurrent_sharded.slstm_relay(params, cfg, pre_x, split)
    return hs.to(h.dtype) @ params["w_out"]


RECURRENT = {"rglru": rglru_mix, "mlstm": mlstm_mix, "slstm": slstm_mix}


def carry_collectives(cfg: ModelConfig, m: int, B: int, row_groups: int = 1,
                      remat: bool = True, micro_batches: int = 1):
    """(count, bytes) of the recurrent layers' activation collectives in one
    split step on any rank (``MeshLayout.activation_kinds["recurrent"]``;
    a gather counts its output, a reduce-scatter its input): see the
    module docstring, for ``micro_batches`` micro-batches of B rows each."""
    sd, cw = recurrent.rglru_dims(cfg)
    H = recurrent.mlstm_heads(cfg)
    dh, d, g = cfg.d_model // H, cfg.d_model, row_groups
    per = {"rglru": (2, 4 * m * B * (cw + 1) * sd),
           "mlstm": (1, 4 * m * B * H * (dh * dh + dh + 2)),
           "slstm": (g + m - 1, 4 * (g + m - 1) * m * 4 * (B // g) * d)}
    times = (3 if remat else 2) * micro_batches
    kinds = [per[k] for k in cfg.layer_kinds() if k in per]
    return sum(n for n, _ in kinds) * times, sum(b for _, b in kinds) * times
