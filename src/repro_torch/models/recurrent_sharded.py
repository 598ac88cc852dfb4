"""The recurrent blocks' prefill across the ``model`` ranks of a data group:
what GSPMD makes of the JAX dry run's ``prefill_32k`` step for the RG-LRU,
mLSTM and sLSTM layers (``repro.models.model._rglru_prefill`` /
``_xlstm_prefill`` with the residual stream's sequence over ``model``),
written out for ``torch.distributed``.

Rank i of the group holds the chunk ``[i * S / m, (i + 1) * S / m)`` of each
of its rows (``models.prefill_sharded``). A chunk needs the state that the
chunks before it leave, and the state after the whole sequence is the
cache's, replicated over ``model`` (``sharding.cache_specs``: the rows over
the data axes). Each kind carries it along the ranks its own way:

  * **RG-LRU** (h_t = a_t h_{t-1} + b_t, linear in h): each rank scans the
    positions of its chunk whose conv window lies inside it (from ``cw -
    1`` on) from h = 0, which gives the chunk's ``A`` (the product of its
    a) and last h, and one all-gather over ``model`` carries every rank's
    (first ``cw - 1`` rows of ``u0``, last ``cw - 1`` rows of ``u0``, A,
    last h). The first ``cw - 1`` positions' coefficients depend on the
    previous chunk's conv window, so each rank folds the chunks in order
    from the initial state: the window is the previous chunk's last rows,
    those positions step one by one, and h_out = A h + h_last. A rank's
    incoming state is the fold of its predecessors; the fold of all m is
    the final state, the same on every rank.
  * **mLSTM**: each rank runs its chunk from the initial state (C = 0, n =
    0, m = -1e30), which gives its summary (C_l, n_l, m_l) and its total
    log forget gate F_c, and one all-gather carries every rank's. A chunk
    from an incoming state (C, n, m) leaves m' = max(F_c + m, m_l), C' =
    exp(F_c + m - m') C + exp(m_l - m') C_l, n' likewise: each rank folds
    its predecessors, and all m for the final state.
  * **sLSTM** (its gates read h through ``w_h``, so no parallel form): a
    relay. Rank i scans a group of rows from the state that rank i - 1 left
    it and hands its state on. The rows run in ``row_groups`` groups g, in
    lockstep steps: at step s rank i scans group s - i, and one all-gather
    over ``model`` then carries every rank's new state, of which rank i + 1
    takes rank i's and every rank keeps the last rank's (the final state
    of that group). g + m - 1 steps, each rank idle in m - 1 of them: an
    idle share of (m - 1) / (g + m - 1). The all-gathers are the same calls
    in the same order on every rank, so the relay cannot deadlock under
    gloo or NCCL, and they carry CUDA tensors through gloo as well.

After the exchange each rank computes its chunk's outputs from its
incoming state (the RG-LRU and mLSTM run their chunk a second time, from
that state; a row at a time, so each pass holds one row's sequence
tensors). Collectives a layer (``nsa_sharded.collectives``): 1 for an
RG-LRU or an mLSTM, g + m - 1 for an sLSTM. The per-rank compute is plain
PyTorch, as the JAX recurrent paths are plain ``jnp``: no TPU kernel lies
on this path.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import nsa_sharded, recurrent
from repro_torch.models.recurrent import (_causal_conv, _linear_scan, _log_sigmoid,
                                          _mlstm_qkvif, _rglru_coeffs)


def _rows(state, a: int, b: int) -> Dict[str, torch.Tensor]:
    return {n: t[a:b] for n, t in state.items()}


# =================================================================== RG-LRU
@torch.no_grad()
def rglru_prefill_sharded(params, cfg: ModelConfig, x, state, group, idx: int, m: int):
    """x (B, Sl, d): the rank's chunk of its rows (rank ``idx`` of the
    ``m`` ranks of ``group``); ``state``: the rows' state before the
    sequence. Returns (out (B, Sl, d), the state after the sequence, the
    same on every rank of the group). One all-gather."""
    B, Sl, _ = x.shape
    cw = params["conv"].shape[0]
    if Sl < cw:
        raise ValueError(f"a chunk of {Sl} positions is shorter than the conv width {cw}")
    parts = []
    for b in range(B):
        u0 = x[b:b + 1] @ params["w_in"]
        u, _ = _causal_conv(params["conv"], u0)
        a, bb = _rglru_coeffs(params, u[:, cw - 1:])
        A, h = _linear_scan(a, bb)
        parts.append(torch.cat([u0[:, :cw - 1].float(), u0[:, Sl - (cw - 1):].float(),
                                A[:, -1:], h[:, -1:]], dim=1))
        del u0, u, a, bb, A, h
    every = nsa_sharded.all_gather(torch.cat(parts), group, m)          # (m, B, 2 cw, sd)
    del parts
    h, window = state["h"].float(), state["conv"].float()
    h_in = w_in = None
    for j in range(m):
        if j == idx:
            h_in, w_in = h, window
        head, tail = every[j][:, :cw - 1], every[j][:, cw - 1:2 * (cw - 1)]
        u, _ = _causal_conv(params["conv"], head.to(x.dtype), window)
        a, bb = _rglru_coeffs(params, u)
        for t in range(cw - 1):
            h = a[:, t] * h + bb[:, t]
        h = every[j][:, -2] * h + every[j][:, -1]
        window = tail
    out = torch.cat([recurrent.rglru_prefill(params, cfg, x[b:b + 1],
                                             {"h": h_in[b:b + 1], "conv": w_in[b:b + 1]})[0]
                     for b in range(B)])
    return out, {"h": h, "conv": window}


# =================================================================== mLSTM
def mlstm_combine(state, summary):
    """The state after a chunk, from the state before it and the chunk's
    summary {"F", "C", "n", "m"} (its total log forget gate and its state
    from the initial one). A first m of -1e30 is finite: its weight
    underflows to 0."""
    m_in = state["m"]
    lin = summary["F"] + m_in
    m_out = torch.maximum(lin, summary["m"])
    w_in, w_l = torch.exp(lin - m_out), torch.exp(summary["m"] - m_out)
    return {"C": w_in[..., None, None] * state["C"] + w_l[..., None, None] * summary["C"],
            "n": w_in[..., None] * state["n"] + w_l[..., None] * summary["n"], "m": m_out}


@torch.no_grad()
def mlstm_prefill_sharded(params, cfg: ModelConfig, x, state, group, idx: int, m: int,
                          chunk: int = recurrent.MLSTM_CHUNK):
    """``rglru_prefill_sharded``'s contract for an mLSTM layer. One
    all-gather of every rank's summary."""
    B, Sl, d = x.shape
    H = recurrent.mlstm_heads(cfg)
    dh = d // H
    parts = []
    for b in range(B):
        q, k, v, it, ft = _mlstm_qkvif(params, cfg, x[b:b + 1])
        _, st = recurrent.mlstm_scan(q, k, v, it, ft,
                                     recurrent.mlstm_init_state(cfg, 1, x.device), chunk)
        F = _log_sigmoid(ft).double().sum(1).float()                      # (1, H)
        parts.append(torch.cat([st["C"].reshape(1, H, dh * dh), st["n"],
                                st["m"][..., None], F[..., None]], dim=-1))
        del q, k, v, it, ft, st
    every = nsa_sharded.all_gather(torch.cat(parts), group, m)          # (m, B, H, dh^2 + dh + 2)
    del parts
    st, st_in = {n: t.float() for n, t in state.items()}, None
    for j in range(m):
        if j == idx:
            st_in = st
        e = every[j]
        st = mlstm_combine(st, {"C": e[..., :dh * dh].reshape(B, H, dh, dh),
                                "n": e[..., dh * dh:dh * dh + dh], "m": e[..., -2],
                                "F": e[..., -1]})
    out = torch.cat([recurrent.mlstm_prefill(params, cfg, x[b:b + 1], _rows(st_in, b, b + 1),
                                             chunk)[0] for b in range(B)])
    return out, st


# =================================================================== sLSTM
@torch.no_grad()
def slstm_prefill_sharded(params, cfg: ModelConfig, x, state, group, idx: int, m: int,
                          row_groups: int = 1):
    """``rglru_prefill_sharded``'s contract for an sLSTM layer: the relay
    over ``row_groups`` groups of rows (which must divide B), g + m - 1
    all-gathers, each rank's scan eager. The prefill takes g = 1: a step
    of the scan costs the same launches whatever its rows, so g groups
    cost g + m - 1 group scans in sequence where one costs m (at m = 2 an
    idle share of 1/2 a rank)."""
    B = x.shape[0]
    g = row_groups
    if B % g:
        raise ValueError(f"{B} rows do not divide into {g} row groups")
    r = B // g
    names = tuple(state)
    pack = lambda st: torch.stack([st[n].float() for n in names])        # (4, r, d)
    unpack = lambda t: {n: t[i] for i, n in enumerate(names)}
    outs, finals = [None] * g, [None] * g
    take = None                                   # the state rank idx - 1 handed on
    for s in range(g + m - 1):
        j = s - idx
        if 0 <= j < g:
            st0 = _rows(state, j * r, (j + 1) * r) if idx == 0 else unpack(take)
            outs[j], st = recurrent.slstm_prefill(
                params, cfg, x[j * r:(j + 1) * r], state={n: t.float() for n, t in st0.items()})
            mine = pack(st)
        else:
            mine = torch.zeros((len(names), r, cfg.d_model), device=x.device)
        every = nsa_sharded.all_gather(mine, group, m)                   # (m, 4, r, d)
        if idx > 0:
            take = every[idx - 1]
        if 0 <= s - (m - 1) < g:
            finals[s - (m - 1)] = every[m - 1]
    return torch.cat(outs), unpack(torch.cat(finals, dim=1))


PREFILL = {"rglru": rglru_prefill_sharded, "mlstm": mlstm_prefill_sharded,
           "slstm": slstm_prefill_sharded}


# =================================================================== training
# The split train step's carries (``models.train_sharded``): the same folds
# and relay with a backward pass. A fold is ``runtime.sharded.ModelCarry``'s
# ``fold(every, idx)``: every rank's summary (m, ...) in float32 -> this
# rank's incoming state, from the initial state of training.
def previous_window(every, idx: int):
    """The RG-LRU conv window: the last cw - 1 rows of ``u0`` of rank idx -
    1 (every (m, B, cw - 1, sd)), zeros (the initial window) on rank 0."""
    return every[idx - 1] if idx > 0 else torch.zeros_like(every[0])


def rglru_fold(every, idx: int):
    """every (m, B, 2, sd): each chunk's (A, h) at its last position (the
    product of its a, its scan from h = 0) -> the incoming h (B, sd): h =
    A_j h + h_j over the predecessors in order, from h = 0."""
    h = torch.zeros_like(every[0, :, 0])
    for j in range(idx):
        h = every[j, :, 0] * h + every[j, :, 1]
    return h


def mlstm_summary(k, v, it, ft):
    """The chunk's state from the initial one, packed (B, H, dh^2 + dh +
    2): C, n, m and F (its total log forget gate). The last row of
    ``recurrent._mlstm_chunk`` over the whole chunk, in closed form: with
    F_t the cumulative log forget gate, position s enters at log weight
    F_L - F_s + i_s, m is their max (the initial m of -1e30 enters at F_L -
    1e30 and never wins), and C, n are the weighted sums. O(L dh^2) a
    head, no (L, L) matrix; the chunk's own outputs are not computed."""
    B, L, H, dh = k.shape
    F = torch.cumsum(recurrent._log_sigmoid(ft).double(), dim=1)          # (B, L, H)
    total = F[:, -1]
    logw = (total[:, None] - F).float() + it
    m = logw.amax(1)                                                      # (B, H)
    w = torch.exp(logw - m[:, None])
    C = torch.einsum("bsh,bshi,bshj->bhij", w, v, k)
    n = torch.einsum("bsh,bshj->bhj", w, k)
    return torch.cat([C.reshape(B, H, dh * dh), n, m[..., None], total.float()[..., None]],
                     dim=-1)


def mlstm_unpack(st, dh: int):
    """(B, H, dh^2 + dh + 1 [+ 1]) -> {"C", "n", "m"} (and "F" when there)."""
    B, H = st.shape[:2]
    out = {"C": st[..., :dh * dh].reshape(B, H, dh, dh), "n": st[..., dh * dh:dh * dh + dh],
           "m": st[..., dh * dh + dh]}
    if st.shape[-1] == dh * dh + dh + 2:
        out["F"] = st[..., -1]
    return out


def mlstm_fold(every, idx: int, dh: int):
    """every (m, B, H, dh^2 + dh + 2): each chunk's ``mlstm_summary`` ->
    the incoming state packed (B, H, dh^2 + dh + 1): ``mlstm_combine`` over
    the predecessors in order, from the initial state."""
    B, H = every.shape[1:3]
    st = {"C": every.new_zeros((B, H, dh, dh)), "n": every.new_zeros((B, H, dh)),
          "m": every.new_full((B, H), -1e30)}
    for j in range(idx):
        st = mlstm_combine(st, mlstm_unpack(every[j], dh))
    return torch.cat([st["C"].reshape(B, H, dh * dh), st["n"], st["m"][..., None]], dim=-1)


_SLSTM_STATE = ("c", "n", "h", "m")


class SlstmRelay(torch.autograd.Function):
    """The sLSTM scan over a rank's chunk, its state relayed along
    ``model`` (``slstm_prefill_sharded``'s lockstep relay: g + m - 1 steps
    over ``split.row_groups`` groups g of the rows, one all-gather of every
    rank's new state a step). Backward: the reverse relay, g + m - 1
    lockstep steps in which rank i takes the gradient of its outgoing state
    from rank i + 1 (the last rank's is zero: training reads no final
    state), reruns its group's scan from the incoming state it kept and
    differentiates it (``torch.autograd.grad``), and hands the gradient of
    its incoming state to rank i - 1 in one all-gather. Every rank issues
    every step's collective, idle or not."""

    @staticmethod
    def forward(ctx, pre_x, w_h, b, split, cfg):
        layout, idx, m, g = split.layout, split.idx, split.m, split.row_groups
        B, _, d4 = pre_x.shape
        d = d4 // 4
        if B % g:
            raise ValueError(f"{B} rows do not divide into {g} row groups")
        r = B // g
        params = {"w_h": w_h, "b": b}
        init = recurrent.slstm_init_state(cfg, r, pre_x.device)
        outs, ins, take = [None] * g, [None] * g, None
        for s in range(g + m - 1):
            j = s - idx
            if 0 <= j < g:
                st0 = init if idx == 0 else dict(zip(_SLSTM_STATE, take.unbind()))
                outs[j], st = recurrent._slstm_scan(params, pre_x[j * r:(j + 1) * r], st0)
                ins[j] = torch.stack([st0[n] for n in _SLSTM_STATE])
                mine = torch.stack([st[n] for n in _SLSTM_STATE])
                layout.relay_steps["busy"] += 1
            else:
                mine = pre_x.new_zeros((len(_SLSTM_STATE), r, d))
                layout.relay_steps["idle"] += 1
            every = layout.gather_model(mine, "recurrent")                 # (m, 4, r, d)
            take = every[idx - 1] if idx > 0 else None
        ctx.split = split
        ctx.save_for_backward(pre_x, w_h, b, torch.stack(ins))
        return torch.cat(outs)

    @staticmethod
    def backward(ctx, g_hs):
        pre_x, w_h, b, ins = ctx.saved_tensors
        split = ctx.split
        layout, idx, m, g = split.layout, split.idx, split.m, split.row_groups
        r = pre_x.shape[0] // g
        g_pre = torch.zeros_like(pre_x)
        g_wh, g_b = torch.zeros_like(w_h), torch.zeros_like(b)
        g_out = None                          # the gradient of this rank's outgoing state
        for s in range(g + m - 1):
            j = s - (m - 1 - idx)
            if 0 <= j < g:
                rows = slice(j * r, (j + 1) * r)
                with torch.enable_grad():
                    px = pre_x[rows].detach().requires_grad_(True)
                    wh, bb = w_h.detach().requires_grad_(True), b.detach().requires_grad_(True)
                    st0 = ins[j].detach().requires_grad_(True)
                    hs, st = recurrent._slstm_scan({"w_h": wh, "b": bb}, px,
                                                   dict(zip(_SLSTM_STATE, st0.unbind())))
                    outs, grads = [hs], [g_hs[rows]]
                    if g_out is not None:
                        outs += [st[n] for n in _SLSTM_STATE]
                        grads += list(g_out.unbind())
                    d_px, d_wh, d_b, d_st0 = torch.autograd.grad(
                        outs, (px, wh, bb, st0), grads, allow_unused=True)
                g_pre[rows] = d_px
                g_wh += d_wh
                g_b += d_b
                mine = torch.zeros_like(st0) if d_st0 is None else d_st0
            else:
                mine = ins.new_zeros(ins.shape[1:])
            every = layout.gather_model(mine, "recurrent")                 # (m, 4, r, d)
            g_out = every[idx + 1] if idx < m - 1 else None
        return g_pre, g_wh, g_b, None, None


def slstm_relay(params, cfg: ModelConfig, pre_x, split):
    """pre_x (B, n, 4d) float32, the chunk's input projections -> its h
    (B, n, d) float32 (``SlstmRelay``)."""
    return SlstmRelay.apply(pre_x, params["w_h"], params["b"], split, cfg)
