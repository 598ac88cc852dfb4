"""Recurrent sequence-mixing blocks: RG-LRU (Griffin / RecurrentGemma) and
xLSTM (sLSTM + mLSTM) — the PyTorch counterparts of
``repro.models.recurrent``.

These blocks hold no K/V cache, so NSA selection does not apply to them;
speculative verification runs through *state replay*: the draft tree's
tokens are stepped through the recurrence in topological order, each node
from its parent's state (``verify_states``), so accept/reject semantics
match the attention path. A layer's serving cache is its state, a dict of
(B, ...) tensors.

Over a prompt, and in training: RG-LRU's linear recurrence h_t = a_t
h_{t-1} + b_t runs as an inclusive scan in log2(S) doubling steps
(``_linear_scan``; JAX uses ``jax.lax.associative_scan``, a different
tree, so the two agree to f32 rounding); the mLSTM chunkwise, its parallel
form inside chunks of ``MLSTM_CHUNK`` positions with the state carried from
chunk to chunk (``mlstm_prefill``); the sLSTM, whose gates read the previous
h, one time step after another, as the JAX ``lax.scan`` does (a serving
prefill on the card replays them in captured chunks, ``SlstmGraphs``). The
projections that do not depend on the state run for the whole sequence
first. Each prefill starts from a given state (the initial one by
default), so a chunk of a sequence continues where the one before it ended
(``models.recurrent_sharded`` passes the state along the ranks).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import gc_paused
from repro_torch.models import layers

RGLRU_C = 8.0  # Griffin's fixed exponent scale


def rglru_dims(cfg: ModelConfig):
    """(state dim, conv width) of an RG-LRU block."""
    rec = cfg.recurrent
    sd = (rec.state_dim or cfg.d_model) if rec else cfg.d_model
    return sd, (rec.conv_width if rec else 4)


def mlstm_heads(cfg: ModelConfig) -> int:
    rec = cfg.recurrent
    return rec.num_heads if (rec and rec.num_heads) else cfg.num_heads


def _log_sigmoid(x):
    """log sigmoid(x) = -softplus(-x), as ``-jax.nn.softplus(-x)``."""
    return -F.softplus(-x)


# =================================================================== RG-LRU
def _causal_conv(conv_w, x, window=None):
    """Depthwise causal conv. x (B, S, sd); conv_w (cw, sd); ``window`` (B,
    cw - 1, sd): the inputs before x (a state's ``"conv"``), zeros when
    None. Returns (out, the last cw - 1 inputs in x's dtype: the window a
    step after the last position sees)."""
    cw = conv_w.shape[0]
    pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2])) if window is None else \
        window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * conv_w[i] for i in range(cw))
    return out, xp[:, xp.shape[1] - (cw - 1):]


def _rglru_coeffs(params, u):
    """u (..., sd), the conv output -> (a, b) of h_t = a * h_{t-1} + b."""
    uf = u.float()
    r = torch.sigmoid(uf @ params["w_a"].float())
    i = torch.sigmoid(uf @ params["w_x"].float())
    log_a = -RGLRU_C * r * F.softplus(-params["lam"])           # log sigmoid(lam)^(c r)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (i * uf)
    return a, b


def _linear_scan(a, b):
    """Inclusive scan along dim 1 of h_t = a_t h_{t-1} + b_t from h = 0:
    Hillis-Steele doubling over the combine (a1, b1) . (a2, b2) = (a1 a2,
    a2 b1 + b2), log2(S) steps of whole-sequence elementwise ops (no
    in-place writes, so autograd runs through it). Returns (A, h), each (B,
    S, ...): A_t = a_1 ... a_t, the factor by which h_t carries a state from
    before the sequence, and h from h = 0."""
    S, off = a.shape[1], 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def rglru_prefill(params, cfg: ModelConfig, x, state=None):
    """x (B, S, d) -> (out (B, S, d), the state after the last position):
    ``rglru_apply_train`` plus the JAX ``model._rglru_prefill`` state, from
    ``state`` ({"h", "conv"}: h_0 and the conv window; the initial state,
    zeros, when None): h_t = A_t h_0 + the scan from 0."""
    u0 = x @ params["w_in"]
    gate = layers.gelu(x @ params["w_gate_branch"])
    u, conv_state = _causal_conv(params["conv"], u0, None if state is None else state["conv"])
    a, b = _rglru_coeffs(params, u)
    A, hh = _linear_scan(a, b)
    if state is not None:
        hh = hh + A * state["h"].float()[:, None]
    out = (hh * gate.float()).to(x.dtype) @ params["w_out"]
    return out, {"h": hh[:, -1], "conv": conv_state}


def rglru_apply_train(params, cfg: ModelConfig, x):
    """x (B, S, d) -> (B, S, d) over the whole sequence."""
    return rglru_prefill(params, cfg, x)[0]


def rglru_init_state(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    sd, cw = rglru_dims(cfg)
    return {"h": torch.zeros((batch, sd), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, sd), dtype=torch.float32, device=device)}


# =================================================================== mLSTM
def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    """m starts at -1e30, as in JAX, so the first step's forget term
    underflows to exactly 0."""
    H = mlstm_heads(cfg)
    dh = cfg.d_model // H
    return {"C": torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
            "m": torch.full((batch, H), -1e30, dtype=torch.float32, device=device)}


def _mlstm_qkvif(params, cfg: ModelConfig, x):
    """x (B, S, d) -> q, k, v (B, S, H, dh) f32 (q and k scaled by
    1/sqrt(dh)), the log input gate and the pre-sigmoid forget gate (B, S,
    H)."""
    H = mlstm_heads(cfg)
    B, S, d = x.shape
    dh = d // H
    scale = math.sqrt(dh)
    q = (x @ params["wq"]).reshape(B, S, H, dh).float() / scale
    k = (x @ params["wk"]).reshape(B, S, H, dh).float() / scale
    v = (x @ params["wv"]).reshape(B, S, H, dh).float()
    xf = x.float()
    return q, k, v, xf @ params["wi"], xf @ params["wf"] + params["bf"]


def mlstm_step_state(state, q, k, v, it, ft):
    """One stabilized mLSTM step: q, k, v (B, H, dh), it, ft (B, H) at one
    time index. Returns (new state, h (B, H, dh))."""
    logf = _log_sigmoid(ft)
    m_new = torch.maximum(logf + state["m"], it)
    fg = torch.exp(logf + state["m"] - m_new)
    ig = torch.exp(it - m_new)
    C = (fg[..., None, None] * state["C"]
         + ig[..., None, None] * (v[..., :, None] * k[..., None, :]))
    n = fg[..., None] * state["n"] + ig[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", C, q)
    den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", n, q)), min=1.0)
    return {"C": C, "n": n, "m": m_new}, num / den[..., None]


def _mlstm_out(params, x, hs):
    """hs (B, S, d) f32 -> the block output through the output gate."""
    o = torch.sigmoid((x @ params["wo_gate"]).float())
    return (hs * o).to(x.dtype) @ params["w_out"]


MLSTM_CHUNK = 256         # positions of the mLSTM's parallel form per chunk


def _mlstm_chunk(q, k, v, it, logf, state):
    """One chunk of the mLSTM from ``state`` in the parallel form: q, k, v
    (B, L, H, dh), it and logf = log sigmoid(ft) (B, L, H) at its L
    positions. The stabilized step recurrence unrolled: with F_t the
    chunk's cumulative log forget gate (float64, so differences of sums
    keep f32 accuracy), position s adds its k, v at log weight F_t - F_s +
    i_s at t >= s and the incoming state (C, n) enters at F_t + m_in, and
    m_t = max(F_t + m_in, max_{s <= t} (F_t - F_s + i_s)) is the step's
    stabilizer. An initial m_in of -1e30 is finite, so exp(F_t + m_in -
    m_t) underflows to 0 with no inf - inf. h_t = the weighted sum of (q_t .
    k_s) v_s and of C_in q_t over max(|the same with n|, 1), all scaled by
    exp(-m_t), as ``mlstm_step_state``'s. Returns (h (B, L, H, dh), the
    state after the chunk: the last row's sums)."""
    L = q.shape[1]
    F = torch.cumsum(logf.double(), dim=1).transpose(1, 2)                 # (B, H, L)
    logd = (F[..., :, None] - F[..., None, :]).float() + it.transpose(1, 2)[..., None, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    logd = logd.masked_fill(~causal, -math.inf)
    inter = F.float() + state["m"][..., None]                              # (B, H, L)
    m = torch.maximum(logd.amax(-1), inter)
    dmat = torch.exp(logd - m[..., None])
    w_in = torch.exp(inter - m)                                            # (B, H, L)
    sc = dmat * torch.einsum("bthd,bshd->bhts", q, k)
    num = torch.einsum("bhts,bshd->bthd", sc, v) + \
        w_in.transpose(1, 2)[..., None] * torch.einsum("bhij,bthj->bthi", state["C"], q)
    den = sc.sum(-1) + w_in * torch.einsum("bhj,bthj->bht", state["n"], q)
    h = num / torch.clamp(torch.abs(den), min=1.0).transpose(1, 2)[..., None]
    last, w_last = dmat[:, :, -1], w_in[..., -1]                           # (B, H, L), (B, H)
    C = w_last[..., None, None] * state["C"] + torch.einsum("bhs,bshi,bshj->bhij", last, v, k)
    n = w_last[..., None] * state["n"] + torch.einsum("bhs,bshj->bhj", last, k)
    return h, {"C": C, "n": n, "m": m[..., -1]}


def mlstm_scan(q, k, v, it, ft, state, chunk: int = MLSTM_CHUNK):
    """The mLSTM cell over q, k, v (B, S, H, dh), it, ft (B, S, H) from
    ``state``, chunk after chunk (the last may be shorter): (h (B, S, H,
    dh), the state after the last position). O(chunk^2) memory a head."""
    logf = _log_sigmoid(ft)
    hs = []
    for t0 in range(0, q.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        h, state = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], it[:, sl], logf[:, sl], state)
        hs.append(h)
    return torch.cat(hs, dim=1), state


def mlstm_prefill(params, cfg: ModelConfig, x, state=None, chunk: int = MLSTM_CHUNK):
    """x (B, S, d) -> (out (B, S, d), the state after the last position)
    from ``state`` (the initial state when None), chunkwise
    (``mlstm_scan``): equal to stepping the cell (the JAX
    ``model._xlstm_prefill``) to f32 rounding, with no per-position
    launches."""
    B, S, d = x.shape
    q, k, v, it, ft = _mlstm_qkvif(params, cfg, x)
    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    h, state = mlstm_scan(q, k, v, it, ft, state, chunk)
    return _mlstm_out(params, x, h.reshape(B, S, d)), state


def mlstm_apply_train(params, cfg: ModelConfig, x):
    """x (B, S, d) -> (B, S, d): the chunkwise form, differentiable."""
    return mlstm_prefill(params, cfg, x)[0]


# =================================================================== sLSTM
def slstm_init_state(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model

    def full(v):
        return torch.full((batch, d), v, dtype=torch.float32, device=device)

    return {"c": full(0.0), "n": full(1.0), "h": full(0.0), "m": full(0.0)}


def slstm_step_state(params, state, pre_x):
    """One sLSTM step from the input projection pre_x = x_t @ w_x (B, 4d)
    f32. Returns (new state, h (B, d))."""
    pre = pre_x + state["h"] @ params["w_h"] + params["b"]
    z, i, f, o = pre.chunk(4, dim=-1)
    logf = _log_sigmoid(f)
    m_new = torch.maximum(logf + state["m"], i)
    ig = torch.exp(i - m_new)
    fg = torch.exp(logf + state["m"] - m_new)
    c = fg * state["c"] + ig * torch.tanh(z)
    n = fg * state["n"] + ig
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}, h


SLSTM_CHUNK = 64          # time steps per captured graph of the sLSTM scan


class _SlstmChunk:
    """SLSTM_CHUNK steps of one sLSTM layer's scan captured as one CUDA
    graph on static buffers (the input projections in, the state carried
    in place, the h of each step out): a prompt's scan replays it once per
    chunk instead of launching ~15 kernels per position. The graph reads
    the layer's ``w_h`` and ``b`` where they live."""

    def __init__(self, params, B: int, d: int, device, pool, stream):
        self.x = torch.zeros((B, SLSTM_CHUNK, 4 * d), device=device)
        self.h = torch.zeros((B, SLSTM_CHUNK, d), device=device)
        self.state = {n: torch.zeros((B, d), device=device) for n in ("c", "n", "h", "m")}
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):                   # warm up off the capture
            self._body(params)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with gc_paused(), torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self._body(params)

    def _body(self, params):
        st = self.state
        for t in range(SLSTM_CHUNK):
            st, h = slstm_step_state(params, st, self.x[:, t])
            self.h[:, t].copy_(h)
        for n, buf in self.state.items():
            buf.copy_(st[n])


class SlstmGraphs:
    """The captured sLSTM chunks of the models one owner serves (an engine
    holds one for its target and draft), by layer and batch, freed with
    the owner. They capture into the owner's graph pool on its capture
    stream (``pool`` and ``stream`` are called at the first capture), or
    else into a pool and on a stream of their own."""

    def __init__(self, device, pool=None, stream=None):
        self.device = device
        self._pool = pool or functools.lru_cache(None)(torch.cuda.graph_pool_handle)
        self._stream = stream or functools.lru_cache(None)(lambda: torch.cuda.Stream(device))
        self._chunks: Dict[tuple, _SlstmChunk] = {}

    def chunk(self, params, B: int, d: int) -> _SlstmChunk:
        key = (id(params["w_h"]), B)      # the owner keeps its params alive
        if key not in self._chunks:
            self._chunks[key] = _SlstmChunk(params, B, d, self.device, self._pool(),
                                            self._stream())
        return self._chunks[key]


def _slstm_scan(params, pre_x, state, graphs: Optional[SlstmGraphs] = None):
    """The sLSTM cell over pre_x (B, S, 4d) from ``state``: (h (B, S, d),
    the final state). With ``graphs`` (a CUDA device, outside autograd),
    whole chunks replay a captured ``_SlstmChunk``; the rest (and the CPU)
    steps eagerly. The same operations either way."""
    B, S, _ = pre_x.shape
    hs, t = [], 0
    if graphs is not None and S >= SLSTM_CHUNK:
        chunk = graphs.chunk(params, B, pre_x.shape[-1] // 4)
        for n, buf in chunk.state.items():
            buf.copy_(state[n])
        while t + SLSTM_CHUNK <= S:
            chunk.x.copy_(pre_x[:, t:t + SLSTM_CHUNK])
            chunk.graph.replay()
            hs.append(chunk.h.clone())
            t += SLSTM_CHUNK
        state = {n: buf.clone() for n, buf in chunk.state.items()}
    for t in range(t, S):
        state, h = slstm_step_state(params, state, pre_x[:, t])
        hs.append(h[:, None])
    return torch.cat(hs, dim=1), state


def slstm_prefill(params, cfg: ModelConfig, x, graphs: Optional[SlstmGraphs] = None,
                  state=None):
    """x (B, S, d) -> (out (B, S, d), the state after the last step) from
    ``state`` (the initial state when None); ``graphs``: see
    ``_slstm_scan``."""
    pre_x = x.float() @ params["w_x"].float()                    # (B, S, 4d)
    if state is None:
        state = slstm_init_state(cfg, x.shape[0], x.device)
    hs, state = _slstm_scan(params, pre_x, state, graphs)
    return hs.to(x.dtype) @ params["w_out"], state


def slstm_apply_train(params, cfg: ModelConfig, x):
    return slstm_prefill(params, cfg, x)[0]


# ================================================= recurrent kind dispatch
TRAIN = {"rglru": rglru_apply_train, "mlstm": mlstm_apply_train, "slstm": slstm_apply_train}
PREFILL = {"rglru": rglru_prefill, "mlstm": mlstm_prefill, "slstm": slstm_prefill}
STATE_INITS = {"rglru": rglru_init_state, "mlstm": mlstm_init_state,
               "slstm": slstm_init_state}


class TreeIndex:
    """A draft tree's static index tensors on one device, built once per
    (parents, conv width, device) and cached, so a captured step replays
    the same tensors and makes no host-to-device copy: the nodes of each
    depth (parents before children) with their parents' buffer slots, and
    for an RG-LRU conv window each node's cw taps, oldest first, as
    positions in [committed conv window (cw - 1) | the T nodes' inputs]."""

    def __init__(self, parents: Sequence[int], cw: int, device):
        parents = [int(p) for p in parents]
        T = len(parents)
        depth = []
        for p in parents:
            depth.append(0 if p < 0 else depth[p] + 1)
        self.levels = []
        for d in range(max(depth) + 1 if T else 0):
            nodes = [i for i in range(T) if depth[i] == d]
            self.levels.append((torch.as_tensor(nodes, device=device),
                                torch.as_tensor([n + 1 for n in nodes], device=device),
                                torch.as_tensor([parents[n] + 1 for n in nodes], device=device)))
        taps = []
        for i in range(T):
            row = []
            for j in range(cw):
                up, node = cw - 1 - j, i          # tap j is `up` steps above node i
                while up and node >= 0:
                    node, up = parents[node], up - 1
                row.append(cw - 1 + node if node >= 0 else cw - 2 - up)
            taps.append(row)
        self.taps = torch.as_tensor(taps, dtype=torch.long, device=device).reshape(T, cw)


@functools.lru_cache(maxsize=64)
def _tree_index(parents: tuple, cw: int, device: torch.device) -> TreeIndex:
    return TreeIndex(parents, cw, device)


def tree_index(parents: Sequence[int], cw: int, device) -> TreeIndex:
    return _tree_index(tuple(int(p) for p in parents), cw, torch.device(device))


def _level_step(buf, slots, parent_slots, step, *inputs):
    """One depth of the tree: gather the parents' states (L, B, ...), step
    the L x B rows at once through ``step(state, *inputs)`` (inputs (L, B,
    ...)), write the post-states to the nodes' slots. Returns the step's
    output (L, B, ...)."""
    par = {n: b[parent_slots] for n, b in buf.items()}
    L, B = parent_slots.shape[0], next(iter(buf.values())).shape[1]
    flat = {n: t.reshape((L * B,) + t.shape[2:]) for n, t in par.items()}
    new, h = step(flat, *(t.reshape((L * B,) + t.shape[2:]) for t in inputs))
    for n, b in buf.items():
        b[slots] = new[n].reshape((L, B) + new[n].shape[1:]).to(b.dtype)
    return h.reshape((L, B) + h.shape[1:])


def verify_states(kind: str, params, cfg: ModelConfig, x, parents: Sequence[int], state):
    """Tree-verify through a recurrence (the JAX ``verify_states``): node i
    steps from its parent's post-state (the root's parent -1 is the
    committed state). The state-free projections run for all T nodes at
    once; the recurrence runs one tree depth at a time over every node of
    that depth (the nodes of a depth are independent), D + 1 sequential
    steps for a depth-D tree. RG-LRU's conv window gathers each node's
    ancestors (``TreeIndex.taps``) and only its h update is per depth.

    x (B, T, d); parents (T,) host ints (the tree's, fixed per strategy);
    state: the committed state. Returns (outs (B, T, d), buf): buf has the
    state's leaves in float32 with a leading (T + 1) node axis, slot 0 the
    committed state and slot i + 1 node i's post-state."""
    B, T, _ = x.shape
    buf = {n: s.float()[None].repeat((T + 1,) + (1,) * s.dim()) for n, s in state.items()}
    if kind == "rglru":
        cw = params["conv"].shape[0]
        ti = tree_index(parents, cw, x.device)
        u0 = x @ params["w_in"]
        gate = layers.gelu(x @ params["w_gate_branch"])
        xp = torch.cat([state["conv"].to(x.dtype), u0], dim=1)       # (B, cw-1+T, sd)
        win = xp[:, ti.taps]                                         # (B, T, cw, sd)
        u = sum(win[:, :, j] * params["conv"][j] for j in range(cw))
        buf["conv"][1:] = win[:, :, 1:].transpose(0, 1).float()
        a, b = _rglru_coeffs(params, u)
        a, b = a.transpose(0, 1), b.transpose(0, 1)                  # (T, B, sd)
        for nodes, slots, par in ti.levels:
            buf["h"][slots] = a[nodes] * buf["h"][par] + b[nodes]
        hs = buf["h"][1:].transpose(0, 1)
        return (hs * gate.float()).to(x.dtype) @ params["w_out"], buf
    ti = tree_index(parents, 1, x.device)
    hs = x.new_zeros((T, B, cfg.d_model), dtype=torch.float32)
    if kind == "mlstm":
        q, k, v, it, ft = (t.transpose(0, 1) for t in _mlstm_qkvif(params, cfg, x))
        for nodes, slots, par in ti.levels:
            h = _level_step(buf, slots, par, mlstm_step_state, q[nodes], k[nodes], v[nodes],
                            it[nodes], ft[nodes])
            hs[nodes] = h.reshape(h.shape[0], B, -1)
        return _mlstm_out(params, x, hs.transpose(0, 1)), buf
    pre_x = (x.float() @ params["w_x"].float()).transpose(0, 1)     # (T, B, 4d)
    for nodes, slots, par in ti.levels:
        hs[nodes] = _level_step(buf, slots, par,
                                lambda st, px: slstm_step_state(params, st, px), pre_x[nodes])
    return hs.transpose(0, 1).to(x.dtype) @ params["w_out"], buf


def pick_state(state, buf, accepted, n_accepted) -> None:
    """Commit a recurrent layer (the JAX ``model._pick_recurrent``), in
    place: each row takes the state after its deepest accepted node
    (``accepted[:, -1]``); a row with ``n_accepted == 0`` keeps its state."""
    B = accepted.shape[0]
    rows = torch.arange(B, device=accepted.device)
    last = accepted[:, -1].long()
    live = n_accepted > 0
    for n, old in state.items():
        b = buf[n]
        new = b[torch.clamp(last + 1, 0, b.shape[0] - 1), rows]
        keep = live.reshape((B,) + (1,) * (old.dim() - 1))
        old.copy_(torch.where(keep, new.to(old.dtype), old))


def _one_step(kind: str):
    def step(params, cfg: ModelConfig, x, state):
        """x (B, 1, d) -> (out (B, 1, d), the state after it, float32): one
        token, ``verify_states`` over a one-node tree (``model.decode_step``'s
        verify and commit of a recurrent layer)."""
        out, buf = verify_states(kind, params, cfg, x, [-1], state)
        return out, {n: b[1] for n, b in buf.items()}
    return step


STEPS = {kind: _one_step(kind) for kind in TRAIN}
