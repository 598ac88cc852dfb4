"""Speculative accept/reject over draft trees — the PyTorch counterparts
of ``repro.core.accept``.

Two rules, each with a host (numpy) and a device (PyTorch) form:

* greedy (temperature 0): walk from the root; a child is accepted iff its
  token equals the target argmax at its parent's context. The bonus token is
  the target argmax at the deepest accepted node.

* stochastic (SpecInfer/EAGLE multi-round rejection sampling): preserves the
  target distribution exactly for any draft distribution q — children are
  tried in order; child c with token t is accepted w.p. min(1, p(t)/q(t));
  on rejection p <- normalize(max(p - q, 0)). If all children are rejected,
  the bonus is sampled from the residual.

The device forms walk a fixed number of rounds over the static children
matrix with tensor ops only (no host sync), so they sit inside the fused
verify -> accept -> commit step and only a few ints cross to the host.
Randomness is injected as explicit uniforms with a fixed consumption layout
(``accept_u[round, child_rank]``, one ``bonus_u``) that the host forms
consume too, so host and device agree given the same uniforms. The host
forms are copies of the JAX package's numpy code.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.tree import TreeTopology, children_matrix


@dataclasses.dataclass
class AcceptResult:
    path: np.ndarray        # (n_accepted + 1,) node indices incl. root, root-to-leaf
    tokens: np.ndarray      # (n_accepted + 1,) accepted draft tokens + bonus token
    bonus: int
    n_accepted: int         # accepted DRAFT nodes (path length minus the root)


def children_lists(topo: TreeTopology) -> List[List[int]]:
    ch: List[List[int]] = [[] for _ in range(topo.num_nodes + 1)]
    for i, p in enumerate(topo.parents):
        ch[p + 1].append(i)
    return ch


def greedy_tree_accept(topo: TreeTopology, draft_tokens: np.ndarray,
                       verify_logits: np.ndarray) -> AcceptResult:
    """draft_tokens: (T,) node tokens (node 0 = pending root, always
    accepted); verify_logits: (T, V) target logits at each node. The walk
    starts at the root using its own verify logits — the target's prediction
    after processing the pending token."""
    ch = children_lists(topo)
    cur = 0
    logits = verify_logits[0]
    path: List[int] = [0]
    toks: List[int] = []
    while True:
        best = int(np.argmax(logits))
        nxt = None
        for c in ch[cur + 1]:
            if int(draft_tokens[c]) == best:
                nxt = c
                break
        if nxt is None:
            break
        path.append(nxt)
        toks.append(int(draft_tokens[nxt]))
        logits = verify_logits[nxt]
        cur = nxt
    bonus = int(np.argmax(logits))
    return AcceptResult(path=np.array(path, np.int64),
                        tokens=np.array(toks + [bonus], np.int64),
                        bonus=bonus, n_accepted=len(path) - 1)


def _softmax(x: np.ndarray, temperature: float = 1.0) -> np.ndarray:
    # float32 to match the on-device form bit-for-bit (x64 is disabled there)
    x = x.astype(np.float32) / np.float32(max(temperature, 1e-6))
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


def _inverse_cdf(p: np.ndarray, u: float) -> int:
    cdf = np.cumsum(p / max(p.sum(), 1e-30))
    return int(min(np.searchsorted(cdf, u), len(p) - 1))


def stochastic_tree_accept_uniforms(topo: TreeTopology, draft_tokens: np.ndarray,
                                    verify_logits: np.ndarray, node_q: np.ndarray,
                                    accept_u: np.ndarray, bonus_u: float,
                                    temperature: float = 1.0) -> AcceptResult:
    """SpecInfer-style multi-round rejection sampling over a rooted tree,
    driven by an explicit uniform stream.

    node_q: (T, V) draft distribution *at* each node (the distribution its
    children were drawn from). accept_u: (max_depth + 1, k_max) uniforms —
    round r's j-th child consumes accept_u[r, j]; bonus_u drives the single
    inverse-CDF bonus draw. Output tokens are distributed exactly as the
    target model's.
    """
    maxd = int(topo.depths.max()) if topo.num_nodes else 0
    if accept_u.shape[0] < maxd + 1:
        raise ValueError(f"accept_u needs {maxd + 1} rounds (tree depth {maxd} "
                         f"+ terminal), got {accept_u.shape[0]}")
    ch = children_lists(topo)
    cur = 0
    path: List[int] = [0]
    toks: List[int] = []
    for r in range(accept_u.shape[0]):
        p = _softmax(verify_logits[cur], temperature)
        q = node_q[cur].astype(np.float32)
        accepted: Optional[int] = None
        p_res = p.copy()
        for j, c in enumerate(ch[cur + 1]):
            t = int(draft_tokens[c])
            qt = max(float(q[t]), 1e-12)
            if accept_u[r, j] < min(1.0, float(p_res[t]) / qt):
                accepted = c
                break
            p_res = np.maximum(p_res - q, 0.0)
            s = p_res.sum()
            p_res = p_res / s if s > 0 else np.full_like(p_res, 1.0 / len(p_res))
        if accepted is None:
            # covers both full rejection and leaf exhaustion (no children:
            # p_res == p untouched, so the bonus is drawn from p itself)
            bonus = _inverse_cdf(p_res, bonus_u)
            return AcceptResult(path=np.array(path, np.int64),
                                tokens=np.array(toks + [bonus], np.int64),
                                bonus=bonus, n_accepted=len(path) - 1)
        path.append(accepted)
        toks.append(int(draft_tokens[accepted]))
        cur = accepted
    # a walk that accepts at every level reaches a leaf by round maxd, and a
    # leaf round always terminates via the accepted-is-None branch above
    raise AssertionError("unreachable: the final round terminates at a leaf")


def draw_uniforms(topo: TreeTopology, rng: np.random.Generator):
    """The (accept_u, bonus_u) layout both accept forms consume: one row per
    walk round (max_depth + 1: the last round can only terminate), one column
    per child rank."""
    maxd = int(topo.depths.max()) if topo.num_nodes else 0
    kmax = max(1, children_matrix(topo).shape[1])
    return rng.uniform(size=(maxd + 1, kmax)), float(rng.uniform())


def stochastic_tree_accept(topo: TreeTopology, draft_tokens: np.ndarray,
                           verify_logits: np.ndarray, node_q: np.ndarray,
                           rng: np.random.Generator,
                           temperature: float = 1.0) -> AcceptResult:
    """Rejection sampling with uniforms drawn from ``rng`` (host entry point)."""
    accept_u, bonus_u = draw_uniforms(topo, rng)
    return stochastic_tree_accept_uniforms(topo, draft_tokens, verify_logits,
                                           node_q, accept_u, bonus_u, temperature)


# ------------------------------------------------------------------ device
# Every index is a tensor used through gather / advanced indexing: indexing
# with a 0-d integer tensor would read its value on the host (a sync).
def _finish(draft_tokens, tail, bonus, n_acc, max_depth):
    path = torch.stack(tail, 1)                                       # (B, maxd+1)
    toks_path = torch.gather(draft_tokens, 1, path[:, 1:])
    live = torch.arange(max_depth, device=path.device)[None] < n_acc[:, None]
    tokens = torch.where(live, toks_path, bonus[:, None])
    return path, torch.cat([tokens, bonus[:, None]], 1)


@torch.no_grad()
def greedy_tree_accept_device(child_mat, max_depth: int, draft_tokens,
                              verify_logits):
    """Greedy tree accept on the device, one walk per row.

    child_mat (T, k_max) long children in sibling order (-1 padded);
    draft_tokens (B, T); verify_logits (B, T, V). Returns (path (B,
    max_depth+1), tokens (B, max_depth+1), bonus (B,), n_accepted (B,)),
    path / tokens padded by repeating the last entry / the bonus, the layout
    commit consumes. First matching child wins, as in the host walk.
    """
    B = draft_tokens.shape[0]
    dev = verify_logits.device
    draft_tokens = draft_tokens.long()
    argm = verify_logits.argmax(dim=-1)                               # (B, T)
    cur = torch.zeros((B,), dtype=torch.long, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    n_acc = torch.zeros((B,), dtype=torch.long, device=dev)
    tail = [cur]
    for _ in range(max_depth):
        kids = child_mat[cur]                                         # (B, k_max)
        match = (torch.gather(draft_tokens, 1, kids.clamp_min(0)) ==
                 torch.gather(argm, 1, cur[:, None])) & (kids >= 0)
        found = match.any(1) & alive
        first = match.to(torch.int8).argmax(1, keepdim=True)
        cur = torch.where(found, torch.gather(kids, 1, first)[:, 0], cur)
        alive = found
        n_acc = n_acc + found.long()
        tail.append(cur)
    bonus = torch.gather(argm, 1, cur[:, None])[:, 0]
    path, tokens = _finish(draft_tokens, tail, bonus, n_acc, max_depth)
    return path, tokens, bonus, n_acc


@torch.no_grad()
def stochastic_tree_accept_device(child_mat, max_depth: int, draft_tokens,
                                  verify_logits, node_q, accept_u, bonus_u,
                                  temperature: float = 1.0):
    """Multi-round rejection sampling on the device, one walk per row, with
    the uniform layout of ``stochastic_tree_accept_uniforms`` per row:
    node_q (B, T, V), accept_u (B, max_depth+1, k_max) and bonus_u (B,)
    float32, as in the JAX ``jit_batched_step``. Returns (path, tokens,
    bonus, n_accepted) shaped as the greedy form's."""
    B = draft_tokens.shape[0]
    dev = verify_logits.device
    kmax = child_mat.shape[1]
    V = verify_logits.shape[-1]
    draft_tokens = draft_tokens.long()
    rows = torch.arange(B, device=dev)
    p_all = torch.softmax(verify_logits.float() / max(temperature, 1e-6), dim=-1)
    q_all = node_q.float()
    zeros = lambda dtype: torch.zeros((B,), dtype=dtype, device=dev)
    cur, n_acc, bonus, have_bonus = (zeros(torch.long), zeros(torch.long),
                                     zeros(torch.long), zeros(torch.bool))
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    uniform = torch.full((V,), 1.0 / V, device=dev)
    u_bonus = bonus_u.reshape(B, 1).float()
    tail = [cur]
    for r in range(max_depth + 1):
        p, q = p_all[rows, cur], q_all[rows, cur]                     # (B, V)
        kids = child_mat[cur]                                         # (B, k_max)
        p_res = p
        acc_node, accepted = zeros(torch.long), zeros(torch.bool)
        for j in range(kmax):
            kid = kids[:, j]
            valid = (kid >= 0) & ~accepted
            t = torch.gather(draft_tokens, 1, kid.clamp_min(0)[:, None])
            ratio = torch.gather(p_res, 1, t)[:, 0] / \
                torch.gather(q, 1, t)[:, 0].clamp_min(1e-12)
            ok = valid & (accept_u[:, r, j] < torch.clamp(ratio, max=1.0))
            rejected = valid & ~ok
            res = (p_res - q).clamp_min(0.0)
            s = res.sum(-1, keepdim=True)
            res = torch.where(s > 0, res / s, uniform)
            p_res = torch.where(rejected[:, None], res, p_res)
            acc_node = torch.where(ok, kid, acc_node)
            accepted = accepted | ok
        found = accepted & alive
        terminate = alive & ~accepted
        cdf = torch.cumsum(p_res / p_res.sum(-1, keepdim=True).clamp_min(1e-30), dim=-1)
        draw = torch.searchsorted(cdf, u_bonus)[:, 0].clamp(0, V - 1)
        bonus = torch.where(terminate & ~have_bonus, draw, bonus)
        cur = torch.where(found, acc_node, cur)
        alive = found
        n_acc = n_acc + found.long()
        have_bonus = have_bonus | terminate
        tail.append(cur)
    path, tokens = _finish(draft_tokens, tail[:max_depth + 1], bonus, n_acc, max_depth)
    return path, tokens, bonus, n_acc
