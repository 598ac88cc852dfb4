"""Mixture-of-experts FFN with top-k routing — the PyTorch counterpart of
``repro.models.moe`` (its grouped ``dense_onehot`` dispatch).

The semantics are the reference's, exactly:

  * the router runs in float32; top-k takes the K largest probabilities
    (ties: the lower expert index first, as ``jax.lax.top_k``) and
    renormalises their weights;
  * tokens are cut into dispatch groups of G = min(dispatch_group, N)
    tokens, G halved while it does not divide N; each expert takes at most
    C = max(ceil(G * K * capacity_factor / E), K) assignments per group;
  * a (token, k) assignment takes the next place of its expert inside its
    group in flattened (token, k) order; assignments past C are dropped
    (weight 0: the residual keeps the token);
  * shared experts add a dense FFN of every token.

What differs is how the kept assignments reach their experts. The
reference builds one-hot dispatch tensors, (groups, G, E, C) and the
(groups, E, C, d) expert inputs; at a 4097-token prompt on 128 experts G
falls to 1 and the inputs alone would be ~34 GB. Here the caller picks one
of two paths, and both write one output per assignment:

  * all experts at once (verify, decode, train): each expert's kept tokens
    are gathered into an (E, groups * P, d) buffer, P = min(C, G) places
    per expert and group (a group's G tokens pick an expert at most G
    times, since a token's top-k experts are distinct), and each weight
    runs as one ``torch.matmul`` over all experts. No host sync, so a
    verify step keeps its one device-to-host copy and can be captured in
    a CUDA graph;
  * ``by_expert`` (prefill): expert by expert over the assignments each
    one kept. It reads the counts on the host, and computes no empty
    place.

The combine sums each token's K weighted outputs in k order: no
scatter-add, so the result does not depend on the order of atomics.

``per_row``: the JAX batched engine runs each row as a batch of one under
``vmap``, so a row's dispatch groups hold its own tokens only; the port's
engines step B rows in one call and pass ``per_row=True`` to get those
groups. A direct model-level call keeps the reference's flattened B*S.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.models import layers


def router_probs(params, x, moe: MoEConfig):
    """x: (N, d) -> (probs (N, E) f32, topk_idx (N, K) int64, topk_w (N, K))."""
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :moe.top_k], top_idx[:, :moe.top_k]
    return probs, top_idx, top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)


def load_balance_loss(probs, topk_idx, num_experts: int, stats_sum=None):
    """Switch-style auxiliary loss: E * sum_e f_e * p_e.

    ``stats_sum`` (training across ranks: ``runtime.sharded.MeshSum``, a
    differentiable sum over every rank of the mesh, its data rows and
    ``model`` positions) sums each expert's assignment count, its
    probability mass and the token count over the ranks before the
    product, which is not linear in the tokens: the loss is the single
    device's over the whole batch, the same on every rank, and
    ``model.loss_fn`` adds 1 / m of it on each of the m ``model`` ranks."""
    N = probs.shape[0]
    experts = torch.arange(num_experts, device=probs.device)
    counts = (topk_idx.reshape(-1, 1) == experts).sum(0).float()     # no host sync
    if stats_sum is not None:
        tot = stats_sum(torch.cat([counts, probs.sum(dim=0), probs.new_full((1,), N)]))
        counts, mass, n = tot[:num_experts], tot[num_experts:-1], tot[-1]
        f = counts / (n * topk_idx.shape[-1])
        return num_experts * torch.sum(f * (mass / n))
    f = counts / max(1, N * topk_idx.shape[-1])
    return num_experts * torch.sum(f * probs.mean(dim=0))


def group_size(n: int, moe: MoEConfig) -> int:
    """The dispatch group of ``n`` tokens: min(dispatch group, n), halved
    while it does not divide n."""
    G = min(moe.dispatch_group, n)
    while n % G:
        G //= 2
    return G


def capacity(G: int, moe: MoEConfig) -> int:
    return max(int(math.ceil(G * moe.top_k * moe.capacity_factor / moe.num_experts)),
               moe.top_k)


def dispatch(topk_idx, G: int, C: int, num_experts: int):
    """Each (token, k)'s place in its expert inside its group of G tokens,
    by a running count in flattened (token, k) order. topk_idx (N, K) ->
    (pos (N, K) int64, keep (N, K) bool: pos < C)."""
    N, K = topk_idx.shape
    flat = topk_idx.reshape(N // G, G * K)
    onehot = flat[..., None] == torch.arange(num_experts, device=flat.device)
    count = onehot.long().cumsum(dim=1)                         # (groups, G*K, E)
    pos = torch.gather(count, 2, flat[..., None])[..., 0] - 1
    pos = pos.reshape(N, K)
    return pos, pos < C


def _expert_ffn(params, xe, activation: str, e=slice(None)):
    """xe (E', n, d) tokens of experts ``e`` -> their FFN outputs (E', n, d)."""
    if activation in layers.GATED:
        h = layers.GATED[activation](torch.matmul(xe, params["w_gate"][e])) * \
            torch.matmul(xe, params["w_up"][e])
    else:
        h = layers.ACTIVATIONS[activation](torch.matmul(xe, params["w_up"][e]))
    return torch.matmul(h, params["w_down"][e])


@functools.lru_cache(maxsize=64)
def _runs_index(runs: Tuple[Tuple[int, int], ...], G: int, device: str):
    """(the tokens of ``runs`` (start, stop) as indices (N,), each one's
    dispatch group among the groups they touch (N,), that count of groups),
    on ``device``; made once per (runs, G)."""
    idx = np.concatenate([np.arange(a, b) for a, b in runs])
    touched, group = np.unique(idx // G, return_inverse=True)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(group.reshape(-1)).to(device),
            len(touched))


def _expert_outputs(params, cfg: ModelConfig, xf, topk_idx, pos, keep, G: int, C: int,
                    groups):
    """The expert output of every kept assignment, (N, K, d), all experts
    at once; dropped ones are 0. ``groups``: (each token's dispatch group
    (N,), the count of groups)."""
    N, d = xf.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    P = min(C, G)                                   # places per expert and group
    tok = torch.arange(N, device=xf.device)[:, None].expand(N, K)
    group, n_groups = groups[0][:, None], groups[1]
    slots = n_groups * P                            # places per expert
    # empty places read a zero row
    slot = topk_idx * slots + group * P + pos
    slot = torch.where(keep, slot, torch.full_like(slot, E * slots))
    src = torch.full((E * slots + 1,), N, dtype=torch.long, device=xf.device)
    src[slot.reshape(-1)] = tok.reshape(-1)
    x_pad = torch.cat([xf, xf.new_zeros(1, d)])
    y = _expert_ffn(params, x_pad[src[:-1]].reshape(E, slots, d), cfg.activation)
    y = torch.cat([y.reshape(E * slots, d), y.new_zeros(1, d)])
    return y[slot]


def _expert_outputs_by_expert(params, cfg: ModelConfig, xf, topk_idx, keep):
    """The same, expert by expert over the assignments each one kept (the
    counts are read on the host)."""
    N, d = xf.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    e_of = torch.where(keep, topk_idx, torch.full_like(topk_idx, E)).reshape(-1)
    order = torch.argsort(e_of, stable=True)
    counts = torch.bincount(e_of, minlength=E + 1).tolist()
    out = xf.new_zeros(N * K, d)
    start = 0
    for e in range(E):
        ids = order[start:start + counts[e]]
        start += counts[e]
        if len(ids):
            out.index_copy_(0, ids, _expert_ffn(
                params, xf[torch.div(ids, K, rounding_mode="floor")][None], cfg.activation,
                slice(e, e + 1))[0])
    return out.reshape(N, K, d)


def moe_apply(params, cfg: ModelConfig, x, per_row: bool = False, by_expert: bool = False,
              stats_sum=None, group: int = 0, gather_ids=None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss 0-d f32). Dispatch groups
    are cut from the B*S flattened tokens, or from each row's S tokens
    with ``per_row`` (the JAX batched engine's per-row ``vmap``). The
    experts run all at once with no host sync, or one by one with
    ``by_expert`` (a prefill). ``stats_sum``: see ``load_balance_loss``.

    Across data ranks each rank cuts its groups from its own rows; they are
    the single device's groups while the group size divides each rank's
    B*S tokens (no group straddles two ranks' rows): the capacity drops are
    then the single device's too. Two hooks serve the cells across ranks:

      * ``group``: the group size, in place of ``group_size``'s; the
        prefill across ranks passes the single device's, which must divide
        N (each rank then cuts the single device's groups from its chunk);
      * ``gather_ids`` (the batched decode across data ranks, whose single
        group holds every row's token; the train step across ``model``
        ranks, whose groups hold other ranks' positions): topk_idx (N, K)
        -> (the ids of every token of the groups (N_all, K), this rank's
        tokens among them as (start, stop) runs, in the order of its N).
        The places are counted over all N_all tokens, as on one device, and
        the rank keeps those of its own and computes only the groups they
        touch; only int ids travel."""
    moe = cfg.moe
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    probs, topk_idx, topk_w = router_probs(params, xf, moe)
    aux = load_balance_loss(probs, topk_idx, moe.num_experts, stats_sum)
    if gather_ids is None:
        G = group or group_size(S if per_row else N, moe)
        C = capacity(G, moe)
        pos, keep = dispatch(topk_idx, G, C, moe.num_experts)
        groups = (torch.div(torch.arange(N, device=x.device), G, rounding_mode="floor"), N // G)
    else:
        every, runs = gather_ids(topk_idx)
        G = group_size(every.shape[0], moe)
        C = capacity(G, moe)
        idx, *groups = _runs_index(tuple(runs), G, str(x.device))
        pos, keep = (t[idx] for t in dispatch(every, G, C, moe.num_experts))
    w = torch.where(keep, topk_w, torch.zeros((), device=x.device))
    y_k = (_expert_outputs_by_expert(params, cfg, xf, topk_idx, keep) if by_expert
           else _expert_outputs(params, cfg, xf, topk_idx, pos, keep, G, C, groups))
    # the reference's combine weights are cast to the activations' dtype
    y = (w.to(x.dtype).float()[..., None] * y_k.float()).sum(dim=1).to(x.dtype)
    y = y.reshape(B, S, d)
    if moe.num_shared_experts:
        y = y + layers.ffn(params["shared"], x, cfg.activation)
    return y, aux
