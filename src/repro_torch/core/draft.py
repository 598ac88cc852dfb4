"""Draft model config + tree expansion — the PyTorch counterparts of
``repro.core.draft``.

The draft is a small dense transformer sharing the target's vocabulary.
Tree expansion runs level by level: level-(d+1) candidate tokens are the
top-k of the draft's logits at the depth-d nodes, each level re-verifying
the partial tree through the draft's own ``verify_step`` (tree-masked), so
deeper levels see exact draft K/V. The final pass also yields the draft
K/V updates for committing and the per-node draft distributions ``node_q``
that stochastic acceptance consumes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.tree import TreeTopology


def draft_config(target_cfg: ModelConfig, num_layers: int = 2, d_model: int = 0,
                 name: str = "") -> ModelConfig:
    d = d_model or max(64, target_cfg.d_model // 4)
    heads = max(2, target_cfg.num_heads // 4)
    while d % heads:
        heads -= 1
    return dataclasses.replace(
        target_cfg,
        name=name or f"{target_cfg.name}-draft",
        num_layers=num_layers,
        d_model=d,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=0,
        d_ff=2 * d,
        attention="dense",
        block_pattern=("attn",),
        moe=None,
        recurrent=None,
        modality="text",
        frontend_dim=0,
    )


def sibling_ranks(topo: TreeTopology) -> np.ndarray:
    """rank[i] = index of node i among its siblings (drives top-k assignment)."""
    T = topo.num_nodes
    rank = np.zeros(T, np.int64)
    seen: dict = {}
    for i in range(1, T):
        p = int(topo.parents[i])
        rank[i] = seen.get(p, 0)
        seen[p] = rank[i] + 1
    return rank


class TreeTensors:
    """A topology's static arrays on one device, built once per strategy (a
    host-to-device copy inside the serving step would wait on the stream)."""

    def __init__(self, topo: TreeTopology, device):
        self.topo = topo
        self.depths = torch.as_tensor(topo.depths, dtype=torch.int32, device=device)
        self.mask = torch.as_tensor(topo.mask, device=device)
        rank = sibling_ranks(topo)
        self.levels = []
        maxd = int(topo.depths.max()) if topo.num_nodes > 1 else 0
        for d in range(1, maxd + 1):
            level = np.where(topo.depths == d)[0]
            kmax = int(rank[level].max()) + 1 if len(level) else 1
            self.levels.append((
                torch.as_tensor(level, dtype=torch.long, device=device),
                torch.as_tensor(topo.parents[level], dtype=torch.long, device=device),
                torch.as_tensor(rank[level], dtype=torch.long, device=device),
                kmax))


@torch.no_grad()
def expand_tree(verify_fn, draft_caches, tree: TreeTensors, pending_token,
                temperature: float = 0.0):
    """Fill the tree's token ids by expanding with the draft model.

    verify_fn(caches, tokens, positions, tmask) -> (logits, updates);
    pending_token (B,) on the device — the tree root's token.
    Returns (tokens (B, T), node_q (B, T, V) draft distributions, updates of
    the final full-tree pass). Top-k takes a stable descending sort, so
    ties go to the lower token id as ``jax.lax.top_k`` gives them.
    """
    B = pending_token.shape[0]
    T = tree.topo.num_nodes
    dev = pending_token.device
    positions = (tree.depths[None] + draft_caches["length"].reshape(-1, 1)) \
        .expand(B, T).to(torch.int32)                                # per-row lengths
    tmask = tree.mask[None].expand(B, T, T)
    tokens = torch.zeros((B, T), dtype=torch.long, device=dev)
    tokens[:, 0] = pending_token
    node_q = updates = None
    for d in range(len(tree.levels) + 1):
        logits, updates = verify_fn(draft_caches, tokens, positions, tmask)
        scaled = logits.float()
        if temperature > 0:
            scaled = scaled / temperature
        node_q = torch.softmax(scaled, dim=-1)
        if d == len(tree.levels):
            break
        level, par, rk, kmax = tree.levels[d]
        _, order = torch.sort(logits, dim=-1, descending=True, stable=True)
        topk_idx = order[..., :kmax]                                  # (B, T, kmax)
        tokens[:, level] = topk_idx[:, par, rk]
    return tokens, node_q, updates
