"""Draft trees: construction geometry, BFS/DFS flattening, tree attention
masks, and acceptance-path bookkeeping (paper §4.1).

Trees are *rooted*: node 0 is the **pending token** — the last generated
token whose K/V has not yet entered the cache (the previous step's bonus
token, or the last prompt token right after prefill). Verifying the tree
computes the pending token's K/V alongside the draft nodes, so committing the
accepted path (which always starts at node 0) keeps the cache exact. A draft
tree of depth D and branching width k then has 1 + k + k^2 + ... + k^D nodes.

Topology is *static* per strategy: (D, k, traversal, budget) fix parents,
depths, and masks; only token ids are data — every verification step is a
fixed-shape computation.

A copy of ``repro.core.tree`` (numpy only), kept in the PyTorch package so it
imports nothing of the JAX one.

Traversal orders (paper: thread-block grouping prefers different adjacency):
  * BFS — siblings adjacent (same depth grouped);
  * DFS — parent/child chains adjacent.
Both orders list parents before children (topological), which the recurrent
state-replay verifier also requires. Node 0 stays first in both orders.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TreeTopology:
    """Static topology of a flattened draft tree.

    parents[i]  — index of node i's parent in flattened order (-1 = root/committed)
    depths[i]   — 1-based depth (position offset from the committed prefix)
    mask[i, j]  — node i attends node j (ancestor-or-self relation)
    paths       — (n_leaves, D) node indices of each root-to-leaf path, -1 padded
    """

    parents: np.ndarray
    depths: np.ndarray
    mask: np.ndarray
    paths: np.ndarray
    order: str

    @property
    def num_nodes(self) -> int:
        return len(self.parents)


def _build_children(depth: int, width: int, budget: int) -> Tuple[List[int], List[int]]:
    """BFS-enumerate the rooted (D, k) tree (level order), draft nodes
    truncated to ``budget``. Returns (parents_bfs, depths_bfs); node 0 is the
    pending root at depth 0."""
    parents = [-1]
    depths = [0]
    level = [0]  # previous level's node ids
    nid = 1
    for d in range(1, depth + 1):
        nxt = []
        for p in level:
            for _ in range(width):
                if budget and nid > budget:
                    return parents, depths
                parents.append(p)
                depths.append(d)
                nxt.append(nid)
                nid += 1
        level = nxt
        if not level:
            break
    return parents, depths


@functools.lru_cache(maxsize=256)
def build_topology(depth: int, width: int, order: str = "bfs",
                   budget: int = 0) -> TreeTopology:
    parents_bfs, depths_bfs = _build_children(depth, width, budget)
    n = len(parents_bfs)
    if order == "bfs":
        perm = list(range(n))
    elif order == "dfs":
        children: List[List[int]] = [[] for _ in range(n + 1)]
        for i, p in enumerate(parents_bfs):
            children[p + 1].append(i)
        perm = []

        def visit(b):
            for c in children[b + 1]:
                perm.append(c)
                visit(c)

        visit(-1)  # root (bfs id 0) is the only child of -1, stays first
    else:
        raise ValueError(f"unknown traversal order {order!r}")
    inv = {b: i for i, b in enumerate(perm)}
    parents = np.array([inv[parents_bfs[b]] if parents_bfs[b] >= 0 else -1
                        for b in perm], np.int32)
    depths = np.array([depths_bfs[b] for b in perm], np.int32)
    # topological check: parents precede children in flattened order
    assert all(parents[i] < i for i in range(n)), "traversal must be topological"

    mask = np.zeros((n, n), bool)
    for i in range(n):
        j = i
        while j >= 0:
            mask[i, j] = True
            j = parents[j]

    # leaves: nodes with no children
    has_child = np.zeros(n, bool)
    for i in range(n):
        if parents[i] >= 0:
            has_child[parents[i]] = True
    leaves = np.where(~has_child)[0]
    maxd = int(depths.max()) if n else 0
    paths = np.full((len(leaves), maxd + 1), -1, np.int32)  # root included
    for li, leaf in enumerate(leaves):
        chain = []
        j = leaf
        while j >= 0:
            chain.append(j)
            j = parents[j]
        chain.reverse()
        paths[li, : len(chain)] = chain
    return TreeTopology(parents=parents, depths=depths, mask=mask, paths=paths,
                        order=order)


def children_matrix(topo: TreeTopology) -> np.ndarray:
    """(T, k_max) int32: children of each node in sibling order, -1 padded.

    Static per topology — the device-side accept walks scan over it. k_max is
    the max child count over nodes (>= 1 so the array is never 0-width).
    """
    n = topo.num_nodes
    ch: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        p = int(topo.parents[i])
        if p >= 0:
            ch[p].append(i)
    kmax = max([len(c) for c in ch] + [1])
    mat = np.full((n, kmax), -1, np.int32)
    for i, c in enumerate(ch):
        mat[i, : len(c)] = c
    return mat


def positions_for(topo: TreeTopology, prefix_len) -> np.ndarray:
    """Absolute positions of flattened nodes: the pending root (depth 0) sits
    at position prefix_len; depth-d draft nodes at prefix_len + d."""
    return prefix_len + topo.depths


def chain_topology(gamma: int) -> TreeTopology:
    """Degenerate tree: pending root + a single chain of gamma draft tokens
    (classic non-tree speculation)."""
    return build_topology(gamma, 1, "bfs", 0)
