"""AdamW + schedules + global-norm clipping over the port's parameter
trees — the PyTorch counterpart of ``repro.optim.adamw`` (not
``torch.optim.AdamW``, which keeps moments in the parameter dtype and
decays every tensor).

State layout mirrors the JAX package's ((mu, nu, count)): the moments are
float32 trees shaped like the params (float32 even for bf16 params), and
``count`` is a 0-d int32 tensor on the params' device. The update runs in
float32 and casts back to each parameter's dtype. Weight decay is decoupled
and applies to tensors of 2 or more dims *in the JAX layout*, where every
per-layer tensor is stacked over the layers: so, as the JAX update
computes, a layer's norm scales, gate bias and pooling logits decay, and
the final norm does not (``decay_mask``). Schedules and bias corrections are computed from ``count``
on the device, so a step reads nothing back to the host.
"""
from __future__ import annotations

import math
from typing import Callable, Iterator, List, NamedTuple, Optional

import torch

from repro_torch.config import TrainConfig


class AdamWState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor


# ---------------------------------------------------------------- trees
def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a tree of dicts, lists and tuples, in insertion order."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves) -> object:
    """``leaves`` (in ``tree_leaves`` order) put back into ``template``'s
    structure."""
    it: Iterator = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):     # a NamedTuple
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def tree_map(fn: Callable, tree, *rest):
    leaves = [fn(*xs) for xs in zip(tree_leaves(tree), *map(tree_leaves, rest))]
    return tree_unflatten(tree, leaves)


# ---------------------------------------------------------------- schedules
def _warm_and_progress(cfg: TrainConfig, step):
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return warm, prog


def cosine_schedule(cfg: TrainConfig) -> Callable:
    def f(step):
        warm, prog = _warm_and_progress(cfg, step)
        return cfg.learning_rate * warm * 0.5 * (1 + torch.cos(math.pi * prog))
    return f


def linear_schedule(cfg: TrainConfig) -> Callable:
    def f(step):
        warm, prog = _warm_and_progress(cfg, step)
        return cfg.learning_rate * warm * (1 - 0.9 * prog)
    return f


# ---------------------------------------------------------------- clipping
def global_norm(tree, sum_of_squares: Optional[Callable] = None) -> torch.Tensor:
    """The norm of every leaf together. ``sum_of_squares`` takes the list of
    per-leaf sums of squares and returns their total: on blocks of leaves
    split over ranks (``runtime.sharded``) it sums over the ranks, each
    leaf counted once."""
    if sum_of_squares is None:
        return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree)))
    return torch.sqrt(sum_of_squares([torch.sum(torch.square(l.float()))
                                      for l in tree_leaves(tree)]))


def clip_by_global_norm(grads, max_norm: float, sum_of_squares: Optional[Callable] = None):
    """Returns (float32 grads scaled to at most ``max_norm``, the norm):
    float32, as JAX promotes ``bf16 grad * f32 scale``. ``sum_of_squares``:
    see ``global_norm``."""
    norm = global_norm(grads, sum_of_squares)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


# ---------------------------------------------------------------- AdamW
EPS = 1e-8      # added to the update's denominator, as in the JAX update


def adamw_init(params) -> AdamWState:
    zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
    dev = tree_leaves(params)[0].device
    return AdamWState(mu=zeros(), nu=zeros(),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def decay_mask(params):
    """Per leaf, whether weight decay applies: ``ndim >= 2`` of the leaf as
    the JAX package stacks it (every leaf under ``"layers"`` is stacked)."""
    if isinstance(params, dict) and "layers" in params:
        return {k: tree_map(lambda p, k=k: k == "layers" or p.ndim >= 2, v)
                for k, v in params.items()}
    return tree_map(lambda p: p.ndim >= 2, params)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: TrainConfig,
                 schedule: Optional[Callable] = None):
    """Returns (new params, new state); the inputs are left as they were."""
    sched = schedule or cosine_schedule(cfg)
    count = state.count + 1
    lr = sched(count - 1)
    b1, b2 = cfg.b1, cfg.b2
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state.nu, grads)
    c = count.float()
    mu_hat_scale = 1.0 / (1 - torch.pow(b1, c))
    nu_hat_scale = 1.0 / (1 - torch.pow(b2, c))

    def upd(p, m, v, decay):
        step = m * mu_hat_scale / (torch.sqrt(v * nu_hat_scale) + EPS)
        if decay:
            step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu, decay_mask(params))
    return new_params, AdamWState(mu=mu, nu=nu, count=count)
