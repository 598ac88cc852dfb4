"""Training across ranks: what GSPMD does inside the JAX
``make_train_step`` under ``with mesh``, written out for ``torch.distributed``.

The JAX package runs the single-device step on parameters laid out by
``param_specs`` (FSDP over the data axes, TP over ``model``) with the
residual stream constrained to ``activation_spec``'s "sp" layout (rows over
the data axes, the sequence over ``model``) and lets XLA insert the
collectives. Here the layouts are the same and the collectives are
explicit:

  * **What a rank holds.** Between steps each rank holds only its block
    (``sharding.local_block``) of every parameter, both AdamW moments and
    the error-feedback residual, under ``sharding.state_specs``; the
    moments' count and a 0-d residual are replicated. The tokens are cut by
    ``batch_spec``: rows over the data axes, replicated over ``model``.
  * **The positions a rank computes** (``SeqSplit``, when ``model`` has
    m > 1 ranks). Rank i along ``model`` embeds, runs every layer on and
    takes the loss of positions ``sharding.seq_chunk(S, m, i)`` of each of
    its rows (S counts a frontend's frames in front of the tokens). An
    attention layer all-gathers its K and V over ``model`` (``SeqGather``,
    whose backward pass reduce-scatters the gradient in float32) and
    attends for its own queries only (``models.train_sharded``); a MoE
    layer counts its capacity places over the data rank's whole dispatch
    groups from the top-k ids all-gathered over ``model``. With m = 1 the
    step is the single device's computation on the data rank's rows.
  * **The weights, per layer, just in time** (ZeRO-3 over every axis).
    ``Gather`` puts a leaf's blocks together into the whole weight in its
    forward pass; its backward pass sums the whole gradient over every
    rank of the mesh, for each rank's gradient covers only its rows and
    positions, divides by the data ranks' count and keeps this rank's
    block (``MeshLayout.reduce_grad``). ``model.forward_train`` gathers
    each layer inside the layer's function, so under ``remat`` the gather
    (and the layer's ``SeqGather``) runs again in the recompute, as FSDP
    does; the top-level tables (embedding, head, final norm) are gathered
    once per micro-batch.
  * **The global reductions.** The loss is each rank's sum over its
    predictions divided by its data rank's count, summed over the mesh and
    divided by the data ranks' count; the clip's norm sums each leaf's
    squares once (the rank at coordinate 0 of every axis that replicates
    the leaf counts it); the MoE load-balancing statistics are summed over
    the mesh before their product (``MeshSum``, whose backward pass is the
    same sum), and each ``model`` rank adds 1 / m of the term; the int8
    scale is the MAX over the ranks, and the rounding noise this rank's
    block of the whole leaf's noise.

The collectives are all-gather (weights, K/V and MoE ids along ``model``,
and the tokens of a micro-batch), reduce-scatter (gradients of split
leaves and of the gathered K/V) and all-reduce (the rest, and the
scalars). NCCL and gloo both run the three on CUDA tensors (torch 2.11 on
the H100) and gloo on CPU tensors, so one program serves both backends.
The weights are gathered whole, so the matmuls are not split by head or
hidden unit: the ranks along ``model`` split the positions instead
(Megatron-style head-split compute is not ported).

``MeshLayout`` is one rank's view of a ``DeviceMesh``: axis sizes,
coordinates, process groups and the counts of the collectives it issued.
``gather_tree`` puts the blocks back together on rank 0 (checkpoints).
``ServeWeights`` holds the same blocks for serving across ranks (the
sharded prefill and the batched sharded decode), gathering each layer
when it runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.bridge import init_params
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.launch import mesh as mesh_lib, sharding
from repro_torch.models import model
from repro_torch.optim import (AdamWState, adamw_update, clip_by_global_norm, compress,
                               tree_leaves, tree_map, tree_unflatten)


def _prod(xs) -> int:
    return math.prod(xs)


class MeshLayout:
    """One rank's view of a ``DeviceMesh``: ``shape`` ({axis: size}),
    ``coords`` ({axis: index}), the data axes, the process group of any run
    of axes with its members' coordinates, and ``counts`` of the
    collectives issued since ``reset_counts`` ("gathers": all-gathers of
    weights and tokens; "reductions": the reduce-scatters and all-reduces
    of gradients and scalars; "activations": the all-gathers along
    ``model`` of a step's K/V, recurrent state carries and MoE ids, and
    the reduce-scatters of their gradients) with the ``bytes`` the first
    two carried (a gather's whole leaf, a reduction's input) and the
    ``activation_bytes`` of the third (a gather's output, a
    reduce-scatter's input); ``activation_kinds`` splits the third by the
    layer kind that issued it ({"attention" | "recurrent" | "moe":
    {"count", "bytes"}}), and ``relay_steps`` counts the sLSTM relays'
    lockstep steps ({"busy", "idle"}: this rank scanned a row group in
    that step, or waited). ``positions``: (a, b, S) of the last step's
    ``SeqSplit``, else None."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = mesh_lib.axis_names(mesh)
        self.shape = mesh_lib.mesh_shape(mesh)
        self.coords = mesh_lib.mesh_coords(mesh)
        self.dp = mesh_lib.dp_axes(mesh)
        self.n_dp = _prod(self.shape[a] for a in self.dp)
        self.positions = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._members: Dict[Tuple[str, ...], List[Dict[str, int]]] = {}
        # every run of axes a spec can split over, made now in one order on
        # every rank (a flattened group is a collective to create)
        for i in range(len(self.names)):
            for j in range(i + 2, len(self.names) + 1):
                self.group(self.names[i:j])
        self.reset_counts()

    def reset_counts(self) -> None:
        self.counts = {"gathers": 0, "reductions": 0, "activations": 0}
        self.bytes = self.activation_bytes = 0
        self.activation_kinds: Dict[str, Dict[str, int]] = {}
        self.relay_steps = {"busy": 0, "idle": 0}

    def size(self, axes: Sequence[str]) -> int:
        return _prod(self.shape[a] for a in axes)

    def group(self, axes: Sequence[str]):
        axes = tuple(a for a in self.names if a in axes)
        if axes == self.names:
            return dist.group.WORLD
        if axes not in self._groups:
            self._groups[axes] = mesh_lib.axes_group(self.mesh, axes)
        return self._groups[axes]

    def members(self, axes: Sequence[str]) -> List[Dict[str, int]]:
        """The coordinates of the ranks of ``group(axes)``, in group-rank
        order (the order of an all-gather's chunks)."""
        axes = tuple(a for a in self.names if a in axes)
        if axes not in self._members:
            grid = self.mesh.mesh
            where = {int(r): i for i, r in enumerate(grid.flatten().tolist())}
            group = self.group(axes)
            ranks = range(dist.get_world_size()) if group is dist.group.WORLD else \
                dist.get_process_group_ranks(group)
            out = []
            for r in ranks:
                i, c = where[int(r)], {}
                for a in reversed(self.names):
                    c[a], i = i % self.shape[a], i // self.shape[a]
                out.append(c)
            self._members[axes] = out
        return self._members[axes]

    def _count(self, kind: str, t: torch.Tensor, layer: Optional[str] = None) -> None:
        self.counts[kind] += 1
        n = t.numel() * t.element_size()
        if kind == "activations":
            self.activation_bytes += n
            by = self.activation_kinds.setdefault(layer, {"count": 0, "bytes": 0})
            by["count"] += 1
            by["bytes"] += n
        else:
            self.bytes += n

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str], op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``t`` reduced in place over the ranks that differ along ``axes``
        (nothing when they are one rank)."""
        if self.size(axes) > 1:
            self._count("reductions", t)
            dist.all_reduce(t, op=op, group=self.group(axes))
        return t

    # ---------------------------------------------------------------- blocks
    def whole_shape(self, block_shape: Sequence[int], sp) -> Tuple[int, ...]:
        return tuple(s * self.size(sharding._axes_of(sp[d]) if d < len(sp) else ())
                     for d, s in enumerate(block_shape))

    def block(self, whole: torch.Tensor, sp) -> torch.Tensor:
        return sharding.local_block(whole, sp, self.shape, self.coords)

    def gather(self, block: torch.Tensor, sp) -> torch.Tensor:
        """The whole leaf from this rank's ``block`` of it: the blocks of the
        ranks that split the leaf, all-gathered, each put in its place. The
        block itself when no axis splits it."""
        axes = sharding.split_axes(sp, self.names)
        if self.size(axes) == 1:
            return block
        shape = self.whole_shape(block.shape, sp)
        chunks = block.new_empty(self.size(axes) * block.numel())
        out = block.new_empty(shape)
        self._count("gathers", out)
        dist.all_gather_into_tensor(chunks, block.contiguous().view(-1), group=self.group(axes))
        for chunk, c in zip(chunks.view((-1,) + tuple(block.shape)), self.members(axes)):
            out[sharding.local_slices(shape, sp, self.shape, c)] = chunk
        return out

    def reduce_grad(self, g: torch.Tensor, sp, dtype: torch.dtype) -> torch.Tensor:
        """This rank's block of the sum over the mesh of every rank's whole
        gradient ``g`` (each covers only its rows and, along ``model``, its
        positions), divided by the data ranks' count, in ``dtype``: a
        reduce-scatter in float32 of the blocks over the axes that split
        the leaf, then an all-reduce over the axes that replicate it (axes
        of one rank take no part)."""
        split = [a for a in sharding.split_axes(sp, self.names) if self.shape[a] > 1]
        rest = [a for a in self.names if a not in split and self.shape[a] > 1]
        if not split:
            g = g[sharding.local_slices(g.shape, sp, self.shape, self.coords)]
            if not rest:
                return g.to(dtype).contiguous()
            g = g.to(torch.float32, copy=True)
        else:
            parts = torch.stack([g[sharding.local_slices(g.shape, sp, self.shape, c)]
                                 for c in self.members(split)]).to(torch.float32)
            g = parts.new_empty(parts.shape[1:])
            self._count("reductions", parts)
            dist.reduce_scatter_tensor(g.view(-1), parts.view(-1), group=self.group(split))
        if rest:
            self.all_reduce(g, rest)
        return (g / self.n_dp).to(dtype).contiguous()

    # ---------------------------------------------------------------- sequence
    def gather_model(self, t: torch.Tensor, layer: str) -> torch.Tensor:
        """(m, ...): every ``model`` rank's ``t`` (of one shape on every
        rank), all-gathered in coordinate order; counted under
        "activations" as ``layer``'s."""
        out = t.new_empty((self.shape["model"],) + tuple(t.shape))
        self._count("activations", out, layer)
        dist.all_gather_into_tensor(out.view(-1), t.contiguous().view(-1),
                                    group=self.group(("model",)))
        return out

    def scatter_model(self, t: torch.Tensor, layer: str) -> torch.Tensor:
        """``gather_model``'s adjoint: t (m, ...) -> the sum over the
        ``model`` ranks of every rank's ``t[i]``, on rank i; counted."""
        out = t.new_empty(tuple(t.shape[1:]))
        self._count("activations", t, layer)
        dist.reduce_scatter_tensor(out.view(-1), t.contiguous().view(-1),
                                   group=self.group(("model",)))
        return out

    def gather_seq(self, chunk: torch.Tensor, S: int, layer: str = "attention"
                   ) -> torch.Tensor:
        """(B, n, ...) this rank's positions ``seq_chunk`` of an S-position
        stream -> (B, S, ...) the whole stream: every ``model`` rank's chunk,
        padded to ceil(S / m), all-gathered (in group-rank order, which
        ``SeqSplit`` checks is the ``model`` order) and trimmed."""
        m = self.shape["model"]
        c = sharding.seq_chunk(S, m, 0)[1]
        B, n = chunk.shape[:2]
        rest = tuple(chunk.shape[2:])
        if n < c:
            chunk = torch.cat([chunk, chunk.new_zeros((B, c - n) + rest)], dim=1)
        buf = chunk.new_empty((m, B, c) + rest)
        self._count("activations", buf, layer)
        dist.all_gather_into_tensor(buf.view(-1), chunk.contiguous().view(-1),
                                    group=self.group(("model",)))
        return buf.movedim(0, 1).reshape((B, m * c) + rest)[:, :S]

    def scatter_seq(self, whole: torch.Tensor, S: int, n: int, dtype: torch.dtype
                    ) -> torch.Tensor:
        """``gather_seq``'s adjoint: (B, S, ...) -> this rank's (B, n, ...)
        of the sum over the ``model`` ranks, reduce-scattered in float32."""
        m = self.shape["model"]
        c = sharding.seq_chunk(S, m, 0)[1]
        B = whole.shape[0]
        rest = tuple(whole.shape[2:])
        parts = whole.new_zeros((B, m * c) + rest, dtype=torch.float32)
        parts[:, :S] = whole
        parts = parts.view((B, m, c) + rest).movedim(1, 0).contiguous()
        out = parts.new_empty(parts.shape[1:])
        self._count("activations", parts, "attention")
        dist.reduce_scatter_tensor(out.view(-1), parts.view(-1), group=self.group(("model",)))
        return out[:, :n].to(dtype)

    def owns(self, sp) -> bool:
        """Whether this rank counts a leaf of ``sp`` in a global sum: it sits
        at coordinate 0 of every axis that replicates the leaf."""
        used = sharding.split_axes(sp, self.names)
        return all(self.coords[a] == 0 for a in self.names if a not in used)

    # ---------------------------------------------------------------- step reductions
    def global_mean(self, t: torch.Tensor) -> torch.Tensor:
        """A per-rank part of a per-data-rank value (each ``model`` rank's
        share of it) summed over the mesh and averaged over the data axes
        (a copy)."""
        out = self.all_reduce(t.detach().float().clone(), self.names)
        return out / self.n_dp

    def sum_of_squares(self, leaf_specs: List) -> Callable:
        """For ``adamw.global_norm``: the whole tree's sum of squares from
        each block's, every leaf counted once, in one all-reduce."""
        owned = [self.owns(sp) for sp in leaf_specs]

        def total(sq: List[torch.Tensor]) -> torch.Tensor:
            out = torch.zeros((), dtype=torch.float32, device=sq[0].device)
            for s, mine in zip(sq, owned):
                if mine:
                    out = out + s
            return self.all_reduce(out, self.names)
        return total


class LeafBlocks:
    """What ``compress.compress_pytree`` needs of leaves that are this
    rank's blocks: the scale's MAX over the ranks (one all-reduce for every
    leaf: ranks that hold the same block hold the same values, so the MAX
    over all ranks is the MAX over those that split the leaf) and each
    block's cut of the whole leaf's rounding noise."""

    def __init__(self, layout: MeshLayout, leaf_specs: List):
        self.layout, self.specs = layout, leaf_specs

    def amax(self, amaxes: List[torch.Tensor]) -> List[torch.Tensor]:
        out = self.layout.all_reduce(torch.stack(amaxes), self.layout.names,
                                     op=dist.ReduceOp.MAX)
        return list(out.unbind())

    def noise(self, block: torch.Tensor, index: int, step: int) -> torch.Tensor:
        sp = self.specs[index]
        whole = compress.noise_for(block, index, step,
                                   shape=self.layout.whole_shape(block.shape, sp))
        return self.layout.block(whole, sp)


class Gather(torch.autograd.Function):
    """Forward: the whole leaf from this rank's block (``MeshLayout.gather``).
    Backward: this rank's block of the data-axis mean of the whole gradient
    (``MeshLayout.reduce_grad``)."""

    @staticmethod
    def forward(ctx, block, layout: MeshLayout, sp):
        ctx.layout, ctx.sp, ctx.dtype = layout, sp, block.dtype
        out = layout.gather(block, sp)
        return block.view_as(block) if out is block else out

    @staticmethod
    def backward(ctx, grad):
        return ctx.layout.reduce_grad(grad, ctx.sp, ctx.dtype), None, None


class MeshSum(torch.autograd.Function):
    """A per-rank tensor summed over every rank of the mesh (the data ranks'
    rows and the ``model`` ranks' positions); the backward pass sums the
    gradient the same way. With each rank's loss carrying 1 / m of the
    same global term and the weights' gradients summed over the mesh and
    divided by the data ranks' count, this gives the single device's
    gradient of a term that is not linear in the tokens (the MoE
    load-balancing loss)."""

    @staticmethod
    def forward(ctx, t, layout: MeshLayout):
        ctx.layout = layout
        return layout.all_reduce(t.clone(), layout.names)

    @staticmethod
    def backward(ctx, grad):
        return ctx.layout.all_reduce(grad.clone(), ctx.layout.names), None


class SeqGather(torch.autograd.Function):
    """Forward: the whole stream (B, S, ...) from this rank's chunk of its
    positions (``MeshLayout.gather_seq``). Backward: this rank's chunk of the
    gradient summed over the ``model`` ranks (``MeshLayout.scatter_seq``)."""

    @staticmethod
    def forward(ctx, chunk, split: "SeqSplit"):
        ctx.split, ctx.n, ctx.dtype = split, chunk.shape[1], chunk.dtype
        return split.layout.gather_seq(chunk, split.S)

    @staticmethod
    def backward(ctx, grad):
        return ctx.split.layout.scatter_seq(grad, ctx.split.S, ctx.n, ctx.dtype), None


class ModelCarry(torch.autograd.Function):
    """A recurrent layer's state carry along ``model``. Forward: every
    rank's ``local`` (its chunk's summary, of one shape on every rank)
    all-gathered, then ``fold(every, idx)``: this rank's incoming state
    from the predecessors' slots (rank 0's from none). Backward: the fold's
    gradient with respect to every slot (autograd through a rerun of the
    fold), reduce-scattered, so each rank gets the sum of what every rank's
    fold sends its slot. Both collectives run on every rank whatever its
    index: rank 0's output is the initial state, yet it is an output of
    this node, which its consumers reach, so its backward joins the
    reduce-scatter of its peers."""

    @staticmethod
    def forward(ctx, local, split: "SeqSplit", fold):
        every = split.layout.gather_model(local.float(), "recurrent")
        ctx.split, ctx.fold, ctx.dtype = split, fold, local.dtype
        ctx.save_for_backward(every)
        return fold(every, split.idx)

    @staticmethod
    def backward(ctx, grad):
        every, = ctx.saved_tensors
        every = every.detach().requires_grad_(True)
        with torch.enable_grad():
            out = ctx.fold(every, ctx.split.idx)
        g = None
        if out.requires_grad:
            g, = torch.autograd.grad(out, every, grad, allow_unused=True)
        if g is None:
            g = torch.zeros_like(every)
        return ctx.split.layout.scatter_model(g, "recurrent").to(ctx.dtype), None, None


class SeqSplit:
    """``model.forward_train``'s ``split`` hook when ``model`` has m > 1
    ranks: this rank (index ``idx`` along ``model``) computes positions
    ``[a, b)`` (``sharding.seq_chunk``) of each of its B rows' S-position
    stream. ``gather`` gives an attention layer the whole stream of a (B,
    b - a, ...) tensor (``SeqGather``, counted under "activations");
    ``carry`` a recurrent layer its incoming state (``ModelCarry``);
    ``moe_ids`` is ``moe.moe_apply``'s ``gather_ids``. ``row_groups``: the
    sLSTM relay's row groups (``recurrent_sharded.slstm_relay``)."""

    def __init__(self, layout: MeshLayout, B: int, S: int, row_groups: int = 1):
        self.layout, self.B, self.S, self.row_groups = layout, B, S, row_groups
        self.m, self.idx = layout.shape["model"], layout.coords["model"]
        self.a, self.b = sharding.seq_chunk(S, self.m, self.idx)
        if sharding.seq_chunk(S, self.m, self.m - 1)[0] == S:
            raise ValueError(f"a stream of {S} positions leaves the last of {self.m} model "
                             "ranks no position")
        if [c["model"] for c in layout.members(("model",))] != list(range(self.m)):
            raise RuntimeError("the model group does not order its ranks by their coordinate")
        layout.positions = (self.a, self.b, S)

    def gather(self, chunk: torch.Tensor) -> torch.Tensor:
        return SeqGather.apply(chunk, self)

    def carry(self, local: torch.Tensor, fold) -> torch.Tensor:
        return ModelCarry.apply(local, self, fold)

    def moe_ids(self, topk_idx: torch.Tensor):
        """topk_idx (B * (b - a), K) of this rank's tokens -> (the data
        rank's ids (B * S, K) in (row, position) order, one all-gather of
        int ids along ``model`` with no backward pass; this rank's runs of
        tokens in it)."""
        B, S, K = self.B, self.S, topk_idx.shape[-1]
        with torch.no_grad():
            every = self.layout.gather_seq(topk_idx.reshape(B, self.b - self.a, K), S, "moe")
        return every.reshape(B * S, K), tuple((r * S + self.a, r * S + self.b)
                                              for r in range(B))


def gather_tree(blocks, specs, layout: MeshLayout):
    """This rank's blocks -> the whole tree on rank 0's host, None on the
    other ranks. Each leaf is all-gathered by the ranks of rank 0's group
    over the axes that split it (the others skip it) and rank 0 copies it
    to the host at once, so a device holds one whole leaf at a time."""
    rank0 = dist.get_rank() == 0

    def one(key, leaf, sp):
        if not layout.owns(sp):
            return None
        whole = layout.gather(leaf, sp)
        return whole.cpu() if rank0 else None
    tree = sharding.map_specs(one, blocks, specs)
    return tree if rank0 else None


# ---------------------------------------------------------------- the state
def _layer_seed(seed: int, layer: int) -> int:
    return (seed * 1_000_003 + layer) % 2 ** 62


def _layer_init(cfg: ModelConfig, seed: int, layer: int, device):
    """``init_params`` of a one-layer config of layer ``layer``'s kind, from
    a generator of its own: (its top-level tables, its block)."""
    kind = cfg.layer_kinds()[layer]
    one = dataclasses.replace(cfg, num_layers=1, block_pattern=(kind,))
    g = torch.Generator(device)
    g.manual_seed(_layer_seed(seed, layer))
    p = init_params(one, g, device)
    return {k: v for k, v in p.items() if k != "layers"}, p["layers"][0]


def init_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int, layout: MeshLayout,
               specs, device):
    """This rank's blocks of a fresh train state, (params, AdamWState,
    residual), without ever holding the whole state: the params drawn one
    layer at a time (``_layer_init``; the top-level tables with layer 0)
    and cut; the moments and the residual zeros of the blocks' shapes."""
    p_specs = specs["params"]
    cut = lambda tree, sp: sharding.map_specs(lambda _, t, s: layout.block(t, s).clone(),
                                              tree, sp)
    top, first = _layer_init(cfg, seed, 0, device)
    layers = [cut(first, p_specs["layers"][0])]
    del first
    for i in range(1, cfg.num_layers):
        layers.append(cut(_layer_init(cfg, seed, i, device)[1], p_specs["layers"][i]))
    params = dict({k: cut(v, p_specs[k]) for k, v in top.items()}, layers=layers)
    zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
    opt = AdamWState(mu=zeros(), nu=zeros(),
                     count=torch.zeros((), dtype=torch.int32, device=device))
    residual = zeros() if tcfg.grad_compression == "int8_ef" else \
        torch.zeros((), device=device)
    return params, opt, residual


# ---------------------------------------------------------------- the step
def make_sharded_step(cfg: ModelConfig, tcfg: TrainConfig, mesh, row_groups: int = 1):
    """``runtime.trainer.make_train_step(cfg, tcfg, mesh)``: returns
    step(params, opt, residual, tokens, frontend=None) -> (params, opt,
    residual, metrics) on this rank's blocks (``sharding.state_specs``) and
    its rows of the batch (``batch_spec``; a ``frontend``'s frames are cut
    the same way, rows over the data axes, and ``frontend_proj`` stays
    whole on every rank); with m > 1 ``model`` ranks each computes its
    ``SeqSplit`` positions of its rows (an sLSTM layer relays its state
    over ``row_groups`` groups of a micro-batch's rows). Metrics {"loss",
    "grad_norm"} are the global values, equal on every rank. The step
    carries ``layout`` (the ``MeshLayout``, with its collective counts and
    the last step's positions) and ``specs``. Raises for a dense or
    windowed config on ``attention_impl`` "flash" or "online" when m > 1."""
    model.check_supported(cfg)
    layout = MeshLayout(mesh)
    m = layout.shape.get("model", 1)
    if m > 1 and cfg.attention in ("dense", "swa") and cfg.attention_impl in ("flash", "online") \
            and {"attn", "moe"} & set(cfg.layer_kinds()):
        raise NotImplementedError(
            f"{cfg.name}: attention_impl={cfg.attention_impl!r} does not split the positions "
            f"over {m} model ranks (the split runs attention.attend_queries, the function of "
            "'chunked' and 'chunked_remat')")
    use_comp = tcfg.grad_compression == "int8_ef"
    specs = sharding.state_specs(init_params(cfg, torch.Generator(), "meta"), mesh, use_comp)
    p_specs = specs["params"]
    bspec = sharding.batch_spec(mesh)
    fspec = sharding.spec(*bspec, None)          # (rows, frames, frontend_dim)

    def gathered(tree, sp):
        return sharding.map_specs(lambda _, t, s: Gather.apply(t, layout, s), tree, sp)

    def value_and_grad(params, leaves, batch, frontend):
        view = {k: (v if k == "layers" else gathered(v, p_specs[k])) for k, v in params.items()}
        F = frontend.shape[1] if frontend is not None and "frontend_proj" in params else 0
        split = SeqSplit(layout, batch.shape[0], F + batch.shape[1], row_groups) \
            if m > 1 else None
        loss = model.loss_fn(view, cfg, batch, frontend=frontend, remat=tcfg.remat,
                             layer_params=lambda i, bp: gathered(bp, p_specs["layers"][i]),
                             moe_stats=lambda t: MeshSum.apply(t, layout), split=split)
        # a leaf the loss never reads (the norm before an xLSTM block's
        # absent FFN) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), tree_unflatten(params, list(grads))

    def step_fn(params, opt, residual, tokens, frontend=None):
        leaves = tree_leaves(params)
        # each leaf's spec in the order of the caller's tree
        leaf_specs = [sharding.leaf_at(p_specs, key) for key, _ in sharding.leaf_paths(params)]
        for p in leaves:
            p.requires_grad_(True)
        try:
            if tcfg.micro_batches > 1:
                # the single device's micro-batches are runs of the whole
                # batch's rows: put the batch together, cut each by batch_spec
                def runs(t, sp):
                    whole = layout.gather(t, sp)
                    return whole.reshape((tcfg.micro_batches,
                                          whole.shape[0] // tcfg.micro_batches) + whole.shape[1:])
                mb = runs(tokens, bspec)
                fmb = None if frontend is None else runs(frontend, fspec)
                loss = torch.zeros((), device=tokens.device)
                grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
                for j, batch in enumerate(mb):
                    fr = None if fmb is None else layout.block(fmb[j], fspec)
                    l, g = value_and_grad(params, leaves, layout.block(batch, bspec), fr)
                    loss = loss + l
                    grads = tree_map(torch.add, grads, g)
                loss = loss / tcfg.micro_batches
                grads = tree_map(lambda g: g / tcfg.micro_batches, grads)
            else:
                loss, grads = value_and_grad(params, leaves, tokens, frontend)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        with torch.no_grad():
            loss = layout.global_mean(loss)
            if use_comp:
                quant, residual = compress.compress_pytree(grads, residual, int(opt.count),
                                                           LeafBlocks(layout, leaf_specs))
                grads = compress.decompress_pytree(quant)
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip,
                                               layout.sum_of_squares(leaf_specs))
            params, opt = adamw_update(grads, opt, params, tcfg)
        return params, opt, residual, {"loss": loss, "grad_norm": gnorm}

    step_fn.layout, step_fn.specs = layout, specs
    return step_fn


# ---------------------------------------------------------------- serving
class ServeWeights:
    """One rank's view of the weights for serving across ranks (the JAX dry
    run's ``prefill_32k`` and ``decode_32k`` cells run ``model.prefill`` /
    ``model.decode_step`` on weights under ``param_specs``): the rank holds
    its blocks, as the train step does (FSDP over the data axes, the
    ``model`` splits), and

      * ``layer_params(i)`` gathers layer i's weights whole just in time,
        under ``torch.no_grad`` (``MeshLayout.gather``; ``layout.counts``
        and ``layout.bytes`` count the gathers and their bytes);
      * the top-level tables stay as the specs lay them out: the embedding
        table's vocab rows and the head's vocab columns over ``model``. A
        rank embeds the tokens whose ids lie in its rows (zeros elsewhere)
        and the ranks along ``model`` sum the partials (an all-reduce for a
        decode token, a reduce-scatter over the sequence for a prefill);
        the head gives each rank its slice of the vocabulary, ``vocab``,
        without gathering the head (the JAX ``out_shardings`` put the
        logits' vocab over ``model``).

    The sums add one nonzero partial to zeros, so they are exact in any
    dtype. ``models.nsa_sharded.collectives`` counts them."""

    def __init__(self, cfg: ModelConfig, blocks, layout: MeshLayout):
        self.cfg, self.blocks, self.layout = cfg, blocks, layout
        self.specs = sharding.param_specs(init_params(cfg, torch.Generator(), "meta"),
                                          layout.mesh)
        m, idx = layout.shape.get("model", 1), layout.coords.get("model", 0)
        n = cfg.vocab_size // m
        self.vocab = (idx * n, (idx + 1) * n)

    @classmethod
    def from_whole(cls, params, cfg: ModelConfig, mesh) -> "ServeWeights":
        """This rank's blocks cut from whole ``params`` (on their device)."""
        layout = MeshLayout(mesh)
        return cls(cfg, sharding.shard_tree(params, sharding.param_specs(params, mesh), mesh),
                   layout)

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int, mesh, device) -> "ServeWeights":
        """This rank's blocks of weights drawn one layer at a time from
        ``seed`` (``init_state``'s draw), never holding the whole tree."""
        layout = MeshLayout(mesh)
        specs = sharding.param_specs(init_params(cfg, torch.Generator(), "meta"), mesh)
        cut = lambda tree, sp: sharding.map_specs(lambda _, t, s: layout.block(t, s).clone(),
                                                  tree, sp)
        top, first = _layer_init(cfg, seed, 0, device)
        layers = [cut(first, specs["layers"][0])]
        del first
        for i in range(1, cfg.num_layers):
            layers.append(cut(_layer_init(cfg, seed, i, device)[1], specs["layers"][i]))
        return cls(cfg, dict({k: cut(v, specs[k]) for k, v in top.items()}, layers=layers),
                   layout)

    def resident_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(self.blocks))

    @torch.no_grad()
    def layer_params(self, i: int, part: Optional[str] = None):
        """Layer i's weights, whole (``part``: only that subtree, e.g.
        ``"mix"``). Every rank of the mesh must call it together."""
        blocks, specs = self.blocks["layers"][i], self.specs["layers"][i]
        if part is not None:
            blocks, specs = blocks[part], specs[part]
        return sharding.map_specs(lambda _, t, s: self.layout.gather(t, s), blocks, specs)

    @property
    def final_norm(self):
        return self.blocks["final_norm"]

    def _table(self):
        return self.blocks["embed"]["table"]

    def _partial_embed(self, tokens):
        table = self._table()
        v0 = self.vocab[0]
        t = tokens.long() - v0
        inside = (t >= 0) & (t < table.shape[0])
        e = table[t.clamp(0, table.shape[0] - 1)]
        return torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype,
                                                             device=e.device))

    @torch.no_grad()
    def embed(self, tokens):
        """tokens (B, T) -> (B, T, D), whole on every rank of the row."""
        from repro_torch.models import nsa_sharded
        group = nsa_sharded.shard_of(self.layout.mesh, ("model",))[0]
        return nsa_sharded.all_reduce(self._partial_embed(tokens), dist.ReduceOp.SUM, group)

    @torch.no_grad()
    def embed_chunk(self, tokens, frontend=None):
        """tokens (B, S) -> this rank's sequence chunk of the embeddings
        (B, S / model, D): the partials of every position summed over
        ``model`` and scattered along the sequence. With a ``frontend``
        (B, F, frontend_dim) the stream is [projected frames; embedded
        tokens] (``model.embed_inputs``), cut over ``model`` on its F + S
        positions: the token partials sit after F zero rows, and each rank
        projects the frames of its own chunk through ``frontend_proj``,
        which every rank holds whole."""
        from repro_torch.models import nsa_sharded
        group, idx, m = nsa_sharded.shard_of(self.layout.mesh, ("model",))
        part = self._partial_embed(tokens)
        F = frontend.shape[1] if frontend is not None else 0
        if F:
            part = torch.cat([part.new_zeros(part.shape[0], F, part.shape[2]), part], dim=1)
        B, S, D = part.shape
        chunks = part.reshape(B, m, S // m, D).transpose(0, 1).contiguous()
        x = nsa_sharded.reduce_scatter(chunks, group)
        a, b = sharding.seq_chunk(S, m, idx)
        b = min(F, b)
        if b > a:
            x[:, :b - a] = frontend[:, a:b].to(x.dtype) @ self.blocks["frontend_proj"]["w"]
        return x

    def logits(self, hidden):
        """hidden (..., D) -> this rank's vocab slice of the logits (...,
        V / model)."""
        if self.cfg.tie_embeddings:
            return hidden @ self._table().T
        return hidden @ self.blocks["lm_head"]["w"]


class WholeWeights:
    """``ServeWeights``' interface over whole weights on every rank (the
    sequence-sharded batch-1 decode holds them so): no gather, and the
    whole vocabulary on every rank."""

    def __init__(self, params, cfg: ModelConfig):
        self.params, self.cfg = params, cfg
        self.vocab = (0, cfg.vocab_size)

    def layer_params(self, i: int, part: Optional[str] = None):
        p = self.params["layers"][i]
        return p if part is None else p[part]

    @property
    def final_norm(self):
        return self.params["final_norm"]

    def embed(self, tokens):
        from repro_torch.models import layers
        return layers.embed(self.params["embed"], tokens)

    def logits(self, hidden):
        return model.logits_fn(self.params, self.cfg, hidden)
