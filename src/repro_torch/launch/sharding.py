"""Sharding rules as data — the counterpart of ``repro.launch.sharding``.

Strategy (the JAX module's, MaxText-style 2D/3D):
  * TP over ``model``: attention heads, FFN hidden, vocab, MoE expert axis.
  * FSDP over every data-parallel axis (``data``, plus ``pod`` on the
    multi-pod mesh): each weight's non-TP matrix dim is sharded across DP.
  * DP: the batch is sharded over (pod x data).
  * SP: the residual stream between layers is sharded over ``model`` along
    the sequence axis (``activation_spec``).
KV caches shard batch over DP and (for batch-1 long-context cells)
sequence over every axis.

A spec is a tuple with one entry per leading dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the dimension split
over their product, row-major), normalised as ``PartitionSpec`` normalises
its entries (a one-name tuple is the name, an empty one ``None``); missing
trailing entries are replicated. Rules are path-pattern based, so they
cover both parameter layouts: the port's ``params["layers"]`` (one block
per layer) and the JAX ``segments`` layout that ``bridge.restack`` builds
(leaves stacked along a leading layer dim, which is never sharded).

Who applies what: ``cache_specs(shard_sequence=True)`` and ``local_block``
cut each rank's cache slice for the sequence-sharded decode
(``models.nsa_sharded``), which holds the weights whole on every rank.
Training across ranks (``runtime.sharded``) holds each rank's block of the
train state under ``state_specs`` (``param_specs`` for the params, both
AdamW moments and the error-feedback residual; the count and a 0-d residual
replicated) and its batch rows under ``batch_spec``; ``shard_tree`` cuts the
blocks from a whole tree (``runtime.sharded.gather_tree`` puts them back
together).
``activation_spec`` is the JAX residual-stream constraint (layout ``"sp"``):
the port's train step applies it, each rank of a data group computing the
positions ``seq_chunk`` gives it of each of its rows (``runtime.sharded``).
``shardings_of`` maps a spec onto ``torch.distributed.tensor``
placements for a ``DeviceMesh``.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, Sequence, Tuple

from repro_torch.launch.mesh import axis_names, dp_axes, mesh_coords, mesh_shape
from repro_torch.optim.adamw import AdamWState

class Spec(tuple):
    """A spec: a tuple that tree walks take as a leaf."""

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def _entry(e):
    """One dimension's entry, normalised as ``PartitionSpec`` does."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


def spec(*entries) -> Spec:
    return Spec(_entry(e) for e in entries)


# ---------------------------------------------------------------- trees
def _walk(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path key, leaf) of a tree of dicts, lists and tuples, in the
    order ``jax.tree_util`` flattens it (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(prefix[:-1], tree)


def flatten(tree) -> Dict[str, Any]:
    """{path key: leaf}, keys as the JAX module's ``_path_key`` writes them."""
    return dict(_walk(tree))


# ---------------------------------------------------------------- parameters
def param_spec(key: str, shape: Tuple[int, ...], mesh, stacked: bool = False) -> Spec:
    """Sharding rule for one parameter. ``stacked`` params carry a leading
    layer-group dim (never sharded)."""
    dp = dp_axes(mesh)
    lead: Tuple = (None,) if stacked else ()
    nd = len(shape) - len(lead)

    def sp(*rest):
        return spec(*(lead + rest))

    # --- top-level tables
    if key.endswith("embed/table"):
        return spec("model", None)
    if key.endswith("lm_head/w"):
        return spec(None, "model")
    if "frontend_proj" in key:
        return spec(None, None)

    # --- MoE experts: (E, d, f) / (E, f, d)
    if re.search(r"ffn/(w_up|w_gate)$", key) and nd == 3:
        return sp(None, dp, "model")
    if re.search(r"ffn/w_down$", key) and nd == 3:
        return sp(None, "model", dp)
    if key.endswith("ffn/router"):
        return sp(dp, None)

    # --- dense FFN (d, f) / (f, d)
    if re.search(r"ffn/(w_up|w_gate)$", key) and nd == 2:
        return sp(dp, "model")
    if re.search(r"ffn/w_down$", key) and nd == 2:
        return sp("model", dp)

    # --- attention projections
    if re.search(r"mix/(wq|wk|wv)$", key):
        return sp(dp, "model")
    if key.endswith("mix/wo"):
        return sp("model", dp)
    if key.endswith("mix/w_gate"):          # NSA branch gates (d, 3Hq)
        return sp(dp, None)
    if re.search(r"mix/w_cmp_[kv]$", key):
        return sp(None, None)

    # --- recurrent blocks
    if re.search(r"mix/(w_in|w_gate_branch|w_a|w_x|wq|wk|wv|wo_gate|w_x)$", key):
        return sp(dp, "model")
    if re.search(r"mix/(w_out|w_h)$", key):
        return sp("model", dp) if key.endswith("w_out") else sp(dp, "model")
    if key.endswith("mix/conv"):
        return sp(None, "model")
    if key.endswith("mix/lam"):
        return sp("model")
    if re.search(r"mix/(wi|wf)$", key):
        return sp(dp, None)

    # --- 1-D / small leaves (norm scales, biases, gate vectors, phis)
    return sp(*([None] * nd))


def param_specs(params_tree, mesh):
    """A tree of specs matching ``params_tree`` (tensors, ``meta`` ones
    too): the port's layout, or the JAX one (``bridge.restack``), whose
    ``segments/`` leaves are stacked."""
    return _map(params_tree, lambda key, leaf: param_spec(
        key, tuple(leaf.shape), mesh, stacked=key.startswith("segments/")))


def state_specs(params_tree, mesh, compression: bool = False) -> Dict[str, Any]:
    """The train state's specs: ``{"params", "opt", "residual"}`` as the
    JAX dry run lays them out (``opt_specs = AdamWState(mu=p_specs,
    nu=p_specs, count=P())``); the residual is shaped like the params under
    int8 error-feedback compression, else a replicated 0-d zero."""
    p = param_specs(params_tree, mesh)
    return {"params": p, "opt": AdamWState(mu=p, nu=p, count=spec()),
            "residual": p if compression else spec()}


def map_specs(fn: Callable[[str, Any, Spec], Any], tree, specs, prefix: str = ""):
    """``fn(path key, leaf, spec)`` over ``tree`` and its spec tree in
    parallel, the structure kept (dicts, lists, tuples, NamedTuples)."""
    if isinstance(specs, Spec):
        return fn(prefix[:-1], tree, specs)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k], f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v, s, f"{prefix}{f}/")
                            for f, v, s in zip(tree._fields, tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, s, f"{prefix}{i}/")
                          for i, (v, s) in enumerate(zip(tree, specs)))
    raise TypeError(f"{prefix[:-1]}: no spec for a leaf of type {type(tree).__name__}")


def leaf_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path key, leaf) in ``optim.tree_leaves`` order (insertion order;
    NamedTuple fields by name; a ``Spec`` is a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from leaf_paths(v, f"{prefix}{f}/")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def leaf_at(tree, key: str):
    """The leaf of ``tree`` at a ``leaf_paths`` key ("params/layers/0/mix/wq")."""
    for part in key.split("/") if key else ():
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            tree = getattr(tree, part)
        elif isinstance(tree, (list, tuple)):
            tree = tree[int(part)]
        else:
            tree = tree[part]
    return tree


def shard_tree(tree, specs, mesh):
    """A whole tree -> this rank's blocks (owned copies) on ``mesh`` (a
    ``DeviceMesh``). Raises, naming the leaf, the dimension and the axes,
    when a sharded dimension does not divide."""
    shape, coords = mesh_shape(mesh), mesh_coords(mesh)

    def cut(key, leaf, sp):
        try:
            return local_block(leaf, sp, shape, coords).clone()
        except ValueError as e:
            raise ValueError(f"{key}: {e}") from None
    return map_specs(cut, tree, specs)



# ---------------------------------------------------------------- activations
def batch_spec(mesh) -> Spec:
    return spec(dp_axes(mesh), None)


def activation_spec(mesh, layout: str = "sp") -> Spec:
    """Residual-stream spec between layers: ``"sp"`` batch over DP,
    sequence over model (Megatron-SP); ``"dmodel"`` batch over DP, d_model
    over model (the JAX ``activation_constraint``'s two layouts)."""
    dp = dp_axes(mesh)
    return spec(dp, "model", None) if layout == "sp" else spec(dp, None, "model")


def seq_chunk(S: int, m: int, i: int) -> Tuple[int, int]:
    """The positions ``[a, b)`` of an S-position stream that rank ``i`` of
    ``m`` along ``model`` holds under ``activation_spec``'s "sp": chunks of
    c = ceil(S / m), the last ones shorter (or empty) when m does not divide
    S, as GSPMD pads an uneven shard."""
    c = -(-S // m)
    return min(S, i * c), min(S, (i + 1) * c)


# ---------------------------------------------------------------- caches
def cache_spec(key: str, shape: Tuple[int, ...], mesh, *, shard_sequence: bool) -> Spec:
    """One cache leaf's rule. K/V and compressed leaves are (B, S|NCB, Hkv,
    Dh) in the port's layout and (n, B, S|NCB, Hkv, Dh) stacked;
    recurrent states (B, ...) / (n, B, ...).

    shard_sequence=False (batched decode): batch over DP, sequence over
    ``model``. shard_sequence=True (batch-1 long context): sequence over
    every axis; recurrent states are tiny and replicated."""
    dp = dp_axes(mesh)
    if key.endswith("length"):
        return spec()
    lead: Tuple = (None,) if key.startswith("segments/") else ()
    nd = len(shape) - len(lead)
    if "state" in key:
        if shard_sequence:
            return spec(*([None] * len(shape)))
        return spec(*(lead + (dp,) + (None,) * (nd - 1)))
    if nd == 4:
        if shard_sequence:
            return spec(*(lead + (None, dp + ("model",), None, None)))
        return spec(*(lead + (dp, "model", None, None)))
    return spec(*([None] * len(shape)))


def cache_specs(caches_tree, mesh, *, shard_sequence: bool):
    """Specs for a cache tree: ``model.init_caches``' (the port's layout)
    or the JAX one (``segments``, stacked)."""
    return _map(caches_tree, lambda key, leaf: cache_spec(
        key, tuple(getattr(leaf, "shape", ())), mesh, shard_sequence=shard_sequence))


# ---------------------------------------------------------------- placement
def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split_axes(sp: Spec, names: Sequence[str]) -> Tuple[str, ...]:
    """The axes that split a leaf of ``sp``, in mesh order (``names``): the
    ranks that differ only along them hold its distinct blocks."""
    used = {a for e in sp for a in _axes_of(e)}
    return tuple(a for a in names if a in used)


def local_slices(shape: Sequence[int], sp: Spec, mesh_shape: Dict[str, int],
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The index of the block that a ``NamedSharding`` of ``sp`` places on
    the device at ``coords`` (multi-axis entries row-major). Raises when a
    sharded dimension does not divide by its axes' product, naming both."""
    out = []
    for d, size in enumerate(shape):
        axes = _axes_of(sp[d]) if d < len(sp) else ()
        idx, n = 0, 1
        for a in axes:
            idx = idx * mesh_shape[a] + coords[a]
            n *= mesh_shape[a]
        if size % n:
            raise ValueError(f"dimension {d} of size {size} does not divide over "
                             f"{axes} ({n} shards)")
        b = size // n
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


def local_block(tensor, sp: Spec, mesh_shape: Dict[str, int], coords: Dict[str, int]):
    """The block of ``tensor`` that a ``NamedSharding`` of ``sp`` places on
    the device at ``coords`` ({axis: index}) of a mesh of ``mesh_shape``
    ({axis: size})."""
    return tensor[local_slices(tensor.shape, sp, mesh_shape, coords)]


def local_shape(shape: Sequence[int], sp: Spec, mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    coords = {a: 0 for a in mesh_shape}
    return tuple(s.stop - s.start for s in local_slices(shape, sp, mesh_shape, coords))


def placements_of(sp: Spec, mesh) -> Tuple:
    """``sp`` as ``torch.distributed.tensor`` placements on ``mesh`` (a
    ``DeviceMesh``): ``Shard(d)`` on each axis that splits dimension d,
    ``Replicate()`` elsewhere. A dimension split over several axes takes
    them in mesh order (row-major, as a ``NamedSharding`` splits it)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, e in enumerate(sp):
        axes = _axes_of(e)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"axes {axes} of dimension {d} are not in mesh order {names}")
        for p in pos:
            if not isinstance(out[p], Replicate):
                raise ValueError(f"axis {names[p]} splits two dimensions of {sp}")
            out[p] = Shard(d)
    return tuple(out)


def shardings_of(spec_tree, mesh):
    """A tree of placements (``placements_of``) for a tree of specs."""
    def go(t):
        if isinstance(t, Spec):
            return placements_of(t, mesh)
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return type(t)(go(v) for v in t)
    return go(spec_tree)
