"""Checkpointing: atomic, asynchronous, one on-disk format with the JAX
package — the PyTorch counterpart of ``repro.ckpt.checkpoint``.

Format (the JAX package's): one ``arrays.npz`` per checkpoint holding every
leaf under its pytree path in the JAX layout (``params/segments/0/0/mix/wq``
stacked over layers, ``opt/mu/...``, ``opt/nu/...``, ``opt/count``,
``residual``), plus ``meta.json`` (step, leaf manifest, user metadata).
bf16 leaves are stored as float32 (lossless). Writes go to a temporary
directory that is atomically renamed, so a crash mid-write never corrupts
the newest checkpoint.

The port's trees (``params["layers"]`` one dict per layer, ``AdamWState``)
go to the JAX layout through ``jax_layout`` (``bridge.restack``) and come
back through ``bridge.from_jax`` in ``restore``, cast to the template's
dtypes on the template's device: a checkpoint written by either package
resumes in the other. ``AsyncCheckpointer`` copies the device tensors to
the host (blocking only for that copy) and writes in a background thread.

Across ranks (``runtime.sharded``) the file is the same: ``save_sharded``
gathers each leaf whole to rank 0's host, rank 0 writes and every rank waits;
``restore(..., mesh=, specs=)`` has each rank read the file and cut its
block of every leaf (the JAX ``restore(shardings=)``), so a checkpoint
resumes on any mesh whose blocks divide, or on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.config import ModelConfig
from repro_torch.optim.adamw import tree_map

_NATIVE = {np.dtype(t) for t in
           ("float64", "float32", "float16", "int64", "int32", "int16", "int8",
            "uint64", "uint32", "uint16", "uint8", "bool")}


def _is_params(tree) -> bool:
    return isinstance(tree, dict) and "layers" in tree


def jax_layout(tree, cfg: ModelConfig):
    """A tree of the port's layout -> the JAX layout: every params-shaped
    dict (one with ``"layers"``) re-stacked, every NamedTuple a dict of its
    fields; leaves stay as they are."""
    if _is_params(tree):
        return bridge.restack(tree, cfg)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: jax_layout(v, cfg) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: jax_layout(v, cfg) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_layout(v, cfg) for v in tree)
    return tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    arr = np.asarray(leaf)
    if arr.dtype not in _NATIVE:       # bf16 / fp8 from JAX: stored as float32
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: _host(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _nest(flat: Dict[str, np.ndarray]):
    """Flat "a/0/b" keys -> nested dicts, with all-digit levels as lists."""
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [listify(n[str(i)]) for i in range(len(n))]
        return {k: listify(v) for k, v in n.items()}

    return listify(root)


def save(directory: str, step: int, tree, metadata: Optional[dict] = None):
    """Atomic synchronous save of ``tree`` (JAX layout; tensor or numpy
    leaves) at ``directory/step_<N>``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {"step": step, "leaves": sorted(flat), "metadata": metadata or {},
            "time": time.time()}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load(directory: str, step: Optional[int] = None) -> Tuple[int, Any]:
    """(step, the checkpoint as a nested numpy tree in the JAX layout)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return step, _nest(flat)


def _fill(template, node, cfg: ModelConfig, key: str, cut=None, specs=None):
    """``node`` (the checkpoint's tree) in ``template``'s structure; with
    ``cut(whole, spec)`` each leaf is first cut to this rank's block under
    its spec in ``specs`` (a tree of ``template``'s structure)."""
    sub = (lambda k: None) if specs is None else \
        (lambda k: getattr(specs, k) if hasattr(specs, "_fields") else specs[k])
    if _is_params(template):
        got = bridge.from_jax(node, cfg, device="cpu" if cut else
                              template["embed"]["table"].device)
        return _cast_like(template, got, key, cut, specs)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_fill(v, _child(node, f, key), cfg, f"{key}/{f}", cut, sub(f))
                                for f, v in zip(template._fields, template)))
    if isinstance(template, dict):
        return {k: _fill(v, _child(node, k, key), cfg, f"{key}/{k}", cut, sub(k))
                for k, v in template.items()}
    return _leaf_like(template, node, key, cut, specs)


def _child(node, k, key):
    if not isinstance(node, dict) or k not in node:
        raise KeyError(f"checkpoint missing leaf {key}/{k}".lstrip("/"))
    return node[k]


def _cast_like(template, got, key, cut=None, specs=None):
    """Port-layout ``got`` (tensors from ``from_jax``) cast leaf by leaf to
    ``template``'s dtypes, shapes checked (after ``cut``, as in ``_fill``)."""
    if isinstance(template, dict):
        return {k: _cast_like(v, got[k], f"{key}/{k}", cut, specs and specs[k])
                for k, v in template.items()}
    if isinstance(template, list):
        return [_cast_like(v, g, f"{key}/{i}", cut, specs and specs[i])
                for i, (v, g) in enumerate(zip(template, got))]
    return _leaf_like(template, got, key, cut, specs)


def _leaf_like(template: torch.Tensor, value, key: str, cut=None, spec=None) -> torch.Tensor:
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
    if cut is not None:
        try:
            t = cut(t, spec)
        except ValueError as e:
            raise ValueError(f"{key.lstrip('/')}: {e}") from None
    if tuple(t.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {key.lstrip('/')}: ckpt {tuple(t.shape)} vs "
                         f"template {tuple(template.shape)}")
    return t.to(device=template.device, dtype=template.dtype)


def restore(directory: str, template, cfg: ModelConfig, step: Optional[int] = None,
            mesh=None, specs=None) -> Tuple[int, Any]:
    """Load the checkpoint at ``step`` (default: the newest) into the
    structure of ``template`` (the port's layout): params-shaped subtrees
    map back through ``bridge.from_jax``; every leaf takes the template
    leaf's dtype and device (bf16 stored as float32 comes back bitwise).

    With ``mesh`` (a ``DeviceMesh``) and ``specs`` (the spec tree of
    ``template``, e.g. ``sharding.state_specs``) ``template`` holds this
    rank's blocks, and each leaf of the file is cut to this rank's block
    (``sharding.local_block``) before it moves to the device: the JAX
    ``restore(shardings=)``. Raises, naming the leaf, when a block does not
    divide."""
    step, tree = load(directory, step)
    if mesh is None:
        return step, _fill(template, tree, cfg, "")
    from repro_torch.launch import mesh as mesh_lib, sharding
    shape, coords = mesh_lib.mesh_shape(mesh), mesh_lib.mesh_coords(mesh)
    cut = lambda t, sp: sharding.local_block(t, sp, shape, coords)
    return step, _fill(template, tree, cfg, "", cut, specs)


def save_sharded(directory: str, step: int, tree, cfg: ModelConfig, mesh, specs):
    """Save a train state held as blocks across the ranks of ``mesh``
    (``specs``: its spec tree) as one checkpoint in the canonical
    (unsharded, JAX) layout: each leaf is gathered whole to rank 0's host
    alone (``runtime.sharded.gather_tree``), rank 0 writes, and every rank
    waits for the write (a barrier). Returns, on rank 0, the whole tree it
    wrote, in the port's layout; None on the other ranks."""
    import torch.distributed as dist
    from repro_torch.runtime.sharded import MeshLayout, gather_tree
    whole = gather_tree(tree, specs, MeshLayout(mesh))
    if whole is not None:
        save(directory, step, jax_layout(whole, cfg))
    dist.barrier()
    return whole


def gc_old(directory: str, keep: int = 3):
    if not os.path.isdir(directory):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot to the host, then write in a background thread. ``wait()``
    blocks until the save in flight lands (call before process exit / the
    next save) and raises what it raised."""

    def __init__(self, directory: str, cfg: ModelConfig, keep: int = 3):
        self.directory = directory
        self.cfg = cfg
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, metadata: Optional[dict] = None):
        """``tree`` in the port's layout (device tensors)."""
        self.wait()
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)  # blocking D2H

        def _write():
            try:
                save(self.directory, step, jax_layout(host, self.cfg), metadata)
                gc_old(self.directory, self.keep)
            except BaseException as e:  # propagate on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
