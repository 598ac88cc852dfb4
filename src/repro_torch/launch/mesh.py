"""Device meshes over torch ranks — the counterpart of ``repro.launch.mesh``.

Single pod: (16, 16) = 256 ranks, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model); the pod axis
carries cross-pod data parallelism.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world
that the caller initialised (``torch.distributed.init_process_group``):
rank r sits at the row-major coordinates of r in the mesh shape, as
``jax.make_mesh`` places devices. Every constructor is a FUNCTION: importing
this module touches no process group. A constructor raises when no process
group is initialised (it never starts one) and when the mesh's size is not
the world size.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch.distributed as dist

from repro_torch.config import MeshConfig


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    if multi_pod:
        return MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))
    return MeshConfig(shape=(16, 16), axes=("data", "model"))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: everything except 'model'. ``mesh`` is a
    ``DeviceMesh``, a ``MeshConfig`` or a sequence of axis names."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, MeshConfig):
        return mesh.axes
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the whole world."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised; call "
                           "torch.distributed.init_process_group first")
    n = MeshConfig(shape, axes).num_devices
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    cfg = mesh_config(multi_pod=multi_pod)
    return make_mesh(cfg.shape, cfg.axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, device_type: str = "cuda"):
    """Small (data, model) mesh; the CPU tests pass ``device_type="cpu"``
    over a gloo world of ``data * model`` ranks."""
    return make_mesh((data, model), ("data", "model"), device_type)


def mesh_shape(mesh) -> dict:
    """{axis name: size}, as ``jax.sharding.Mesh.shape`` gives it."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_coords(mesh) -> dict:
    """{axis name: this rank's coordinate along it}."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def axes_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's row-major index over ``axes``, their product): the
    shard that a dimension sharded over ``axes`` gives this rank."""
    shape, coords = mesh_shape(mesh), mesh_coords(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * shape[a] + coords[a]
        n *= shape[a]
    return idx, n


def axes_group(mesh, axes: Sequence[str]):
    """The process group of the ranks that differ only along ``axes``
    (one axis: its group; several: the mesh flattened over them)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()
