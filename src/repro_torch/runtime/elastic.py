"""Elastic scaling: re-mesh planning — the counterpart of
``repro.runtime.elastic``.

When the healthy device pool changes (node loss, capacity change), training
resumes on a new mesh: checkpoints are mesh-free (``ckpt/checkpoint.py``),
so the restart path is plan_mesh(n_devices) -> build the mesh over the new
world -> restore. ``plan_mesh`` picks the largest usable (data, model)
factorization, keeping the model-parallel degree when possible (the TP
degree is a property of the model's layout; the DP degree flexes).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.config import MeshConfig
from repro_torch.launch import mesh as mesh_lib


def plan_mesh(num_devices: int, prefer_model: int = 1,
              multi_pod: bool = False, pod_size: int = 0) -> MeshConfig:
    """Largest mesh <= num_devices. Keeps the model axis at ``prefer_model``
    when divisible, shrinking it only when unavoidable."""
    model = prefer_model
    while model > 1 and num_devices % model:
        model //= 2
    data = num_devices // model
    if multi_pod and pod_size and num_devices % pod_size == 0:
        pods = num_devices // pod_size
        data = pod_size // model
        return MeshConfig(shape=(pods, data, model), axes=("pod", "data", "model"))
    return MeshConfig(shape=(data, model), axes=("data", "model"))


def build_mesh(cfg: MeshConfig, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``cfg`` over the initialised world. Raises, as
    the JAX ``build_mesh`` does, when the world has fewer ranks than the
    mesh needs (and, since a torch mesh spans the whole world, when it has
    more)."""
    n = cfg.num_devices
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return mesh_lib.make_mesh(cfg.shape, cfg.axes, device_type)
