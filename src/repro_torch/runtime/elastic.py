"""Elastic scaling: re-mesh planning — the counterpart of
``repro.runtime.elastic``.

When the healthy device pool changes (node loss, capacity change), training
resumes on a new mesh: checkpoints are mesh-free (``ckpt/checkpoint.py``),
so the restart path is plan_mesh(n_devices) -> build the mesh over the new
world -> restore; ``resume`` is that path. ``plan_mesh`` picks the largest
usable (data, model) factorization, keeping the model-parallel degree when
possible (the TP degree is a property of the model's layout; the DP degree
flexes).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.bridge import init_params
from repro_torch.ckpt import restore
from repro_torch.config import MeshConfig, ModelConfig, TrainConfig
from repro_torch.launch import mesh as mesh_lib, sharding
from repro_torch.optim import AdamWState


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


def block_template(cfg: ModelConfig, tcfg: TrainConfig, mesh, device) -> Tuple[Dict, Dict]:
    """(an empty train state of this rank's block shapes on ``device``, its
    spec tree ``sharding.state_specs``): the ``restore`` template."""
    shape = mesh_lib.mesh_shape(mesh)
    comp = tcfg.grad_compression == "int8_ef"
    meta = init_params(cfg, torch.Generator(), "meta")
    specs = sharding.state_specs(meta, mesh, comp)
    blocks = sharding.map_specs(
        lambda key, t, sp: torch.empty(sharding.local_shape(t.shape, sp, shape), dtype=t.dtype,
                                       device=device), meta, specs["params"])
    moments = lambda: sharding.map_specs(lambda key, t, sp: torch.empty(t.shape, device=device),
                                         blocks, specs["params"])
    tree = {"params": blocks,
            "opt": AdamWState(mu=moments(), nu=moments(),
                              count=torch.zeros((), dtype=torch.int32, device=device)),
            "residual": moments() if comp else torch.zeros((), device=device)}
    return tree, specs


def resume(directory: str, cfg: ModelConfig, tcfg: TrainConfig, device_type: str = "cuda"
           ) -> Tuple[Any, int, Dict]:
    """The restart path on the initialised world: ``plan_mesh`` of its
    ranks (all of them along the data axis) -> ``build_mesh`` -> ``restore``
    of the newest checkpoint onto the mesh, each rank cutting its blocks.
    Returns (the mesh, the step, this rank's train state {"params", "opt",
    "residual"}), ready for ``make_train_step(cfg, tcfg, mesh)``."""
    mesh = build_mesh(plan_mesh(dist.get_world_size()), device_type)
    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")
    template, specs = block_template(cfg, tcfg, mesh, device)
    got, tree = restore(directory, template, cfg, mesh=mesh, specs=specs)
    return mesh, got, tree
