"""The dry run's cell matrix on one card — the single-card counterpart of
``repro.launch.specs``, which builds ShapeDtypeStruct inputs and shardings
for every (architecture x input shape x mesh) cell. One card has no mesh
and no sharding; what carries over is the matrix, each cell's config and
the bytes it holds on the card.

Shape semantics (the JAX module's):
  train_4k / prefill_32k -> a train step / a prefill over the arch's
      native attention;
  decode_32k             -> a decode step (1 new token, 32K KV cache);
  long_500k              -> a decode step at 524,288 context, with the NSA
      variant for attention archs (``DRYRUN["long_500k"]["nsa"]``) and
      natively for the recurrent archs.
The cache is FULL to ``seq_len`` and holds ``CACHE_SLACK`` more slots.

``cell_bytes`` reckons a cell's static bytes from shapes alone, on the
``meta`` device (``roofline.param_tree`` / ``cache_tree``): the weights;
for a train cell also their gradients (the params' dtype) and AdamW's two
float32 moments; for a prefill cell the target's caches at ``seq_len +
CACHE_SLACK``; for a decode cell (served by SSV) the target's caches and
the draft's weights and caches (``core.draft.draft_config``). Activations
and the serving step's transient buffers are not reckoned, so a cell whose
static bytes fit may still not run; ``dryrun --run`` measures the peak.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

from repro_torch import configs as cfglib
from repro_torch.analysis import roofline as rl
from repro_torch.config import SHAPES, ModelConfig
from repro_torch.core.draft import draft_config

SHAPE_BY_NAME = {s.name: s for s in SHAPES}
CACHE_SLACK = 512


def cell_config(arch_id: str, shape_name: str) -> Tuple[ModelConfig, Dict]:
    """The cell's config (``dryrun_overrides`` applied: the NSA variant
    where the override asks for it) and the overrides."""
    cfg = cfglib.get_config(arch_id)
    over = cfglib.dryrun_overrides(arch_id).get(shape_name, {})
    if over.get("nsa"):
        cfg = cfglib.nsa_variant(cfg)
    return cfg, over


@functools.lru_cache(maxsize=64)
def _param_stats(cfg: ModelConfig) -> Tuple[int, int]:
    tree = rl.param_tree(cfg)
    return rl.tree_bytes(tree), rl.tree_numel(tree)


def param_bytes(cfg: ModelConfig) -> int:
    """Bytes of the parameter tree (``meta``: shapes and dtypes only)."""
    return _param_stats(cfg)[0]


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    return rl.tree_bytes(rl.cache_tree(cfg, batch, max_len))


def cell_bytes(arch_id: str, shape_name: str, batch: int) -> Dict[str, int]:
    """The cell's static bytes at ``batch`` rows, by part, and ``total``."""
    return config_bytes(cell_config(arch_id, shape_name)[0], SHAPE_BY_NAME[shape_name], batch,
                        cfglib.frontend_len(arch_id))


def config_bytes(cfg: ModelConfig, shape, batch: int, frames: int = 0) -> Dict[str, int]:
    """``cell_bytes`` of ``cfg`` at ``shape`` (a ``ShapeConfig``). A train
    or prefill cell of an arch with a frontend also holds its input,
    ``frames`` bf16 frames of ``cfg.frontend_dim`` a row (the JAX dry
    run's ``fe``): ``frontend_input``."""
    w = param_bytes(cfg)
    out = {"weights": w}
    if frames and cfg.frontend_dim and shape.kind in ("train", "prefill"):
        out["frontend_input"] = batch * frames * cfg.frontend_dim * 2
    if shape.kind == "train":
        out.update(grads=w, adam_moments=2 * 4 * _param_stats(cfg)[1])
    else:
        max_len = shape.seq_len + CACHE_SLACK
        out["target_cache"] = cache_bytes(cfg, batch, max_len)
        if shape.kind == "decode":
            dcfg = draft_config(cfg)
            out.update(draft_weights=param_bytes(dcfg),
                       draft_cache=cache_bytes(dcfg, batch, max_len))
    out["total"] = sum(out.values())
    return out


def fit_batch(arch_id: str, shape_name: str, capacity: float = rl.HBM_PER_CARD) -> int:
    """The largest batch, at most the cell's ``global_batch``, whose static
    bytes fit ``capacity`` (0 when not even one row fits). The caches grow
    linearly with the batch, the weights not at all."""
    shape = SHAPE_BY_NAME[shape_name]
    one, two = cell_bytes(arch_id, shape_name, 1)["total"], cell_bytes(arch_id, shape_name, 2)["total"]
    per_row = two - one
    if one > capacity:
        return 0
    if per_row <= 0:
        return shape.global_batch
    return int(min(shape.global_batch, 1 + (capacity - one) // per_row))
