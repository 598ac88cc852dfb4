"""Architecture registry: ``--arch <id>`` resolution.

The port carries every architecture of the JAX package, each module a copy
of the JAX package's (CONFIG, and DRYRUN / FRONTEND_LEN where it has them).
``reduced()`` builds the CI-scale variant and ``nsa_variant()`` the
SSV-serving variant exactly as ``repro.configs`` does.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from repro_torch.config import ModelConfig, MoEConfig, NSAConfig

ARCH_IDS = (
    "recurrentgemma-9b", "nemotron-4-340b", "smollm-360m", "granite-20b",
    "qwen3-8b", "mixtral-8x22b", "qwen3-moe-235b-a22b", "xlstm-125m",
    "musicgen-medium", "pixtral-12b", "ssv-nsa-1b", "ssv-nsa-8b",
)


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def dryrun_overrides(arch_id: str) -> Dict:
    return getattr(_module(arch_id), "DRYRUN", {})


def frontend_len(arch_id: str) -> int:
    return getattr(_module(arch_id), "FRONTEND_LEN", 0)


def nsa_variant(cfg: ModelConfig) -> ModelConfig:
    """The SSV-serving variant of an architecture: attention layers replaced
    by NSA (paper §7.2, 'attention layers replaced by NSA-based sparse
    verification'). No-op for attention-free archs."""
    if all(k in ("rglru", "mlstm", "slstm") for k in cfg.layer_kinds()):
        return cfg
    return dataclasses.replace(cfg, attention="nsa", name=cfg.name + "-nsa")


def reduced(arch_id: str, *, vocab: int = 512, layers: Optional[int] = None,
            d_model: int = 0, seq_cap: int = 2048) -> ModelConfig:
    """CI-scale variant preserving the family (pattern, attention kind, MoE
    topology, modality) with tiny dims."""
    cfg = get_config(arch_id)
    pat = cfg.block_pattern
    L = layers if layers is not None else max(2, 2 * len(pat))
    L = max(L, len(pat))
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    d = d_model or 64 * heads
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=min(cfg.moe.num_experts, 4),
                        top_k=min(cfg.moe.top_k, 2),
                        d_expert=128, dispatch_group=64)
    rec = cfg.recurrent
    if rec is not None:
        rec = dataclasses.replace(rec, num_heads=min(rec.num_heads or heads, heads))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=L, d_model=d, num_heads=heads, num_kv_heads=kv,
        head_dim=0,
        d_ff=0 if cfg.d_ff == 0 else 2 * d,
        vocab_size=vocab, max_seq_len=seq_cap,
        window=min(cfg.window, 64) if cfg.window else 0,
        moe=moe, recurrent=rec,
        frontend_dim=32 if cfg.frontend_dim else 0,
        nsa=NSAConfig(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4,
                      window=32),
        dtype="float32",
    )
