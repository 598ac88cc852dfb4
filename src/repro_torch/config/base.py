"""Configuration dataclasses for the repro framework.

Model architecture, NSA sparse attention, SSV speculative verification and
serving. Configs are plain frozen dataclasses so they hash,
compare, and serialize trivially (msgpack/json via ``asdict``).

A copy of ``repro.config.base`` (stdlib only) with the same fields and
defaults for the configs the port serves with, kept in the PyTorch package
so it imports nothing of the JAX one. ``ShapeConfig`` and ``SHAPES`` are the
dry run's cell shapes; the mesh config has no single-card counterpart.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _freeze(x):
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    return x


@dataclass(frozen=True)
class NSAConfig:
    """Native Sparse Attention hyperparameters (paper §2.2, §7 defaults)."""

    cmp_block: int = 32        # compression block length l
    cmp_stride: int = 16       # compression stride d
    sel_block: int = 64        # selection block size l'
    n_selected: int = 16       # Top-n selected blocks
    window: int = 512          # sliding-window size w
    # Mandatory blocks always included in the selection set (paper: initial +
    # local blocks give the s=3 overlap lower bound).
    n_init_blocks: int = 1
    n_local_blocks: int = 2

    def num_cmp_blocks(self, kv_len: int) -> int:
        if kv_len < self.cmp_block:
            return 0
        return (kv_len - self.cmp_block) // self.cmp_stride + 1

    def num_sel_blocks(self, kv_len: int) -> int:
        return max(0, -(-kv_len // self.sel_block))


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN."""

    num_experts: int = 8
    top_k: int = 2
    d_expert: int = 0          # expert hidden dim (0 -> use model d_ff)
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    router_jitter: float = 0.0
    # GShard-style dispatch group size: dispatch-einsum overhead scales as
    # group·cf/(3·d_ff), so thin-expert archs (qwen3-moe) use smaller groups.
    dispatch_group: int = 1024


@dataclass(frozen=True)
class RecurrentConfig:
    """Recurrent-block (RG-LRU / xLSTM) hyperparameters."""

    kind: str = "rglru"        # "rglru" | "mlstm" | "slstm"
    conv_width: int = 4        # temporal conv width before the recurrence
    state_dim: int = 0         # 0 -> d_model
    num_heads: int = 0         # 0 -> model heads


@dataclass(frozen=True)
class ModelConfig:
    """Generic decoder-only LM description covering the 10 assigned archs.

    ``block_pattern`` selects the per-layer block type; it is tiled to
    ``num_layers``. "attn" = attention+FFN block, "recur" = recurrent block,
    "moe" = attention + MoE-FFN block.
    """

    name: str = "model"
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0                      # 0 -> d_model // num_heads
    max_seq_len: int = 8192

    # Attention backend: "dense" | "nsa" | "swa" (sliding-window only)
    attention: str = "dense"
    # Train/prefill attention implementation: "chunked" materializes masked
    # score chunks (paper-faithful baseline); "online" is the flash-style
    # online-softmax XLA path (§Perf optimization — no score materialization)
    attention_impl: str = "chunked"
    window: int = 0                        # sliding window for attention="swa"
    qk_norm: bool = False
    rope_theta: float = 10000.0

    # FFN
    activation: str = "swiglu"             # swiglu | squared_relu | geglu | gelu
    moe: Optional[MoEConfig] = None

    # Layer pattern, e.g. ("recur", "recur", "attn") for recurrentgemma 1:2.
    block_pattern: Tuple[str, ...] = ("attn",)
    recurrent: Optional[RecurrentConfig] = None

    nsa: NSAConfig = field(default_factory=NSAConfig)

    # Modality frontend stub: "text" | "audio" | "vision"
    modality: str = "text"
    frontend_dim: int = 0                  # embedding dim of precomputed frames/patches

    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # Norm
    norm_eps: float = 1e-6

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        object.__setattr__(self, "block_pattern", _freeze(self.block_pattern))
        assert self.num_heads % self.num_kv_heads == 0, (
            f"num_heads={self.num_heads} not divisible by num_kv_heads={self.num_kv_heads}")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    # ---- analytic parameter / FLOP accounting (used by roofline) ----
    def param_count(self) -> int:
        d, h = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        embed = self.vocab_size * d
        out_head = 0 if self.tie_embeddings else self.vocab_size * d
        total = embed + out_head + d  # final norm
        kinds = self.layer_kinds()
        for kind in kinds:
            total += 2 * d  # two norms per block
            if kind in ("rglru", "mlstm", "slstm"):
                rc = self.recurrent
                sd = (rc.state_dim if rc else 0) or d
                cw = rc.conv_width if rc else 4
                if kind == "rglru":
                    total += 3 * d * sd + 2 * sd * sd + (cw + 1) * sd
                elif kind == "mlstm":
                    H = (rc.num_heads if rc else 0) or self.num_heads
                    total += 5 * d * d + 2 * d * H + H
                else:  # slstm
                    total += 9 * d * d + 4 * d
                total += self._ffn_params() if self.d_ff else 0
                continue
            # attention
            total += d * nq * h + 2 * d * nkv * h + nq * h * d
            if self.attention == "nsa":
                total += self.nsa.cmp_block * 2 + 3 * d  # pooling weights + gates
            if self.qk_norm:
                total += 2 * h
            total += self._ffn_params(moe=(kind == "moe"))
        return int(total)

    def _ffn_params(self, moe: bool = False) -> int:
        d = self.d_model
        gated = self.activation in ("swiglu", "geglu")
        per_ffn = (3 if gated else 2) * d * self.d_ff
        if moe and self.moe is not None:
            dff = self.moe.d_expert or self.d_ff
            per_exp = (3 if gated else 2) * d * dff
            return self.moe.num_experts * per_exp + d * self.moe.num_experts + \
                self.moe.num_shared_experts * per_ffn
        return per_ffn

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        dff = self.moe.d_expert or self.d_ff
        gated = self.activation in ("swiglu", "geglu")
        per_exp = (3 if gated else 2) * d * dff
        n_moe_layers = sum(1 for k in self.layer_kinds() if k == "moe")
        inactive = n_moe_layers * (self.moe.num_experts - self.moe.top_k) * per_exp
        return self.param_count() - int(inactive)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: training or serving shapes."""

    name: str = "train_4k"
    seq_len: int = 4096
    global_batch: int = 256
    kind: str = "train"  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh's shape and axis names (a copy of the JAX
    ``MeshConfig``); ``launch.mesh`` builds it over torch ranks."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        object.__setattr__(self, "shape", _freeze(self.shape))
        object.__setattr__(self, "axes", _freeze(self.axes))

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class SSVConfig:
    """Sparse speculative verification strategy tuple (θ_d, θ_s) + class P."""

    # θ_d — draft-side
    tree_depth: int = 4            # D
    tree_width: int = 2            # k (branching at each expansion)
    traversal: str = "bfs"         # "bfs" | "dfs"
    tree_budget: int = 0           # max nodes (0 -> full D,k tree)
    # θ_s — sparse-verification side
    group_size: int = 2            # coarsening factor C
    group_mode: str = "exact"      # "exact" | "approx" | "none"
    refresh_schedule: Tuple[int, ...] = ()  # layer indices that REUSE (empty -> all refresh)
    # P — precision class
    precision_class: str = "Strict"  # Strict | Reuse-only | Approx-only | Approx+Reuse

    def __post_init__(self):
        object.__setattr__(self, "refresh_schedule", _freeze(self.refresh_schedule))

    def num_draft_tokens(self) -> int:
        """Nodes in a full (D,k) tree, truncated to the budget."""
        n = 0
        level = 1
        for _ in range(self.tree_depth):
            level *= self.tree_width
            n += level
        if self.tree_budget:
            n = min(n, self.tree_budget)
        return n


@dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig``'s fields and defaults, except two:
    ``checkpoint_dir`` defaults to a directory under the working directory,
    and ``checkpoint_every <= 0`` saves no checkpoint at all (the JAX
    trainer always saves the last step), which a full-width run that only
    measures steps uses."""

    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    micro_batches: int = 1
    checkpoint_every: int = 50
    checkpoint_dir: str = "build/ckpt"
    seed: int = 0
    remat: bool = True
    grad_compression: str = "none"  # none | int8_ef
    log_every: int = 10


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_new_tokens: int = 128
    temperature: float = 0.0
    max_context: int = 16384
    ssv: SSVConfig = field(default_factory=SSVConfig)
    use_planner: bool = True
    # KV-cache store backend (core/kvstore.py): "dense" keeps per-request
    # (max_context, ...) buffers; "paged" shares a physical page pool across
    # requests through per-row page tables, so batch KV memory scales with
    # live tokens. kv_page_size=0 -> the model's nsa.sel_block (selected-
    # block gather becomes a page-table lookup); kv_num_pages=0 -> a pool
    # sized for worst-case occupancy (slots * max_context / page_size).
    kv_backend: str = "dense"
    kv_page_size: int = 0
    kv_num_pages: int = 0
