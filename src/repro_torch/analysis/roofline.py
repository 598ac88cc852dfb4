"""Roofline model for one NVIDIA H100 (SXM, 80 GB) — the counterpart of
``repro.analysis.roofline``, which models a TPU v5e.

Hardware constants (per card, NVIDIA's data sheet, dense rates at the
700 W power limit):
  peak bf16 compute : 989 TFLOP/s (tensor cores)
  float32 compute   : 67 TFLOP/s (CUDA cores, outside the tensor cores)
  HBM bandwidth     : 3.35 TB/s
  HBM               : 80 GiB (the fit is checked against the card's own
                      ``total_memory`` where a card is present)
  NVLink            : 450 GB/s each way per card; collectives are charged
                      against it (0 s on one card, which moves no wire bytes)

Terms per (arch x shape), in seconds per step:
  compute    = flops / peak
  memory     = hbm_bytes / hbm_bw
  collective = wire_bytes / link_bw

The JAX module takes flops, HBM bytes and wire bytes per device from the
compiled HLO (``repro.analysis.hlo``). The port has no compiled program to
read, so ``step_cost`` counts them analytically: the weights read once,
plus the bytes and flops of each attention launch (``StepCost``). The
roofline fraction is useful model FLOPs (``model_flops``, the JAX formula
exactly) over the step time at peak.

The kernels' bounds (``bound``, ``verify_bound``, ``routing_bound``,
``flash_bound``) are the least time one launch could take on these inputs:
the larger of the bytes each input and output moves once over the HBM rate
and the flops the visible (row, key) pairs need over the rate of the
kernel's dots. ``chip_smoke.py`` prints them beside the kernels' times.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

PEAK_FLOPS = 989e12          # bf16 / card, tensor cores, dense
F32_FLOPS = 67e12            # float32 / card, CUDA cores
HBM_BW = 3.35e12             # B/s
LINK_BW = 450e9              # B/s each way per card (NVLink 4)
HBM_PER_CARD = 80 * 1024**3  # 80 GiB


@dataclasses.dataclass
class Roofline:
    """The JAX ``Roofline``'s fields and properties. ``hlo_flops_per_dev``
    and ``hbm_bytes_per_dev`` hold ``step_cost``'s counts, which stand in
    for the HLO's; ``capacity_bytes`` is the card's memory the fit is
    checked against."""

    arch: str
    shape: str
    mesh: str
    num_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_per_dev: float
    hbm_bytes_per_dev: float
    wire_bytes_per_dev: float
    bytes_per_dev_peak: float
    capacity_bytes: float = HBM_PER_CARD

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops across all devices)."""
        total = self.hlo_flops_per_dev * self.num_devices
        return self.model_flops / total if total > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the cards' peak FLOP/s the step achieves on useful
        model flops."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return (self.model_flops / t) / (PEAK_FLOPS * self.num_devices)

    @property
    def fits_hbm(self) -> bool:
        return self.bytes_per_dev_peak <= self.capacity_bytes

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "devices": self.num_devices,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.hlo_flops_per_dev,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bytes_per_dev": self.bytes_per_dev_peak,
            "fits_hbm": self.fits_hbm,
        }


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs per step: 6·N·D train (N = active params), plus the
    attention term; decode: 2·N·B per emitted token + attention reads."""
    n_active = cfg.active_param_count()
    L, H, Dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0 if shape.kind == "train" else 2.0
        base = mult * n_active * tokens
        # causal attention: mult·B·L·H·Dh·S²/2 (fwd 2x ops qk+pv)
        attn = mult * shape.global_batch * L * H * Dh * shape.seq_len ** 2 / 2 \
            if cfg.attention != "nsa" else \
            mult * shape.global_batch * L * H * Dh * shape.seq_len * (
                cfg.nsa.n_selected * cfg.nsa.sel_block + cfg.nsa.window +
                shape.seq_len // cfg.nsa.cmp_stride)
        return base + attn
    # decode: one token per sequence
    base = 2.0 * n_active * shape.global_batch
    if cfg.attention == "nsa":
        ctx = (cfg.nsa.n_selected * cfg.nsa.sel_block + cfg.nsa.window +
               shape.seq_len // cfg.nsa.cmp_stride)
    else:
        ctx = shape.seq_len
    attn = 4.0 * shape.global_batch * L * H * Dh * ctx
    return base + attn


# ---------------------------------------------------------------- step cost
@dataclasses.dataclass(frozen=True)
class StepCost:
    """What one step must compute and move on one device (the port's
    stand-in for the HLO ``Analysis``); ``weight_bytes`` is the part of
    ``hbm_bytes`` that the weights take."""

    flops: float
    hbm_bytes: float
    wire_bytes: float = 0.0
    weight_bytes: float = 0.0


def _tensors(tree):
    """The tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_bytes(tree) -> int:
    return sum(t.nbytes for t in _tensors(tree))


def tree_numel(tree) -> int:
    return sum(t.numel() for t in _tensors(tree))


def param_tree(cfg):
    """The parameter tree's shapes and dtypes (``device="meta"``), the
    counterpart of ``jax.eval_shape(model.init)``."""
    from repro_torch.bridge import init_params
    return init_params(cfg, torch.Generator(), "meta")


def cache_tree(cfg, batch: int, max_len: int):
    """``model.init_caches``' shapes and dtypes (``device="meta"``)."""
    from repro_torch.models import model
    return model.init_caches(cfg, batch, max_len, "meta")


def _attention_kinds(cfg):
    return [k for k in cfg.layer_kinds() if k not in ("rglru", "mlstm", "slstm")]


def attention_flops(cfg, B: int, S: int) -> float:
    """Forward FLOPs the train attention needs per step (all attention
    layers): 2 x Dh for the logit and 2 x Dh for the value product of each
    (query, key) pair a query attends, per query head. A query at position
    p attends p + 1 keys in the dense causal attention (at most ``window``
    under a sliding window); under NSA it attends the num_cmp_blocks(p)
    compressed blocks of its prefix, at most min(n_selected x sel_block, p)
    selected keys and min(window, p + 1) window keys. The masked products
    the plain NSA version computes are not counted."""
    p = np.arange(S, dtype=np.float64)
    if cfg.attention == "nsa":
        nsa = cfg.nsa
        ncb = np.where(p < nsa.cmp_block, 0, (p - nsa.cmp_block) // nsa.cmp_stride + 1)
        keys = ncb + np.minimum(nsa.n_selected * nsa.sel_block, p) + np.minimum(nsa.window, p + 1)
    elif cfg.attention == "swa" and cfg.window:
        keys = np.minimum(cfg.window, p + 1)
    else:
        keys = p + 1
    return 4 * cfg.head_dim * cfg.num_heads * B * float(keys.sum()) * len(_attention_kinds(cfg))


def train_flops_needed(cfg, n_matmul: int, B: int, S: int) -> float:
    """Model FLOPs of one train step by what the function needs: 6 x the
    parameters that enter a product (the embedding lookup is none) x tokens
    plus 3 x the attention forward FLOPs (forward + backward); remat's
    recomputed forward and masked products are not counted."""
    return 6 * n_matmul * B * S + 3 * attention_flops(cfg, B, S)


def flops_share(flops: float, seconds: float, peak: float = PEAK_FLOPS) -> float:
    """The share of ``peak`` FLOP/s that ``flops`` in ``seconds`` reach."""
    return flops / seconds / peak


def _decode_keys(cfg, ctx: int) -> int:
    """Keys a query reads per kv head in one attention layer over a cache
    of ``ctx`` committed tokens."""
    if cfg.attention == "nsa":
        nsa = cfg.nsa
        ncb = 0 if ctx < nsa.cmp_block else (ctx - nsa.cmp_block) // nsa.cmp_stride + 1
        return ncb + min(nsa.n_selected * nsa.sel_block, ctx) + min(nsa.window, ctx)
    if cfg.attention == "swa" and cfg.window:
        return min(cfg.window, ctx)
    return ctx


def step_cost(cfg, shape, batch: Optional[int] = None,
              weight_bytes: Optional[int] = None) -> StepCost:
    """The analytic count of one step of ``shape`` (a ``ShapeConfig``) at
    ``batch`` rows (default: the shape's ``global_batch``) on one device.

    Weights are read once: the parameter tree's bytes (``param_tree``, or
    ``weight_bytes``), with the embedding table replaced by the rows a step
    looks up (unless it is tied to the output head) and, in MoE layers, only
    the experts the step's tokens can reach. Decode (one token per row, the
    cache full to ``seq_len``): each attention layer reads, per kv head,
    the keys and values the token attends (NSA: the visible compressed
    blocks, n x l' selected and w window tokens; dense: the prefix; SWA:
    the window) and writes the new row; 2 x (active params - embedding)
    flops per token plus 4 x Dh per (query head, key). Prefill: one pass over the prompt writing its caches.
    Train: weights read by the forward and the backward pass, gradients
    written and read, AdamW's reads and writes of the params and the two
    float32 moments; flops ``train_flops_needed``. Activations are not
    counted."""
    B = shape.global_batch if batch is None else batch
    params = None
    if weight_bytes is None:
        params = param_tree(cfg)
        weight_bytes = tree_bytes(params)
    es = 2 if cfg.dtype == "bfloat16" else 4
    d, Dh, Hq, Hkv = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    n_att = len(_attention_kinds(cfg))
    table = cfg.vocab_size * d
    n_matmul = cfg.active_param_count() - (0 if cfg.tie_embeddings else table)
    if shape.kind == "train":
        n = cfg.param_count()
        hbm = 6 * weight_bytes + 16 * n
        return StepCost(train_flops_needed(cfg, n_matmul, B, shape.seq_len), hbm,
                        weight_bytes=weight_bytes)
    tokens = B * (shape.seq_len if shape.kind == "prefill" else 1)
    read = weight_bytes
    if not cfg.tie_embeddings:
        read += tokens * d * es - table * es
    if cfg.moe is not None:
        m = cfg.moe
        per_exp = (3 if cfg.activation in ("swiglu", "geglu") else 2) * d * (m.d_expert or cfg.d_ff)
        n_moe = sum(k == "moe" for k in cfg.layer_kinds())
        unused = max(0, m.num_experts - tokens * m.top_k)
        read -= n_moe * unused * per_exp * es
    if shape.kind == "prefill":
        caches = tree_bytes(cache_tree(cfg, B, shape.seq_len))
        flops = 2 * n_matmul * tokens + attention_flops(cfg, B, shape.seq_len)
        return StepCost(flops, read + caches, weight_bytes=weight_bytes)
    keys = _decode_keys(cfg, shape.seq_len)
    attn_bytes = n_att * B * Hkv * Dh * es * 2 * (keys + 2)     # read; the new row in, out
    attn_flops = n_att * B * Hq * 4 * Dh * (keys + 1)
    return StepCost(2 * n_matmul * tokens + attn_flops, read + attn_bytes,
                    weight_bytes=weight_bytes)


def build(arch: str, shape, mesh_name: str, num_devices: int, cfg, cost: StepCost,
          mem_bytes_per_dev: float, capacity_bytes: float = HBM_PER_CARD) -> Roofline:
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, num_devices=num_devices,
        compute_s=cost.flops / PEAK_FLOPS, memory_s=cost.hbm_bytes / HBM_BW,
        collective_s=cost.wire_bytes / LINK_BW,
        model_flops=model_flops(cfg, shape), hlo_flops_per_dev=cost.flops,
        hbm_bytes_per_dev=cost.hbm_bytes, wire_bytes_per_dev=cost.wire_bytes,
        bytes_per_dev_peak=mem_bytes_per_dev, capacity_bytes=capacity_bytes)


# ---------------------------------------------------------------- kernel bounds
def bound(nbytes, flops, flops_per_s=F32_FLOPS):
    """(ms, "bytes" or "operations", bytes-alone ms). The flops count at
    ``flops_per_s``: the bf16 tensor-core rate for a kernel whose dots run
    there (bf16 K/V, so their bytes set the bound), the float32 CUDA-core
    rate otherwise (float32 K/V)."""
    t_bytes, t_flops = nbytes / HBM_BW, flops / flops_per_s
    return (max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations"),
            t_bytes * 1e3)


def dot_rate(kv_dtype):
    """The rate of a redesigned kernel's dots: tensor cores for bf16 K/V,
    CUDA cores for float32 K/V."""
    return PEAK_FLOPS if kv_dtype == torch.bfloat16 else F32_FLOPS


def _visible_cmp(pos, ncbv: int, nsa):
    return ((pos - nsa.cmp_block + 1).clamp_min(-1) // nsa.cmp_stride + 1).clamp(0, ncbv)


def verify_bound(cfg, inp, args, include_cmp, branch="all"):
    """Least time for one verify launch (row 0 of ``inp``): bytes each
    input/output moves once (the union of selected blocks per head, the
    visible window, cmp and draft K/V of the branches it computes; the page
    table when paged) vs the flops the visible (row, key) pairs need.
    ``inp`` holds the kernel's dense inputs (q, k_cache, sel_idx, sel_valid,
    positions, prefix_len, gates), ``args`` its layouts (merged, mvalid,
    own, dmask, positions, win_start, ncb_valid[, page_table])."""
    nsa = cfg.nsa
    dev = inp["q"].device
    es = inp["k_cache"].element_size()
    T, Hq, Dh = inp["q"].shape[1:]
    Hkv = inp["k_cache"].shape[2]
    Gq = Hq // Hkv
    prefix = int(inp["prefix_len"][0])
    pos = inp["positions"][0].long()
    do_slc, do_win = branch in ("all", "slc"), branch in ("all", "win")
    merged, mvalid = args["merged"][0].long(), args["mvalid"][0]
    slc_blocks = 0                  # selected blocks summed over the kv heads
    for h in range(Hkv if do_slc else 0):
        blocks = merged[:, h][(mvalid[:, h] > 0) & (merged[:, h] >= 0)]
        blocks = blocks[blocks * nsa.sel_block < prefix]
        slc_blocks += int(torch.unique(blocks).numel())
    W = min(nsa.window, inp["k_cache"].shape[1])
    win_keys = max(0, prefix - int(args["win_start"][0])) if do_win else 0
    nvis = _visible_cmp(pos, int(args["ncb_valid"][0]), nsa)
    keys_per_head = win_keys + (T if do_win else 0) + (int(nvis.max()) if include_cmp else 0)
    nbytes = (slc_blocks * nsa.sel_block + keys_per_head * Hkv) * Dh * 2 * es
    nbytes += inp["q"].numel() * 4 * 2                               # q, out
    if branch == "all":
        nbytes += inp["gates"].numel() * 4
        nbytes += 0 if include_cmp else inp["q"].numel() * 4          # o_cmp_in
    nbytes += sum(args[k].numel() * 4 for k in ("merged", "mvalid", "own", "dmask", "positions"))
    if "page_table" in args:
        nbytes += args["page_table"].numel() * 4
    # visible (query row, key) pairs: slc keys per query = its own selected
    # tokens below prefix and at/below its position
    slc = win = draft = 0
    if do_slc:
        tok = inp["sel_idx"][0].long()[..., None] * nsa.sel_block + \
            torch.arange(nsa.sel_block, device=dev)
        slc = ((tok < prefix) & (tok <= pos[:, None, None, None]) &
               inp["sel_valid"][0][..., None]).sum()
    if do_win:
        kp = torch.arange(W, device=dev) + int(args["win_start"][0])
        win = ((kp[None] < prefix) & (kp[None] > pos[:, None] - nsa.window) &
               (kp[None] <= pos[:, None])).sum() * Hkv
        draft = args["dmask"][0].sum() * Hkv
    cmpk = nvis.sum() * Hkv if include_cmp else 0
    return bound(nbytes, int(slc + win + draft + cmpk) * Gq * 4 * Dh,
                 dot_rate(inp["k_cache"].dtype))


def routing_bound(cfg, inp):
    """Bytes: the visible cmp K/V of each kv head once, q, o_cmp, p_slc,
    positions; flops: 4*Dh per visible (query row, cmp block) pair, at the
    rate of the kernel's dots (row 0 of ``inp``)."""
    nsa = cfg.nsa
    es = inp["k_cmp"].element_size()
    B, T, Hq, Dh = inp["q"].shape
    Hkv = inp["k_cmp"].shape[2]
    pos = inp["positions"][0].long()
    nvis = _visible_cmp(pos, int(inp["ncb_valid"].reshape(-1)[0]), nsa)
    NSB = -(-inp["k_cache"].shape[1] // nsa.sel_block)
    nbytes = int(nvis.max()) * Hkv * Dh * 2 * es + inp["q"].numel() * 4 * 2 \
        + T * Hkv * NSB * 4 + T * 4
    return bound(nbytes, int(nvis.sum()) * Hq * 4 * Dh, dot_rate(inp["k_cmp"].dtype))


def flash_bound(inp):
    """Bytes: the visible prefix keys and the draft K/V of each kv head
    once, q, out, positions, the (T*Gq, T) mask; flops: 4*Dh per visible
    (query row, key) pair (row 0 of ``inp``)."""
    es = inp["k_cache"].element_size()
    B, T, Hq, Dh = inp["q"].shape
    Hkv = inp["k_cache"].shape[2]
    prefix = int(inp["prefix_len"][0])
    pos = inp["positions"][0].long()
    prefix_keys = (torch.clamp(pos + 1, max=prefix)).clamp_min(0)      # per query
    dist = pos[:, None] - pos[None]
    draft_keys = (inp["tree_mask"][0] & (dist >= 0)).sum(-1)
    nbytes = (min(prefix, int(pos.max()) + 1) + T) * Hkv * Dh * 2 * es \
        + inp["q"].numel() * 4 * 2 + T * 4 + T * (Hq // Hkv) * T * 4 + 4
    return bound(nbytes, int((prefix_keys + draft_keys).sum()) * Hq * 4 * Dh,
                 dot_rate(inp["k_cache"].dtype))
