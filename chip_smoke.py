#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (every phase always runs; any failure exits non-zero):
  1. build the three CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
     per source, in parallel) and print each template instance's registers,
     spill bytes, stack and dynamic shared memory (fails on a spill; head
     dims 64 to 256, f32 and bf16 K/V); print the card's name and power
     limit;
  2. hold each kernel against its plain PyTorch version, in float32 and
     bfloat16 K/V, at the full-width shapes: routing (one row, and two
     rows of prefixes 4096 and 3001 with per-row ncb_valid; Top-n indices
     equal the plain version's; bitwise equal across calls and at B=1 and
     B=2) and nsa_verify (exact
     C=2 / approx C=4, full / partial fusion, and the vanilla single-branch
     launches) at ``ssv-nsa-1b`` (head dim 64) and ``ssv-nsa-8b`` (head dim
     128); the paged nsa_verify mode (the same cases on two rows of
     different lengths re-homed into a shuffled page pool with holes inside
     and outside the window, page size 1 and 2 x sel_block); flash
     tree-verify at the 1B draft, the 8B draft and the dense 1B target; the
     vanilla NSA layer (the Fig. 6(a) baseline: routing kernel, two
     single-branch launches, gated combine) as a counted path at full
     width, against the plain NSA layer (float32);
  3. serve full-width ``ssv-nsa-1b`` and then full-width ``ssv-nsa-8b``,
     each at 4 layers (one 4097-token prompt each), bf16, random
     weights from a seed, max_context 8192, 16 new tokens, D4/k2 tree,
     under Strict and Approx+Reuse, through ``SSVEngine``, with the launch
     counters checked against layers x verify passes (flash: 2 draft
     layers x 5 passes per step) and a per-step profile (kernel launches
     per step printed beside the pre-redesign tree's);
  4. batched and continuous serving: full-width ``ssv-nsa-1b`` (bf16) to 4
     slots through ``generate_batch`` (4 requests) and ``serve_continuous``
     (6 requests, Poisson arrivals), Strict and Approx+Reuse, on the dense
     and on the paged store (paged tokens must equal dense tokens), launch
     counters checked (``nsa_verify_paged`` on paged runs), a profile at 1,
     2 and 4 slots on each store (one device-to-host copy per step); then
     bucketed serving of ``ssv-nsa-1b`` to 4 slots (6 requests of 1025 and
     4097 tokens, Poisson arrivals, a hand-built two-bucket profile:
     D6/k10/budget 128 (T = 129) below 2048 tokens, D4/k2 above, Strict)
     with ``warmup`` capturing one CUDA graph per (strategy, group size)
     (2 x 3), on the dense and the paged store: no capture during the
     serve, launch counters exact under replay, paged tokens == dense
     tokens; and a profile of one group step at g = 1 and 4, eager against
     graph replay (wall, device busy, idle share, launches, host copies);
     then full-width ``ssv-nsa-8b`` on the paged store at 2 slots;
  5. float32 equalities on full-width ``ssv-nsa-1b`` at 8 layers: Strict SSV equals
     autoregressive decoding; batched ``generate_batch`` (3 rows) equals
     per-request ``SSVEngine.generate``; the paged single stream equals the
     dense one; bucketed ``serve_continuous`` with captured group steps (3
     rows of the two lengths) equals each row's ``SSVEngine.generate``
     under its bucket's strategy, and graph replay equals the eager
     ``step_group`` bitwise; and Strict == AR on ``ssv-nsa-8b`` cut to 4
     layers;
  6. the dense-verification baseline: the ``attention="dense"`` replacement
     of ``ssv-nsa-1b`` as the target, every verify through flash;
  7. the serve CLI (``python -m repro_torch.launch.serve``) for both archs,
     and batched-paged, continuous and bucketed (``--continuous --bucketed
     --profile-json --warmup``, a profile this script writes) runs of
     ``ssv-nsa-1b``, the five processes at once on the card;
  8. kernel times (profiler device time and CUDA events) beside the
     pre-redesign kernels' (before the Hopper redesign, commit 787ff43;
     routing's code was the same until commit f780c1a), the plain
     version's time, the bound (bf16 K/V at the bf16 tensor-core rate, so
     their bytes bound them; float32 K/V at the float32 CUDA-core rate)
     and, for flash, the
     library yardstick (``scaled_dot_product_attention``, timed only); the
     float32 K/V instances; vanilla layer against the fused layer;
  9. training (``repro_torch.runtime.trainer.Trainer``): full-width
     ``ssv-nsa-1b`` (bf16, remat) and then its full-width draft train 3
     steps each on 1 x 4096-token ``SyntheticCorpus`` batches (finite
     losses and grad norms, every matrix moved; step ms, tokens/s, peak
     GiB and the share of 989 TFLOP/s that the model FLOPs reach:
     ``analysis.roofline.model_flops``, the JAX formula, printed beside the
     needed-FLOPs formula, 6 x non-embedding params x tokens plus 3 x the
     attention forward FLOPs the function needs, causal and sparse); the draft's train state round-trips bitwise
     through an ``AsyncCheckpointer`` checkpoint; one reduced float32
     train step on the card equals the CPU's (loss rtol 2e-4 / atol 2e-5,
     every gradient leaf rtol 1e-3 / atol 1e-6); a restart after an
     injected failure lands on the uninterrupted trajectory bitwise (under
     ``torch.use_deterministic_algorithms``); a head-dim-64 target + draft
     pair trained on the card until it accepts draft tokens, the three
     kernels held against their plain versions at the pair's shapes
     (prefix 1024, cache 2048, the target's 4 heads and the draft's 2),
     then the pair served through them (f32: Strict == AR, and each
     model's committed K/V rows, compressed blocks and next logits equal
     a one-token-at-a-time ``decode_step``'s; bf16: Strict and
     Approx+Reuse SSV with exact launch counts, and AR; mean accepted > 0);
     the train CLI twice (train, then resume; beside the reduced checks and
     the pair's rounds, processes of their own);
 10. the model zoo: qwen3-8b, granite-20b, musicgen-medium,
     mixtral-8x22b and qwen3-moe-235b-a22b, each as its NSA variant
     (``configs.nsa_variant``) with its ``draft_config`` draft, at full
     width (cut to 2 layers each), bf16, random weights from
     a seed, one at a time: a 4097-token prompt, max_context 8192, D4/k2,
     8 steps (16 until phase 13(c) joined), Strict and Approx+Reuse
     through ``SSVEngine`` with exact launch counts, a 3-step profile (one
     device-to-host copy per step), tok/s and peak memory;
     ``generate_batch`` at 2 slots on the
     dense and the paged store for qwen3-8b and qwen3-moe (paged ==
     dense); qwen3-moe served bucketed at 4 slots (D6/k10/budget 128, T =
     129, and D4/k2) with every group step a captured CUDA graph, launch
     counts exact under replay, paged == dense; one MoE FFN over an odd
     4097 tokens (its experts one by one, as a prefill runs them);
     float32: Strict == AR on qwen3-8b, granite-20b and musicgen-medium
     at the served depth, and for
     both MoE archs (experts, top-k, dispatch group and heads kept, width
     cut) card tokens and accepted counts == the CPU plain path's and
     batched == single stream; the serve CLI with ``--arch qwen3-8b``.
     Then the last five archs the same way: smollm-360m (Gq 3, a
     head-dim-80 draft) and pixtral-12b (Dh 160) cut to 2 layers,
     recurrentgemma-9b (RG-LRU + NSA, Dh 256, Gq 16) to 6 (two periods),
     xlstm-125m (mLSTM / sLSTM, a head-dim-96 draft) to 2 of its 12,
     nemotron-4-340b (Dh 192, Gq 12) at 2 of its 96 layers (~33 GB of
     bf16), each prefill timed (xLSTM's target prefill
     also with its sLSTM chunks replayed and stepped eagerly); recurrentgemma and xlstm also at 2 slots dense
     and paged (paged == dense), xlstm bucketed at 4 slots (the recurrent
     state replay inside captured group steps); float32: Strict == AR on
     smollm and pixtral (2 layers), and card == CPU and
     batched == single stream on nemotron (Dh 192, Gq 12 kept), one
     (rglru, rglru, attn) period of recurrentgemma (Dh 256, Gq 16 kept)
     and one (mlstm, slstm) period of xlstm (full width, vocab 4096); the
     serve CLI with ``--arch recurrentgemma-9b``. Phase 2 holds the
     kernels at the zoo's shapes too (Gq 16, 48, 6, 1, 3; Dh 160 Gq 4, Dh
     192 Gq 12, Dh 256 Gq 16; flash at Gq 48, windowed at mixtral's, and
     at the drafts' Dh 80, 96, 160, 192, 256), and phase 8 times them;
 11. the dry run's long-context cells (``repro_torch.launch.dryrun``'s
     ``run_cell`` with ``run=True``, as ``--run`` calls it): ssv-nsa-1b at
     32,768 and 524,288 tokens and ssv-nsa-8b at 32,768, batch 1, full
     width, bf16, both caches full to the cell's length with seeded random
     K/V rows (compressed blocks ``compress_kv`` of them): a Strict and an
     Approx+Reuse verify of a D4/k2 tree, the draft's tree expansion and
     ``decode_step``, each with exact launch counts, wall and busy time,
     peak memory and the ``Roofline`` row; Strict's root logits == the
     decode's (rtol = atol = 3e-2) on the cell built again in float32 (in
     bf16 the two passes round apart: printed); layer 0's routing, nsa_verify
     (exact C=2, full and partial fusion) and the draft's flash against
     their plain versions at the cell's inputs (phase 2's tolerances; the
     plain flash one kv head at a time), timed beside plain, bound and, for
     flash, SDPA;
 12. the sequence-sharded decode across ranks (``launch.dryrun.run_sharded``:
     ``models.nsa_sharded.decode_step_sharded`` in spawned ranks, each
     filling only its slice of the cache as phase 11 fills the whole):
     (a) one rank over NCCL, ssv-nsa-1b x decode_32k in float32; (b) four
     ranks sharing the card over gloo with CUDA tensors, the same cell and
     ssv-nsa-1b x long_500k, both in float32; each held against phase 11's
     ``decode_step`` on the same fill (logits and every layer's written K/V
     row within rtol 2e-4 / atol 2e-5, the same argmax), every rank's
     logits equal; wall and busy per token,
     collectives per token and per-rank peak memory printed;
 13. training across ranks (``make_train_step(cfg, tcfg, mesh)``, checked in
     spawned ranks by ``launch.train_checks``): (a) four gloo ranks share
     the card with CUDA tensors on a (data 2, model 2) mesh, full-width
     ssv-nsa-1b cut to 2 layers in float32, 4 x 2049 tokens, each row's
     2,049 positions split over the model ranks (1,025 and 1,024; the
     positions and the activation collectives printed, and the phase fails
     unless the ranks split them): the sharded
     step equals ``make_train_step`` on one device on the card (loss rtol
     1e-5; every block of params, both moments and the residual rtol 2e-4 /
     atol 2e-5; an int8 rounding flip held one step off, its count to
     ``train_checks.flips_bound`` of the count expected; an ill-conditioned
     AdamW param to its own gradient's update), plain and with
     int8 error-feedback compression over 2 micro-batches; the flips
     between two single-device int8 steps that differ only in their
     reduction order (2 and 4 micro-batches) printed beside them; the
     plain step's checkpoint, saved from that world, restores onto a
     (2, 1) world and onto one device bitwise; (b) beside the restores,
     one NCCL rank on a (1, 1) mesh, full-width, full-depth ssv-nsa-1b in
     bf16, 1 x 4096 tokens: one step equals the single-device step on the
     same card (loss and every leaf within 3e-2, the largest differences
     printed), one more step timed once the restores are done, alone on
     the card, its ms and the peak printed beside phase 9's; collectives,
     resident bytes, wall and peak per rank printed; (c) two gloo ranks
     share the card on a (data 1, model 2) mesh, 1 x 1,025 tokens (513 and
     512 positions a rank), float32, one period of each recurrent arch at
     full width, xlstm-125m (mlstm, slstm) and recurrentgemma-9b (rglru,
     rglru, attn; vocabulary cut to 32,768): each recurrent layer runs on
     its rank's positions with its state carried along the model ranks
     and back in the backward pass (``models.train_sharded``); the split
     step equals the single-device step on the card at the CPU tests'
     tolerances (loss rtol 1e-5; blocks rtol 2e-4 / atol 2e-5), the
     recurrent activation collectives equal
     ``train_sharded.carry_collectives`` on both ranks; the positions,
     the activation collectives and bytes by layer kind and the sLSTM
     relay's idle share printed;
 14. the dry run's serve cells across ranks (``models.prefill_sharded`` and
     the batched ``decode_step_sharded`` on weights under ``param_specs``,
     checked in spawned ranks by ``launch.serve_checks``): (a) four gloo
     ranks share the card with CUDA tensors on a (data 2, model 2) mesh,
     full-width ssv-nsa-1b cut to 2 layers in float32, 2 x 4096-token
     prompts, ``max_len`` 8208: the sharded prefill equals
     ``model.prefill`` on the card (the last position's logits, a vocab
     slice per model rank; every rank's K/V rows and compressed blocks),
     then 16 decode tokens equal 16 ``decode_step``s through the kernels
     (each token's logits, the caches after the last; block 255 completes
     at position 4111 with rows on both sides of the model boundary at
     4104, and its owner writes it), rtol 2e-4 / atol 2e-5, argmax equal;
     (b) beside (a), one NCCL rank on (1, 1), the whole ssv-nsa-1b in
     bf16: ``prefill_32k`` at batch 1 equals the single-device prefill on
     the same card within 3e-2 (logits, every K/V row and compressed
     block), and 2 decode tokens equal the single device's
     ``decode_step`` with its NSA layers on the plain ``nsa_verify_ref``
     within 3e-2 (logits and caches) and give its argmax through the
     kernels (the differences from the kernels' route are printed, each
     layer's too; (a) holds that decode in float32); (c), (d) and (e) in
     (a)'s world of four gloo ranks on (2, 2), after it and after (b) (the ranks
     draw the whole params one at a time): (c) full-width
     pixtral-12b cut to 1 layer in float32, 2 rows
     of 256 seeded frontend frames + 4,096 tokens, ``max_len`` 4,864: the
     prefill (frames in front of the tokens, the dense attention's K/V
     all-gathered) and 4 decode tokens (the split-KV dense decode) equal
     ``model.prefill`` + 4 ``decode_step``s through the flash kernel on
     the card, rtol 2e-4 / atol 2e-5, argmax equal; (d) full-width
     mixtral-8x22b cut to 1 layer in bf16, 4 x 6,144
     tokens (1,024-token MoE groups divide each rank's 3,072), ``max_len``
     8,208, so every decode token's 4,096-key window straddles the model
     boundary at row 4,104: the prefill within 3e-2 of the single
     device's, 4 decode tokens (the expert ids all-gathered over the data
     ranks, the capacity counted over the whole batch) within 3e-2 of its
     ``decode_step`` on the flash kernel's plain version and with the
     argmax of its kernel route (or a token tied with it within 3e-2,
     each such margin printed); the assignments the whole batch's group
     dropped printed beside those per-rank groups would have dropped; (e)
     the recurrent archs in float32, 2 x 4,096 tokens, 4 decode tokens,
     their states passed along the model ranks across the prompt's cut at
     2,048 (``models.recurrent_sharded``): full-width recurrentgemma-9b at 3
     layers (one whole rglru, rglru, attn period; ``max_len`` 6,160, so
     every decode token's 2,048-key window straddles the cache's model
     boundary at row 3,080) and full-width xlstm-125m at 2 (mlstm, slstm):
     the prefill and the decode equal ``model.prefill`` + 4
     ``decode_step``s on the card (logits, every rank's states and K/V
     slices), rtol 2e-4 / atol 2e-5, argmax equal, collectives exact;
     walls, collectives, gathered bytes and the peak per rank printed;
 15. the summary lines: each phase's seconds, a ``kernels`` JSON line
     (every kernel x head dim, and x query-head group for the zoo's, and x
     cell for phase 11's), the card line, and the ``{"ok": true, "device":
     ...}`` line last.

Phases 3-4 serve ssv-nsa-1b and ssv-nsa-8b at 2 of their 16 and 32
layers and phase 5 runs the float32 ssv-nsa-1b at 4 of its 16 layers
(``SERVE_LAYERS``, ``F32_1B_LAYERS``: depth cut to make room for phase 14
within the script's time; a cut config is named ``<arch>-x<layers>``).
Phase 7's serve CLI and phase 11's cells serve both at full depth.

``--times-only`` stops after phases 1 and 8 (no ok line), ``--serve-only``
after phases 1 and 3 (no ok line; the served tokens go to
``chip_smoke_serve.json``), ``--cells-only`` after phases 1 and 11-14
(no ok line; ``chip_smoke_cells.json``); with ``--src`` either times or serves
another checkout's package by the same method (the parent's, in the same
call, for a comparison on one card; one that has
``repro_torch.analysis``, since the bounds come from there).

Each counted path sets every launch counter to 0 just before it runs and
reads them just after; a kernel row's ``launches`` sums the paths at its
head dim. The card's rates and every bound come from
``repro_torch.analysis.roofline``. Imports nothing of JAX and nothing of
the JAX package. TF32 is
disabled for float32 matmuls and convolutions so the float32 references
are full float32.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# cuBLAS reads this when it first makes a handle; phase 9's restart check
# runs under torch.use_deterministic_algorithms, which requires it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
# The pre-redesign kernels: before the Hopper redesign (commit 787ff43;
# routing's code stayed the same until f780c1a). Their times (profiler
# device ms per launch, bf16 K/V, this script's phase 8 on NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md), printed beside this run's
PRE_REDESIGN_MS = {"nsa_verify exact C=2 full dh64": 0.1155, "nsa_verify approx C=4 full dh64": 0.1433,
           "nsa_verify exact C=2 partial dh64": 0.1039,
           "nsa_verify approx C=4 partial dh64": 0.1238,
           "nsa_verify vanilla slc dh64": 0.0426, "nsa_verify vanilla win dh64": 0.0219,
           "nsa_verify paged exact C=2 partial dh64": 0.1094,
           "nsa_verify paged exact C=2 full dh64": 0.1209,
           "nsa_verify exact C=2 full dh128": 0.1981, "nsa_verify approx C=4 full dh128": 0.2446,
           "nsa_verify exact C=2 partial dh128": 0.1777,
           "nsa_verify approx C=4 partial dh128": 0.2112,
           "nsa_verify vanilla slc dh128": 0.0745, "nsa_verify vanilla win dh128": 0.0875,
           "nsa_verify paged exact C=2 partial dh128": 0.1850,
           "nsa_verify paged exact C=2 full dh128": 0.2043,
           "routing dh64": 0.0315, "routing dh128": 0.0476,
           "flash 1B draft dh64": 0.1402, "flash 8B draft dh128": 0.2510,
           "flash 1B dense target dh64": 0.1984}
# The pre-redesign tree's kernel launches per decode step (copies excluded) in
# the phase-3/4/6 profiles, measured by this script's method at the same
# configurations (NVIDIA H100 80GB HBM3). Printed beside this run's; the
# profiler's count moves by a few launches between runs of one tree at
# batched configurations, so the exact check of launches is the counted
# paths' (every kernel of the port per layer and pass).
PRE_REDESIGN_KERNELS_PER_STEP = {
    "ssv-nsa-1b Strict": 4567, "ssv-nsa-1b Approx+Reuse": 4174,
    "ssv-nsa-8b Strict": 8238, "ssv-nsa-8b Approx+Reuse": 7454,
    "ssv-nsa-1b dense-verification target": 2299,
    "ssv-nsa-1b dense x1": 4568, "ssv-nsa-1b dense x2": 4585, "ssv-nsa-1b dense x4": 4552,
    "ssv-nsa-1b paged x1": 5639, "ssv-nsa-1b paged x2": 5656, "ssv-nsa-1b paged x4": 5624,
    "ssv-nsa-8b paged x1": 10234, "ssv-nsa-8b paged x2": 10276}
# (rtol, atol). Both sides compute in float32 from the same values, so bf16
# K/V are held to the float32 tolerance too.
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (2e-4, 2e-5)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_CASES = [("1B draft", 8, 8, 64), ("8B draft", 8, 8, 128), ("1B dense target", 32, 8, 64)]


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi: {e}")


def free():
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- inputs
def tree_inputs(prefix):
    """D4/k2 tree; ``prefix`` an int or a tuple of per-row prefix lengths."""
    from repro_torch.core.tree import build_topology
    topo = build_topology(4, 2, "bfs")
    pre = torch.as_tensor(prefix, device=DEV).reshape(-1, 1)
    positions = (torch.as_tensor(topo.depths, device=DEV)[None] + pre).to(torch.int32)
    mask = torch.as_tensor(topo.mask, device=DEV)[None].expand(pre.shape[0], -1, -1)
    return topo, positions, mask


def verify_inputs(cfg, kv_dtype, seed, prefix=4096, S=8192):
    """Full-width verify-kernel inputs: D4/k2 tree (T=31), cache S, real
    routing + Top-n selection on random compressed scores; ``prefix`` an
    int (one row) or a tuple (one row per prefix length)."""
    from repro_torch.models import nsa as nsa_lib

    nsa = cfg.nsa
    g = torch.Generator(DEV)
    g.manual_seed(seed)
    topo, positions, tree_mask = tree_inputs(prefix)
    B, T = positions.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    plen = torch.as_tensor(prefix, dtype=torch.int32, device=DEV).reshape(-1)

    def r(*shape, dtype=kv_dtype):
        return torch.randn(shape, generator=g, device=DEV).to(dtype)

    NCB = nsa_lib.init_cmp_cache(cfg, 1, S, kv_dtype, DEV)["k_cmp"].shape[1]
    p_slc = torch.rand((B, T, Hkv, nsa_lib.num_sel_blocks(S, nsa)), generator=g, device=DEV)
    sel_idx, sel_valid = nsa_lib.select_topn(p_slc, positions, plen, nsa)
    return dict(
        q=r(B, T, Hq, Dh, dtype=torch.float32) / Dh ** 0.5,
        k_cache=r(B, S, Hkv, Dh), v_cache=r(B, S, Hkv, Dh),
        k_cmp=r(B, NCB, Hkv, Dh), v_cmp=r(B, NCB, Hkv, Dh),
        k_draft=r(B, T, Hkv, Dh), v_draft=r(B, T, Hkv, Dh),
        sel_idx=sel_idx, sel_valid=sel_valid, positions=positions,
        prefix_len=plen, ncb_valid=nsa_lib.dyn_num_cmp_blocks(plen, nsa),
        tree_mask=tree_mask,
        gates=torch.sigmoid(r(B, T, 3, Hq, dtype=torch.float32)),
        o_cmp_in=r(B, T, Hq, Dh, dtype=torch.float32))


def paged_pool(cfg, inp, page_mult, holes, seed):
    """Re-home ``inp``'s dense K/V into a shuffled page pool (page size
    ``page_mult`` x sel_block, 3 spare pages of random bytes). ``holes``:
    unmap one page inside row 0's window and one page of the last row
    outside its window (in its prefix). Returns (pool_k, pool_v, page
    table (B, max_pages) int32)."""
    g = torch.Generator()
    g.manual_seed(seed)
    kc, vc = inp["k_cache"], inp["v_cache"]
    B, S, Hkv, Dh = kc.shape
    ps = cfg.nsa.sel_block * page_mult
    mp = S // ps
    P = B * mp + 3
    pages = torch.randperm(P, generator=g)[: B * mp].reshape(B, mp).to(torch.int32).to(DEV)
    pool_k = torch.randn((P, ps, Hkv, Dh), generator=g).to(kc.dtype).to(DEV)
    pool_v = torch.randn((P, ps, Hkv, Dh), generator=g).to(kc.dtype).to(DEV)
    for b in range(B):
        pool_k[pages[b].long()] = kc[b].reshape(mp, ps, Hkv, Dh)
        pool_v[pages[b].long()] = vc[b].reshape(mp, ps, Hkv, Dh)
    if holes:
        plen = inp["prefix_len"].tolist()
        pages[0, (plen[0] - 100) // ps] = -1              # inside the 512-token window
        pages[-1, (plen[-1] // 2) // ps] = -1              # in the prefix, outside it
    return pool_k, pool_v, pages


# (label, C, mode, include_cmp, branch): the fused cases, then the vanilla
# single-branch launches (C=1)
VERIFY_CASES = [("exact C=2 full", 2, "exact", True, "all"),
                ("exact C=2 partial", 2, "exact", False, "all"),
                ("approx C=4 full", 4, "approx", True, "all"),
                ("approx C=4 partial", 4, "approx", False, "all"),
                ("vanilla slc", 1, "exact", False, "slc"),
                ("vanilla win", 1, "exact", False, "win")]


def case_kernel(include_cmp, branch):
    if branch != "all":
        return "nsa_verify_vanilla"
    return "nsa_verify_full" if include_cmp else "nsa_verify_partial"


def verify_layouts(cfg, inp, C, mode, pool=None):
    """The kernel-boundary arguments of ``nsa_verify_fused``; ``pool`` =
    (pool_k, pool_v, page table) gives the paged ones (merged blocks on
    unmapped pages masked, as ``nsa_verify_fused`` masks them)."""
    from repro_torch.kernels import per_row
    from repro_torch.kernels.nsa_verify import ops as vops
    nsa = cfg.nsa
    S = inp["k_cache"].shape[1]
    merged, mvalid, own, qmap = vops.group_layouts(
        inp["sel_idx"], inp["sel_valid"], inp["positions"], C, mode)
    extra = {}
    if pool is not None:
        pool_k, pool_v, pages = pool
        merged, mvalid = vops.mask_unmapped_blocks(merged, mvalid, pages, pool_k.shape[1],
                                                   pool_k.shape[0], nsa.sel_block)
        extra = dict(k_cache=pool_k, v_cache=pool_v, page_table=pages)
    W = min(nsa.window, S)
    plen = inp["prefix_len"]
    pos = inp["positions"]
    dist = pos[:, :, None] - pos[:, None, :]
    dmask = inp["tree_mask"] & (dist < nsa.window) & (dist >= 0)
    args = dict(q=inp["q"], k_cache=inp["k_cache"], v_cache=inp["v_cache"],
                k_cmp=inp["k_cmp"], v_cmp=inp["v_cmp"], k_draft=inp["k_draft"],
                v_draft=inp["v_draft"], merged=merged.contiguous(),
                mvalid=mvalid.contiguous(), own=own.contiguous(), qmap=qmap,
                positions=pos, prefix_len=plen,
                ncb_valid=per_row(inp["ncb_valid"], pos.shape[0], DEV),
                win_start=(plen - W).clamp(0, S - W).to(torch.int32),
                dmask=dmask.to(torch.int32), gates=inp["gates"])
    args.update(extra)
    return args


def run_verify(cfg, args, include_cmp, o_cmp_in, plain: bool, branch="all"):
    from repro_torch.kernels.nsa_verify import ops as vops, ref as vref
    nsa = cfg.nsa
    if plain:
        return vref.verify_groups_plain(
            **args, o_cmp_in=o_cmp_in, sel_block=nsa.sel_block,
            cmp_block=nsa.cmp_block, cmp_stride=nsa.cmp_stride,
            window=nsa.window, include_cmp=include_cmp, branch=branch)
    return vops.verify_groups(**args, o_cmp_in=o_cmp_in, nsa=nsa,
                              include_cmp=include_cmp, branch=branch)


def run_routing(cfg, inp, plain: bool):
    from repro_torch.kernels.routing import ops as rops, ref as rref
    from repro_torch.models import nsa as nsa_lib
    nsa = cfg.nsa
    S = inp["k_cache"].shape[1]
    NSB = nsa_lib.num_sel_blocks(S, nsa)
    if plain:
        M = nsa_lib.overlap_tensor(inp["k_cmp"].shape[1], NSB, nsa, DEV)
        return rref.ref_routing(inp["q"], inp["k_cmp"], inp["v_cmp"], M,
                                inp["positions"], inp["ncb_valid"],
                                cmp_block=nsa.cmp_block, cmp_stride=nsa.cmp_stride)
    return rops.routing_fused(inp["q"], inp["k_cmp"], inp["v_cmp"], inp["positions"],
                              inp["ncb_valid"], nsa, kv_len=S)


def check_routing(cfg, inp, dt_name, note, tag=""):
    """The routing kernel against its plain version on ``inp`` (one row or
    more): both outputs within TOL, the same Top-n indices, bitwise equal
    across two calls and, with more than one row, each row bitwise equal to
    its own B=1 launch."""
    from repro_torch.models import nsa as nsa_lib
    B, Dh = inp["q"].shape[0], inp["q"].shape[-1]

    def rows(b):
        return {**inp, **{k: inp[k][b:b + 1] for k in
                          ("q", "k_cmp", "v_cmp", "positions", "ncb_valid", "prefix_len")}}

    o_k, p_k = run_routing(cfg, inp, plain=False)
    again = run_routing(cfg, inp, plain=False)
    single = [run_routing(cfg, rows(b), plain=False) for b in range(B)] if B > 1 else []
    o_r, p_r = run_routing(cfg, inp, plain=True)
    torch.cuda.synchronize()
    label = f"{tag}routing B={B} Dh {Dh}"
    note(check_close(f"{label} o_cmp", o_k, o_r, dt_name))
    note(check_close(f"{label} p_slc", p_k, p_r, dt_name))
    topn = [nsa_lib.select_topn(p, inp["positions"], inp["prefix_len"], cfg.nsa)
            for p in (p_k, p_r)]
    if not all(torch.equal(a, b) for a, b in zip(*topn)):
        fail(f"{label} [{dt_name}]: Top-n indices differ from the plain version's")
    if not (torch.equal(o_k, again[0]) and torch.equal(p_k, again[1])):
        fail(f"{label} [{dt_name}]: two calls differ")
    for b, (o1, p1) in enumerate(single):
        if not (torch.equal(o_k[b:b + 1], o1) and torch.equal(p_k[b:b + 1], p1)):
            fail(f"{label} [{dt_name}]: row {b} differs from its B=1 launch")
    log(f"  {label} [{dt_name}]: Top-n indices equal the plain version's; bitwise equal "
        f"across two calls{' and to each row alone (B=1)' if single else ''}")


def check_verify_cases(cfg, inp, dt_name, note, tag="", cases=VERIFY_CASES):
    """nsa_verify's ``cases`` on ``inp`` against the plain version."""
    Dh = cfg.head_dim
    for label, C, mode, full, branch in cases:
        args = verify_layouts(cfg, inp, C, mode)
        oc = inp["o_cmp_in"] if (not full and branch == "all") else None
        got = run_verify(cfg, args, full, oc, plain=False, branch=branch)
        want = run_verify(cfg, args, full, oc, plain=True, branch=branch)
        torch.cuda.synchronize()
        note(f"{case_kernel(full, branch)}_dh{Dh}",
             check_close(f"{tag}nsa_verify {label} Dh {Dh}", got, want, dt_name))


def check_flash(label, Hq, Hkv, Dh, dt_name, note, seed, window=0, **shape):
    """flash_verify against its plain version at (Hq, Hkv, Dh)."""
    inp = dict(flash_inputs(Hq, Hkv, Dh, DTYPES[dt_name], seed, **shape), window=window)
    got = run_flash(inp, plain=False)
    want = run_flash(inp, plain=True)
    torch.cuda.synchronize()
    note(f"flash_verify_dh{Dh}", check_close(
        f"flash {label} (R={inp['q'].shape[1] * Hq // Hkv}, Dh {Dh})", got, want, dt_name))


def flash_inputs(Hq, Hkv, Dh, kv_dtype, seed, prefix=4096, S=8192):
    """Flash-kernel inputs at a consumer's shape: D4/k2 tree, cache S."""
    g = torch.Generator(DEV)
    g.manual_seed(seed)
    topo, positions, tree_mask = tree_inputs(prefix)
    T = topo.num_nodes

    def r(*shape, dtype=kv_dtype):
        return torch.randn(shape, generator=g, device=DEV).to(dtype)

    return dict(q=r(1, T, Hq, Dh, dtype=torch.float32) / Dh ** 0.5,
                k_cache=r(1, S, Hkv, Dh), v_cache=r(1, S, Hkv, Dh),
                k_draft=r(1, T, Hkv, Dh), v_draft=r(1, T, Hkv, Dh),
                positions=positions, prefix_len=torch.tensor([prefix], dtype=torch.int32, device=DEV),
                tree_mask=tree_mask)


def run_flash(inp, plain: bool):
    from repro_torch.kernels.flash import ops as fops, ref as fref
    return (fref.ref_flash_verify if plain else fops.flash_verify)(**inp)


def sdpa_call(inp):
    """The library yardstick for flash: one ``scaled_dot_product_attention``
    on the concatenated [cache | draft] K/V (GQA heads expanded, q in the
    K/V dtype) with the boolean [prefix | draft] mask. Timed only."""
    import torch.nn.functional as F
    q, kc = inp["q"], inp["k_cache"]
    Gq = q.shape[2] // kc.shape[2]
    S = kc.shape[1]
    pos = inp["positions"][0].long()
    kpos = torch.arange(S, device=DEV)
    pmask = (kpos[None] < inp["prefix_len"][0]) & (kpos[None] <= pos[:, None])
    dist = pos[:, None] - pos[None]
    mask = torch.cat([pmask, inp["tree_mask"][0] & (dist >= 0)], dim=-1)[None, None]
    qq = q.to(kc.dtype).permute(0, 2, 1, 3).contiguous()
    k = torch.cat([kc, inp["k_draft"]], 1).repeat_interleave(Gq, dim=2).permute(0, 2, 1, 3).contiguous()
    v = torch.cat([inp["v_cache"], inp["v_draft"]], 1).repeat_interleave(Gq, dim=2) \
        .permute(0, 2, 1, 3).contiguous()
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask, scale=1.0)


def layer_inputs(cfg, dtype_name, seed, prefix=4096, S=8192):
    """One full-width NSA layer (random weights from a seed) with random
    K/V and compressed caches of capacity S, prefix ``prefix``, D4/k2 tree."""
    from repro_torch.bridge import init_params
    from repro_torch.models import attention as attn_lib, nsa as nsa_lib
    lcfg = dataclasses.replace(cfg, num_layers=1, vocab_size=256, dtype=dtype_name)
    g = torch.Generator(DEV)
    g.manual_seed(seed)
    mix = init_params(lcfg, g, DEV)["layers"][0]["mix"]
    dt = mix["wq"].dtype
    kv = attn_lib.init_cache(lcfg, 1, S, dt, DEV)
    cmp = nsa_lib.init_cmp_cache(lcfg, 1, S, dt, DEV)
    for c in (kv, cmp):
        for t in c.values():
            t.normal_(generator=g)
    topo, positions, tree_mask = tree_inputs(prefix)
    x = torch.randn((1, topo.num_nodes, cfg.d_model), generator=g, device=DEV).to(dt)
    return lcfg, mix, x, kv, cmp, torch.tensor(prefix, dtype=torch.int32, device=DEV), \
        positions, tree_mask


def check_close(name, got, want, dtype_name, against="its plain version"):
    rtol, atol = TOL[dtype_name]
    err = (got - want).abs()
    max_err = float(err.max())
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(torch.isfinite(got).all())
    log(f"  {name} [{dtype_name}]: max_abs_err={max_err:.3e} "
        f"(rtol={rtol}, atol={atol}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} [{dtype_name}] disagrees with {against}")
    return max_err


# ---------------------------------------------------------------- timing
def time_events(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernel(fn, kernel_name: str, iters: int = 50, per_call: int = 1):
    """Time per launch: the kernel's device time from the profiler (CUDA
    events when the profiler shows none), and CUDA events around ``iters``
    back-to-back calls of ``fn`` (each making ``per_call`` launches), which
    include the host's enqueue whenever that is slower than the kernel.
    Returns (ms, source, events_ms) per launch."""
    from torch.profiler import ProfilerActivity, profile
    events_ms = time_events(fn, iters) / per_call
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total_us += getattr(ev, "self_device_time_total", 0.0) or \
                getattr(ev, "self_cuda_time_total", 0.0)
    if total_us > 0:
        return total_us / iters / per_call / 1e3, "profiler", events_ms
    return events_ms, "cuda-events", events_ms


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for chip_smoke.json (all numbers of the run)")
    ap.add_argument("--times-only", action="store_true",
                    help="build and time the kernels (phases 1 and 8, bf16 and float32 "
                         "K/V) and stop; prints no ok line")
    ap.add_argument("--serve-only", action="store_true",
                    help="build and serve the 1B / 8B cells of phase 3 (bf16 single stream, "
                         "Strict and Approx+Reuse, launch counts, profile) and stop; prints "
                         "no ok line")
    ap.add_argument("--cells-only", action="store_true",
                    help="build and run phases 11-14 (the dry run's long-context cells on "
                         "full caches, their kernels against the plain versions, the "
                         "sequence-sharded decode, training and the serve cells across ranks) "
                         "and stop; prints no ok line")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds repro_torch (default: this checkout's); "
                         "with --times-only or --serve-only, another checkout's package is "
                         "timed or served by the same method")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    try:
        from repro_torch import configs
        from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus
        from repro_torch.kernels import build
        from repro_torch.kernels.flash import ops as fops
        from repro_torch.kernels.nsa_verify import ops as vops
        from repro_torch.kernels.routing import ops as rops
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing: {e}", file=sys.stderr)
        return 2
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
        "TF32 off for float32 matmul and cuDNN")

    # ---- 1. build
    t0 = time.time()
    reports = build.build_all()
    t_build = time.time() - t0
    log(f"[1 build] {len(reports)} kernels built in {t_build:.1f}s")
    instances = []
    for name, rep in reports.items():
        for inst in ptxas_instances(name, rep):
            inst["smem_bytes"] = smem_bytes(build, name, inst["kv"], inst["dh"])
            instances.append(inst)
            log(f"  [1 ptxas] {inst['instance']}: {inst.get('registers')} registers, "
                f"{inst['spill_stores']} B spill stores, {inst['spill_loads']} B spill loads, "
                f"{inst['stack']} B stack, shared memory {inst['smem_bytes']} B")
    log(f"[1 card] {card}")
    spills = [i["instance"] for i in instances if i["spill_stores"] or i["spill_loads"]]

    cfgs = {64: configs.get_config("ssv-nsa-1b"), 128: configs.get_config("ssv-nsa-8b")}
    own_src = Path(args.src).resolve() == (ROOT / "src").resolve()
    if args.times_only:       # another checkout's kernels may predate the zoo's head groups
        rows, layer_times = kernel_times(cfgs, {}, {}, kind, card, zoo=own_src)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke_times.json").write_text(json.dumps(
            {"card": card, "kind": kind, "src": args.src, "ptxas": instances, "kernels": rows,
             "layer_times": layer_times}, indent=1))
        print(json.dumps({"kernels": rows}))
        print(card)
        return 0
    if spills:
        fail(f"these kernel instances spill registers: {spills}")
    counters = [rops.LAUNCHES, vops.FULL_LAUNCHES, vops.PARTIAL_LAUNCHES,
                vops.VANILLA_LAUNCHES, vops.PAGED_LAUNCHES, fops.LAUNCHES]
    ctx = dict(counters=counters, kind=kind, card=card,
               corpus=SyntheticCorpus(SyntheticConfig(vocab_size=cfgs[128].vocab_size)),
               launches={}, paths={})
    if args.cells_only:
        cell_err = {}
        t0 = time.time()
        cells, cell_rows = cells_phase(ctx, out_dir / "dryrun", cell_err)
        log(f"[11 cells] {time.time() - t0:.1f}s")
        t0 = time.time()
        sharded = sharded_phase(ctx, out_dir / "sharded")
        log(f"[12 ranks] {time.time() - t0:.1f}s")
        t0 = time.time()
        train_ranks = train_ranks_phase(ctx, out_dir / "train_ranks")
        log(f"[13 train ranks] {time.time() - t0:.1f}s")
        t0 = time.time()
        serve_ranks = serve_ranks_phase(ctx, out_dir / "serve_ranks")
        log(f"[14 serve ranks] {time.time() - t0:.1f}s")
        for row in cell_rows:
            row.update(launches=ctx["launches"].get(row["name"], 0),
                       max_abs_err=cell_err.get(row["name"]))
        (out_dir / "chip_smoke_cells.json").write_text(json.dumps(
            {"card": card, "kind": kind, "cells": cells, "kernels": cell_rows,
             "launches": ctx["launches"], "sharded": sharded, "train_ranks": train_ranks,
             "serve_ranks": serve_ranks}, indent=1, default=str))
        print(card)
        return 0
    if args.serve_only:
        e2e = {}
        for Dh in (64, 128):
            cfg = serve_depth(cfgs[Dh])
            weights = load_weights(cfg, seed=0)
            e2e[cfg.name] = serve_e2e(cfg, Dh, weights, ctx)
            del weights
            free()
        (out_dir / "chip_smoke_serve.json").write_text(json.dumps(
            {"card": card, "kind": kind, "src": args.src, "e2e": e2e}, indent=1))
        print(card)
        return 0

    phase_s = {"1 build": t_build}

    def done(name, t0):
        phase_s[name] = time.time() - t0
        log(f"[{name}] {phase_s[name]:.1f}s (done at {time.time() - t_start:.1f}s)")

    # ---- 2. kernels vs plain versions at full width
    t0 = time.time()
    max_err = check_kernels(cfgs, ctx)
    ctx["note_err"] = lambda key, e: max_err.__setitem__(key, max(max_err.get(key, 0.0), e))
    log("[2 kernels] all cases agree with the plain versions")
    done("2 kernels", t0)

    # ---- 3. single stream, and 4. batched / continuous serving, full width bf16
    e2e, batched = {}, {}
    for Dh in (64, 128):
        t0 = time.time()
        cfg = serve_depth(cfgs[Dh])
        weights = load_weights(cfg, seed=0)
        e2e[cfg.name] = serve_e2e(cfg, Dh, weights, ctx)
        free()
        done(f"3 serve {cfg.name}", t0)
        t0 = time.time()
        batched[cfg.name] = serve_batched(cfg, Dh, weights, ctx,
                                          **(dict() if Dh == 64 else BATCHED_8B))
        if Dh == 64:
            free()
            batched[cfg.name]["bucketed"] = serve_bucketed(cfg, Dh, weights, ctx)
            free()
            batched[cfg.name]["group_step_profile"] = profile_group_steps(cfg, weights, ctx)
        del weights
        free()
        done(f"4 batched {cfg.name}", t0)

    # ---- 5. float32 equalities
    t0 = time.time()
    f32_equalities(cfgs[64], ctx, layers=F32_1B_LAYERS)
    free()
    strict_equals_ar(cfgs[128], 4, 16, ctx)
    free()
    done("5 float32", t0)

    # ---- 6. the dense-verification baseline
    t0 = time.time()
    e2e[cfgs[64].name + "-dense"] = dense_baseline(cfgs[64], ctx)
    free()
    done("6 dense baseline", t0)

    # ---- 7. serve CLI (the five runs at once)
    t0 = time.time()
    cli_profile = out_dir / "bucket_profile.json"
    cli_profile.write_text(cli_bucket_profile().to_json())
    one = (("--prompts", "1"), "prompt 0: 8 tokens")
    serve_clis([(cfg.name, *one) for cfg in cfgs.values()] + [
        (cfgs[64].name, ["--prompts", "2", "--batch", "2", "--kv-backend", "paged"],
         "batch[0:2]: 16 tokens"),
        (cfgs[64].name, ["--prompts", "3", "--batch", "2", "--continuous", "--arrival-rate",
                         "0.5"], "continuous over 2 slots: 24 tokens"),
        (cfgs[64].name, ["--prompts", "3", "--batch", "2", "--continuous", "--bucketed",
                         "--profile-json", str(cli_profile), "--warmup"],
         ("continuous over 2 slots: 24 tokens", "bucketed: ", "/ 4 misses"))])

    idle = [k for k, n in ctx["launches"].items() if n == 0]
    if idle:
        fail(f"the main paths never launched {idle}")
    done("7 serve CLI", t0)

    # ---- 8. kernel times at the slices' shapes (bf16)
    t0 = time.time()
    rows, layer_times = kernel_times(cfgs, ctx["launches"], max_err, kind, card)
    done("8 time", t0)

    # ---- 9. training, and the serve of a pair trained on the card
    t0 = time.time()
    train = train_phase(cfgs[64], ctx, out_dir / "train")
    done("9 train", t0)

    # ---- 10. the model zoo
    t0 = time.time()
    zoo = zoo_phase(ctx)
    serve_clis([("qwen3-8b", *one), ("recurrentgemma-9b", *one)])
    done("10 zoo", t0)

    # ---- 11. the dry run's long-context cells on full caches
    t0 = time.time()
    cells, cell_rows = cells_phase(ctx, out_dir / "dryrun", max_err)
    rows += cell_rows
    idle = [r["name"] for r in rows if ctx["launches"].get(r["name"], 0) == 0]
    if idle:
        fail(f"the main paths never launched {idle}")
    done("11 cells", t0)

    # ---- 12. the sequence-sharded decode across ranks
    t0 = time.time()
    sharded = sharded_phase(ctx, out_dir / "sharded")
    done("12 ranks", t0)

    # ---- 13. training across ranks
    t0 = time.time()
    train_ranks = train_ranks_phase(ctx, out_dir / "train_ranks", train["target"])
    done("13 train ranks", t0)

    # ---- 14. the dry run's serve cells across ranks
    t0 = time.time()
    serve_ranks = serve_ranks_phase(ctx, out_dir / "serve_ranks")
    done("14 serve ranks", t0)
    for row in rows:        # the trained pair's and the zoo's serves launched the kernels too
        row["launches"] = ctx["launches"].get(row["name"], 0)
        row["max_abs_err"] = max_err.get(row["name"])
    phase_s["all"] = time.time() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kind": kind, "e2e": e2e, "batched": batched, "paths": ctx["paths"],
         "ptxas": instances, "kernels": rows, "layer_times": layer_times, "train": train,
         "zoo": zoo, "cells": cells, "sharded": sharded, "train_ranks": train_ranks,
         "serve_ranks": serve_ranks, "phase_seconds": phase_s,
         "seconds": time.time() - t_start}, indent=1, default=str))

    # ---- 15. summary
    log(f"[15 done] {time.time() - t_start:.1f}s")
    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in phase_s.items()}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def ptxas_instances(name, report):
    """Per template instance of kernel ``name``'s ``-Xptxas -v`` report:
    {instance, kv, dh, registers, spill_stores, spill_loads, stack}."""
    import re
    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kv = "bf16" if "__nv_bfloat16" in m.group(1) else "f32"
            ints = [int(v) for v in re.findall(r"Li(\d+)E", m.group(1))]   # DH[, row tiles]
            dh = ints[0] if ints else 0
            cur = dict(instance=f"{name}<{', '.join([kv] + [str(v) for v in ints])}>", kv=kv,
                       dh=dh, stack=0, spill_stores=0, spill_loads=0)
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if cur is not None and m:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if cur is not None and m:
            cur["registers"] = int(m[1])
    return out


def smem_bytes(build, name, kv, dh):
    """Dynamic shared memory of one CTA of an instance, from the library
    (None for a library that does not report it)."""
    fn = getattr(build.library(name), f"{name}_smem_bytes", None)
    if fn is None:
        return None
    return fn(1 if kv == "bf16" else 0, dh)


def check_kernels(cfgs, ctx):
    """Phase 2. Returns {row name: max abs error over the cases}."""
    from repro_torch.kernels.nsa_verify import ops as vops
    from repro_torch.models import nsa as nsa_lib
    max_err = {}

    def note(key, e):
        max_err[key] = max(max_err.get(key, 0.0), e)

    for Dh, cfg in cfgs.items():
        check_kernel_shapes(cfg, note)
        # the vanilla layer (routing kernel, two branch launches, combine),
        # a counted path, against the plain NSA layer on the same weights
        # and caches
        lcfg, mix, x, kv, cmp, plen, pos, tm = layer_inputs(cfg, "float32", seed=3)
        got, _, (si, _) = counted_path(
            ctx, f"{cfg.name} vanilla NSA layer (f32)", Dh,
            lambda: vops.nsa_verify_vanilla_layer(mix, lcfg, x, kv, cmp, plen, pos, tm),
            lambda r: {"routing": 1, "nsa_verify_vanilla": 2})
        want, _, (si_r, _) = nsa_lib.nsa_verify_ref(mix, lcfg, x, kv, cmp, plen, pos, tm)
        torch.cuda.synchronize()
        if not torch.equal(si, si_r):
            fail(f"vanilla layer Dh {Dh}: selected indices differ from the plain layer")
        note(f"nsa_verify_vanilla_dh{Dh}",
             check_close(f"vanilla layer vs plain NSA layer Dh {Dh}", got, want, "float32"))
        del lcfg, mix, x, kv, cmp
    for label, Hq, Hkv, Dh in FLASH_CASES:
        for dt_name in DTYPES:
            check_flash(label, Hq, Hkv, Dh, dt_name, note, seed=Hq + Dh)
    check_zoo_kernels(cfgs, note)
    free()
    return max_err


def check_kernel_shapes(cfg, note, tag=""):
    """Phase 2 at one (Hq, Hkv, Dh): routing (one row, then two rows) and
    every nsa_verify case, then the paged mode, in f32 and bf16 K/V."""
    Dh = cfg.head_dim
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        inp = verify_inputs(cfg, dt, seed=1)
        check_routing(cfg, inp, dt_name, lambda e: note(f"routing_dh{Dh}", e), tag)
        check_verify_cases(cfg, inp, dt_name, note, tag)
        del inp
        # two rows of different lengths: routing, then the paged mode in
        # a shuffled pool with holes inside and outside the window
        inp = verify_inputs(cfg, dt, seed=6, prefix=(4096, 3001))
        check_routing(cfg, inp, dt_name, lambda e: note(f"routing_dh{Dh}", e), tag)
        for mult in (1, 2):
            pool = paged_pool(cfg, inp, mult, holes=True, seed=mult)
            for label, C, mode, full, branch in VERIFY_CASES[:4]:
                args = verify_layouts(cfg, inp, C, mode, pool)
                oc = None if full else inp["o_cmp_in"]
                got = run_verify(cfg, args, full, oc, plain=False)
                want = run_verify(cfg, args, full, oc, plain=True)
                torch.cuda.synchronize()
                note(f"nsa_verify_paged_dh{Dh}", check_close(
                    f"{tag}nsa_verify paged {label} ps {mult}x{cfg.nsa.sel_block} Dh {Dh}",
                    got, want, dt_name))
            del pool
        del inp


# The attention shapes of the zoo's NSA variants (label, Dh, Hq, Hkv): the
# query-head groups and head dims the kernels take beyond the 1B / 8B
# targets' (Gq 4 at Dh 64 and 128)
ZOO_SHAPES = [("qwen3-moe", 64, 64, 4), ("granite", 128, 48, 1), ("mixtral", 128, 48, 8),
              ("musicgen", 64, 24, 24), ("smollm", 64, 15, 5), ("pixtral", 160, 32, 8),
              ("nemotron", 192, 96, 8), ("recurrentgemma", 256, 16, 1)]
# The zoo drafts' flash shapes beyond the 1B / 8B drafts' (label, Hq, Hkv,
# Dh): ``draft_config`` of each arch (heads = kv heads)
DRAFT_FLASH_CASES = [("smollm draft", 3, 3, 80), ("xlstm draft", 2, 2, 96),
                     ("pixtral draft", 8, 8, 160), ("nemotron draft", 24, 24, 192),
                     ("recurrentgemma draft", 4, 4, 256)]


def zoo_kernel_cfg(cfgs, Dh, Hq, Hkv):
    """The 1B / 8B config (of head dim Dh, else the 8B's) with the zoo's
    head counts and head dim (the kernels see only heads, head dim and the
    NSA geometry, which is the same default NSAConfig)."""
    return dataclasses.replace(cfgs.get(Dh, cfgs[128]), num_heads=Hq, num_kv_heads=Hkv,
                               head_dim=Dh, d_model=Hq * Dh)


def check_zoo_kernels(cfgs, note):
    """Phase 2 at the zoo's shapes: routing and nsa_verify at Gq 16 (one
    query per routing CTA; 32 / 64 verify rows in 2 / 4 row tiles), 48
    (three routing head slabs; 96 / 192 rows in 6 / 12 row tiles), 6 (24
    rows at approx C=4: two row tiles), 1 and 3 (smollm), and at head dims
    160 (pixtral, Gq 4), 192 (nemotron, Gq 12) and 256 (recurrentgemma, Gq
    16); flash at Gq 48, windowed (4096) at mixtral's shapes, and at the
    drafts' head dims 80, 96, 160, 192 and 256."""
    for label, Dh, Hq, Hkv in ZOO_SHAPES:
        gq = Hq // Hkv
        sfx = "" if gq == 4 else f"_gq{gq}"          # the rows' keys (launch_key)
        check_kernel_shapes(zoo_kernel_cfg(cfgs, Dh, Hq, Hkv),
                            lambda k, e, sfx=sfx: note(k + sfx, e), f"{label} Gq {gq} ")
    for dt_name in DTYPES:
        check_flash("granite target Gq 48", 48, 1, 128, dt_name, note, seed=5)
        check_flash("mixtral target, window 4096", 48, 8, 128, dt_name, note, seed=6,
                    prefix=6000, window=4096)
        for label, Hq, Hkv, Dh in DRAFT_FLASH_CASES:
            check_flash(label, Hq, Hkv, Dh, dt_name, note, seed=Hq + Dh)


def launch_key(counter, Dh, gq=4):
    """The kernel row a launch counts under: ``<counter>_dh<Dh>``, with
    ``_gq<Gq>`` for the zoo targets' query-head groups other than the 1B /
    8B targets' 4 (flash serves the drafts, Gq 1, under its plain name)."""
    return f"{counter}_dh{Dh}" + ("" if gq == 4 or counter == "flash_verify" else f"_gq{gq}")


def counted_path(ctx, name, Dh, fn, want_of, gq=4, flash_dh=None):
    """Run one main path with every counter at 0, read the counts after it
    and check them against ``want_of(result)`` ({counter: count}, the rest
    must stay 0). Adds the counts to the launches of head dim Dh (and the
    target's query-head group ``gq``); flash's to ``flash_dh`` (the
    draft's head dim) when given."""
    for c in ctx["counters"]:
        c.reset()
    res = fn()
    torch.cuda.synchronize()
    counts = {c.name: c.count for c in ctx["counters"]}
    want = {c.name: 0 for c in ctx["counters"]}
    want.update(want_of(res))
    if counts != want:
        fail(f"{name}: launch counts {counts}, expected {want}")
    ctx["paths"][name] = counts
    for k, v in counts.items():
        key = launch_key(k, flash_dh if flash_dh and k == "flash_verify" else Dh, gq)
        ctx["launches"][key] = ctx["launches"].get(key, 0) + v
    log(f"  [{name}] launches {counts}")
    return res


def strategy(cfg, pc):
    from repro_torch.config import SSVConfig
    from repro_torch.core import planner as planner_lib
    mode, reuse = planner_lib.class_constraints(pc)
    sched = planner_lib.default_schedule(cfg.num_layers) if reuse else ()
    return SSVConfig(tree_depth=4, tree_width=2, group_size=4 if mode == "approx" else 2,
                     group_mode=mode, refresh_schedule=sched, precision_class=pc)


def generate_all(eng, prompts, cfg, label, new_tokens=16):
    n_tok = n_steps = 0
    step_s = 0.0
    accepted, token_ids = [], []
    for prompt in prompts:
        res = eng.generate(prompt, max_new_tokens=new_tokens)
        token_ids.append(res.tokens.tolist())
        if len(res.tokens) != new_tokens or not all(0 <= t < cfg.vocab_size for t in res.tokens):
            fail(f"{label}: bad tokens {res.tokens}")
        n_tok += len(res.tokens)
        n_steps += len(res.steps)
        step_s += sum(s.latency_s for s in res.steps)
        accepted += [s.accepted for s in res.steps]
    return dict(tokens=n_tok, steps=n_steps, tokens_per_s=n_tok / step_s,
                mean_accepted=sum(accepted) / len(accepted), token_ids=token_ids)


def load_weights(cfg, seed):
    """Random full-width target and draft weights from a seed."""
    from repro_torch.bridge import init_params
    from repro_torch.core import draft as draft_lib
    dcfg = draft_lib.draft_config(cfg)
    gen = torch.Generator(DEV)
    gen.manual_seed(seed)
    t0 = time.time()
    tp = init_params(cfg, gen, DEV)
    dp = init_params(dcfg, gen, DEV)
    log(f"[weights {cfg.name} {cfg.dtype}] drawn in {time.time() - t0:.1f}s")
    return tp, dcfg, dp


def draft_passes(ssv):
    """Draft verify passes per step: one per level of the built tree plus
    the final pass (a node budget can leave the tree shallower than
    tree_depth: D6/k10/budget 128 has 3 levels)."""
    from repro_torch.core.tree import build_topology
    topo = build_topology(ssv.tree_depth, ssv.tree_width, ssv.traversal, ssv.tree_budget)
    return int(topo.depths.max()) + 1


def expected_launches(cfg, dcfg, ssv, steps, paged=False):
    """Launches per counted serving path: one per NSA layer and step
    (routing + partial fusion on refresh layers, full fusion on reuse
    layers; every one of them ``nsa_verify_paged`` on the paged store;
    recurrent layers launch none), 2 draft layers x (tree levels + 1)
    passes of flash per step."""
    nsa = [i for i, k in enumerate(cfg.layer_kinds()) if k not in ("rglru", "mlstm", "slstm")]
    reuse = set(ssv.refresh_schedule) - {0}
    refresh = len([i for i in nsa if i not in reuse])
    want = {"routing": refresh * steps,
            "flash_verify": dcfg.num_layers * draft_passes(ssv) * steps}
    if paged:
        want["nsa_verify_paged"] = len(nsa) * steps
    else:
        want.update(nsa_verify_partial=refresh * steps,
                    nsa_verify_full=(len(nsa) - refresh) * steps)
    return {k: v for k, v in want.items() if v}


def serve_e2e(cfg, Dh, weights, ctx):
    """Phase 3: both precision classes through SSVEngine (one 4097-token
    prompt); returns the end-to-end numbers and adds the launch counts."""
    from repro_torch.config import ServeConfig
    from repro_torch.core import engine as engine_lib
    tp, dcfg, dp = weights
    prompts = [ctx["corpus"].batch(0, 1, 4097)[0] % cfg.vocab_size]
    e2e = {}
    for pc in ("Strict", "Approx+Reuse"):
        ssv = strategy(cfg, pc)
        serve_cfg = ServeConfig(max_new_tokens=16, temperature=0.0, max_context=8192,
                                ssv=ssv, use_planner=False)
        eng = engine_lib.SSVEngine(tp, cfg, dp, dcfg, serve_cfg, device=DEV)
        torch.cuda.reset_peak_memory_stats()
        res = counted_path(
            ctx, f"{cfg.name} {pc}", Dh, lambda: generate_all(eng, prompts, cfg, pc),
            lambda r: expected_launches(cfg, dcfg, ssv, r["steps"]))
        prof = profile_steps(eng, prompts[0], f"{cfg.name} {pc}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        e2e[pc] = dict(res, peak_gib=peak, launches=ctx["paths"][f"{cfg.name} {pc}"],
                       profile=prof)
        log(f"[3 e2e {cfg.name} {pc}] {ctx['kind']} ({ctx['card']}): {res['tokens']} tokens "
            f"in {res['steps']} steps, {res['tokens_per_s']:.2f} tok/s (decode steps only), "
            f"mean accepted/step {res['mean_accepted']:.3f}, peak memory {peak:.2f} GiB")
        del eng
    return e2e


# 8B in phase 4: the paged store at 2 slots, one wave, Strict only; a
# profile at 1 and 2 slots
BATCHED_8B = dict(slots=2, n_req=2, classes=("Strict",), backends=("paged",),
                  continuous=False, sweep=(1, 2))
# Depth cuts that make room for phase 14 (a new path cuts depth first, never
# width): phases 3-4 serve ssv-nsa-1b and ssv-nsa-8b at SERVE_LAYERS of
# their 16 and 32 layers (a refresh and a reuse layer each), and phase 5's
# float32 equalities run ssv-nsa-1b at F32_1B_LAYERS of 16.
# Launch counts are layers x passes at the served depth.
SERVE_LAYERS = {64: 2, 128: 2}
F32_1B_LAYERS = 4


def serve_depth(cfg):
    """``cfg`` at phases 3-4's depth (``SERVE_LAYERS``); a cut config is
    named for its depth (``-x<layers>``), so no number of the full depth
    is printed beside it."""
    layers = SERVE_LAYERS[cfg.head_dim]
    if not layers or layers >= cfg.num_layers:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers, name=f"{cfg.name}-x{layers}")


def serve_batched(cfg, Dh, weights, ctx, slots=4, n_req=6, classes=("Strict", "Approx+Reuse"),
                  backends=("dense", "paged"), continuous=True, sweep=(1, 2, 4), gq=4,
                  prompt_len=4097):
    """Phase 4: ``generate_batch`` over ``slots`` requests and
    ``serve_continuous`` of ``n_req`` requests (Poisson arrivals, 0.5 per
    step) over ``slots`` slots, per precision class and store, as counted
    paths; paged tokens must equal dense tokens. Then a profile at each
    slot count of ``sweep`` (Strict) on each store."""
    from repro_torch.config import ServeConfig
    from repro_torch.core import engine as engine_lib, schedule
    tp, dcfg, dp = weights
    prompts = [ctx["corpus"].batch(100 + i, 1, prompt_len)[0] % cfg.vocab_size
               for i in range(n_req)]
    arrivals = schedule.poisson_arrivals(n_req, 0.5, seed=0)
    out, tokens = {}, {}
    tag = f"[{'4' if gq == 4 else '10'} batched {cfg.name}]"

    def engine(backend, pc):
        return engine_lib.BatchedSSVEngine(tp, cfg, dp, dcfg, ServeConfig(
            max_new_tokens=16, temperature=0.0, max_context=8192, ssv=strategy(cfg, pc),
            use_planner=False, kv_backend=backend), device=DEV)

    def check(name, res):
        for r in res.results:
            if len(r.tokens) != 16 or not all(0 <= t < cfg.vocab_size for t in r.tokens):
                fail(f"{name}: bad tokens {r.tokens}")

    for backend in backends:
        paged = backend == "paged"
        for pc in classes:
            ssv = strategy(cfg, pc)
            eng = engine(backend, pc)
            torch.cuda.reset_peak_memory_stats()
            name = f"{cfg.name} {backend} {pc} generate_batch x{slots}"
            res = counted_path(ctx, name, Dh, lambda: eng.generate_batch(prompts[:slots], 16),
                               lambda r: expected_launches(cfg, dcfg, ssv, r.steps, paged), gq,
                               dcfg.head_dim)
            check(name, res)
            rec = dict(batch_tokens=res.total_tokens, batch_steps=res.steps,
                       batch_wall_s=res.wall_s, batch_tok_s=res.aggregate_throughput,
                       kv_cache_bytes=eng.kv_cache_bytes())
            tokens[(backend, pc, "batch")] = [r.tokens.tolist() for r in res.results]
            if continuous:
                reqs = [schedule.Request(req_id=i, prompt=p, arrival=float(a))
                        for i, (p, a) in enumerate(zip(prompts, arrivals))]
                name = f"{cfg.name} {backend} {pc} serve_continuous {n_req} req x{slots} slots"
                cres = counted_path(
                    ctx, name, Dh,
                    lambda: eng.serve_continuous(reqs, num_slots=slots, max_new_tokens=16),
                    lambda r: expected_launches(cfg, dcfg, ssv, r.steps, paged), gq,
                    dcfg.head_dim)
                check(name, cres)
                rec.update(cont_tokens=cres.total_tokens, cont_steps=cres.steps,
                           cont_wall_s=cres.wall_s, cont_tok_s=cres.aggregate_throughput,
                           occupancy=cres.mean_occupancy,
                           queue_delay_steps=cres.mean_queue_delay_steps,
                           peak_page_occupancy=cres.peak_page_occupancy,
                           kv_bytes=cres.kv_bytes)
                tokens[(backend, pc, "cont")] = [r.tokens.tolist() for r in cres.results]
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            out[f"{backend} {pc}"] = rec
            log(f"{tag} {backend} {pc} ({ctx['card']}): generate_batch {rec['batch_tokens']} "
                f"tokens in {rec['batch_steps']} steps, {rec['batch_tok_s']:.2f} tok/s aggregate; "
                + (f"serve_continuous {rec['cont_tokens']} tokens in {rec['cont_steps']} steps, "
                   f"{rec['cont_tok_s']:.2f} tok/s, occupancy {rec['occupancy']:.2f}, queue "
                   f"delay {rec['queue_delay_steps']:.2f} steps, peak page occupancy "
                   f"{rec['peak_page_occupancy']:.3f}; " if continuous else "")
                + f"kv_cache_bytes {rec['kv_cache_bytes']}, peak memory {rec['peak_gib']:.2f} GiB")
            del eng
            free()
    for (backend, pc, mode), toks in tokens.items():
        if backend == "paged" and ("dense", pc, mode) in tokens:
            if toks != tokens[("dense", pc, mode)]:
                fail(f"{cfg.name} {pc} {mode}: paged tokens differ from dense tokens")
            log(f"{tag} {pc} {mode}: paged tokens == dense tokens ({len(toks)} requests)")
    for backend in backends if sweep else ():
        eng = engine(backend, "Strict")
        for n in sweep:
            torch.cuda.reset_peak_memory_stats()
            prof = profile_batched(eng, prompts[:n], f"{cfg.name} {backend} x{n}")
            prof["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            prof["kv_cache_bytes"] = eng.kv_cache_bytes()
            out[f"{backend} Strict profile x{n}"] = prof
            log(f"{tag} {backend} Strict {n} slot(s) ({ctx['card']}): step "
                f"{prof['step_wall_ms']:.2f} ms, {prof['tok_s']:.2f} tok/s aggregate, "
                f"{prof['kernels_per_step']} launches/step, device busy "
                f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f}, "
                f"{prof['dtoh_per_step']} DtoH copies/step, kv_cache_bytes "
                f"{prof['kv_cache_bytes']}, peak memory {prof['peak_gib']:.2f} GiB")
        del eng
        free()
    return out


# Phase 4, bucketed: two context buckets of ssv-nsa-1b under Strict. Bucket
# 0 runs the JAX candidate D6/k10/budget 128 (T = 129, 3 levels), bucket 1 the D4/k2
# tree; prompts of 1025 and 4097 tokens keep both buckets live.
BUCKETS = ((0, 2048), (2048, 8192))
BUCKET_LENS = (1025, 4097)


def bucket_profile(cfg):
    """The hand-built two-bucket profile (a ``planner.Profile``). Expected
    acceptance 0 keeps each bucket's guard at rank 0, so a bucket's
    strategy is fixed. Not ``candidate_strategies`` whole: its largest
    trees (5,461 nodes for D6/k4) need a step headroom beyond max_context
    8192."""
    from repro_torch.config import SSVConfig
    from repro_torch.core import planner as planner_lib
    short = next(s for s in planner_lib.candidate_strategies("Strict", cfg.num_layers)
                 if (s.tree_depth, s.tree_width, s.tree_budget, s.traversal) == (6, 10, 128, "bfs"))
    long_ = SSVConfig(tree_depth=4, tree_width=2, group_size=2, group_mode="exact",
                      precision_class="Strict")
    return planner_lib.Profile(
        table={(0, "Strict"): [planner_lib.ProfileEntry(short, 0.0, 0.01)],
               (1, "Strict"): [planner_lib.ProfileEntry(long_, 0.0, 0.01)]},
        buckets=BUCKETS)


def cli_bucket_profile():
    """The serve CLI's profile for phase 7: its mixed prompts of 24, 48 and
    96 tokens fall in two buckets (D3/k2 below 40 tokens, D4/k2 above)."""
    from repro_torch.config import SSVConfig
    from repro_torch.core import planner as planner_lib
    entry = lambda d: [planner_lib.ProfileEntry(SSVConfig(tree_depth=d, tree_width=2), 0.0, 0.01)]
    return planner_lib.Profile(table={(0, "Strict"): entry(3), (1, "Strict"): entry(4)},
                               buckets=((0, 40), (40, 2048)))


def bucket_strategy(profile, prompt):
    from repro_torch.core import planner as planner_lib
    return profile.table[(planner_lib.bucket_of(len(prompt), profile.buckets), "Strict")][0].strategy


def bucket_engine(cfg, weights, profile, backend="dense", graphs=True, max_new=16):
    from repro_torch.config import ServeConfig
    from repro_torch.core import engine as engine_lib, planner as planner_lib
    tp, dcfg, dp = weights
    return engine_lib.BatchedSSVEngine(tp, cfg, dp, dcfg, ServeConfig(
        max_new_tokens=max_new, temperature=0.0, max_context=8192,
        ssv=profile.table[(1, "Strict")][0].strategy, use_planner=False, kv_backend=backend),
        planner=planner_lib.BatchPlanner(profile), device=DEV, cuda_graphs=graphs)


def serve_bucketed(cfg, Dh, weights, ctx, slots=4, n_req=6, gq=4):
    """Phase 4, bucketed: ``warmup`` captures |strategies| x |group sizes|
    graphs; then ``serve_continuous(warmup=True)`` of ``n_req`` requests
    (Poisson arrivals, 0.5 per step) as a counted path: every group step a
    graph replay, no capture during the serve, the counters exact under
    replay (each graph's launches per replay equal one eager step's, and
    the totals equal the replays' sums); paged tokens == dense tokens."""
    from repro_torch.core import schedule
    tp, dcfg, dp = weights
    profile = bucket_profile(cfg)
    prompts = [ctx["corpus"].batch(200 + i, 1, BUCKET_LENS[i % 2])[0] % cfg.vocab_size
               for i in range(n_req)]
    arrivals = schedule.poisson_arrivals(n_req, 0.5, seed=1)
    tag = f"[4 bucketed {cfg.name}]"
    out, tokens = {}, {}
    for backend in ("dense", "paged"):
        paged = backend == "paged"
        eng = bucket_engine(cfg, weights, profile, backend)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        built = eng.warmup(num_slots=slots)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        entries = list(eng.step_cache._exe.values())
        want = len(eng.planner.reachable_strategies()) * len(eng._padded_group_sizes())
        captured = sum(e.graph is not None for e in entries)
        if built != want or captured != want:
            fail(f"{tag} {backend}: warmup built {built} entries, {captured} graphs; "
                 f"expected {want}")
        for e in entries:
            per = {k: v for k, v in expected_launches(cfg, dcfg, e.ssv, 1, paged).items() if v}
            got = {c.name: n for c, n in e.counts.items()}
            if got != per:
                fail(f"{tag} {backend}: graph {e.ssv.tree_depth}/{e.ssv.tree_width} g={e.g} "
                     f"replays {got} launches, one eager step makes {per}")
            e.runs = 0
        misses = eng.step_cache.misses
        reqs = [schedule.Request(req_id=i, prompt=p, arrival=float(a))
                for i, (p, a) in enumerate(zip(prompts, arrivals))]
        name = f"{cfg.name} {backend} bucketed serve_continuous {n_req} req x{slots} slots"

        def replay_counts(res):
            want = {}
            for e in entries:
                for k, v in expected_launches(cfg, dcfg, e.ssv, e.runs, paged).items():
                    want[k] = want.get(k, 0) + v
            return want

        res = counted_path(ctx, name, Dh, lambda: eng.serve_continuous(
            reqs, num_slots=slots, max_new_tokens=16, warmup=True), replay_counts, gq,
            dcfg.head_dim)
        if eng.step_cache.misses != misses:
            fail(f"{tag} {backend}: {eng.step_cache.misses - misses} group steps were "
                 "built during the serve")
        if res.group_launches != sum(e.runs for e in entries):
            fail(f"{tag} {backend}: {res.group_launches} group launches, "
                 f"{sum(e.runs for e in entries)} replays")
        for r in res.results:
            if len(r.tokens) != 16 or not all(0 <= t < cfg.vocab_size for t in r.tokens):
                fail(f"{name}: bad tokens {r.tokens}")
        if set(res.bucket_occupancy) != {0, 1}:
            fail(f"{name}: bucket occupancy {res.bucket_occupancy}, expected both buckets live")
        tokens[backend] = [r.tokens.tolist() for r in res.results]
        rec = dict(warmup_s=warm_s, graphs=captured, tokens=res.total_tokens, steps=res.steps,
                   group_launches=res.group_launches, wall_s=res.wall_s,
                   tok_s=res.aggregate_throughput, occupancy=res.mean_occupancy,
                   bucket_occupancy=res.bucket_occupancy, kernel_cache=res.kernel_cache,
                   replays={f"D{e.ssv.tree_depth}/k{e.ssv.tree_width} g={e.g}": e.runs
                            for e in entries},
                   peak_page_occupancy=res.peak_page_occupancy, kv_bytes=res.kv_bytes,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        out[backend] = rec
        log(f"{tag} {backend} ({ctx['card']}): warmup captured {captured} graphs in "
            f"{warm_s:.2f}s; {rec['tokens']} tokens in {rec['steps']} rounds, "
            f"{rec['group_launches']} group steps (replays {rec['replays']}), "
            f"{rec['tok_s']:.2f} tok/s, bucket occupancy "
            f"{ {b: round(v, 3) for b, v in res.bucket_occupancy.items()} }, step cache "
            f"{res.kernel_cache['step_cache_hits']} hits / "
            f"{res.kernel_cache['step_cache_misses']} misses, peak memory "
            f"{rec['peak_gib']:.2f} GiB")
        del eng, entries
        free()
    if tokens["paged"] != tokens["dense"]:
        fail(f"{tag}: paged tokens differ from dense tokens")
    log(f"{tag} paged tokens == dense tokens ({n_req} requests)")
    return out


def step_profile(fn, n):
    """n calls of ``fn`` after one: host wall per call, then under the
    profiler device busy time, device kernels, host launch calls and
    host<->device copies per call, and the 10 kernels with the most device
    time per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy = kernels = htod = dtoh = host_launches = 0
    kern = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            ms = (getattr(ev, "self_device_time_total", 0.0) or
                  getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
            busy += ms
            kern.append((ms / n, ev.count / n, ev.key[:80]))
            kernels += 0 if is_copy(ev.key) else ev.count
            htod += ev.count if "HtoD" in ev.key else 0
            dtoh += ev.count if "DtoH" in ev.key else 0
        elif ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                        "cudaGraphLaunch"):
            host_launches += ev.count
    busy /= n
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "device_kernels_per_step": kernels / n, "host_launch_calls_per_step": host_launches / n,
            "htod_per_step": htod / n, "dtoh_per_step": dtoh / n,
            "top": [{"ms": ms, "launches": c, "name": name}
                    for ms, c, name in sorted(kern, reverse=True)[:10]]}


def profile_group_steps(cfg, weights, ctx, slots=4, n=3):
    """Phase 4 profile: one group step of the D4/k2 bucket (4097-token
    prompts, dense store, Strict) at g = 1 and g = 4, eager ``step_group``
    against graph replay on the same admitted state; whether the first
    step's tokens and caches are bitwise equal (bf16) is reported. These
    are records, not claims."""
    from repro_torch.core import engine as engine_lib
    profile = bucket_profile(cfg)
    ssv = profile.table[(1, "Strict")][0].strategy
    prompts = [ctx["corpus"].batch(300 + i, 1, 4097)[0] % cfg.vocab_size for i in range(slots)]
    engs = {mode: bucket_engine(cfg, weights, profile, graphs=mode == "graph")
            for mode in ("eager", "graph")}
    engs["graph"].warmup(num_slots=slots, strategies=[ssv])
    for eng in engs.values():
        eng.start_empty(slots)       # the graph engine keeps its graphs
        for s, p in enumerate(prompts):
            eng.admit(s, p, max_new_tokens=64)
    out = {}
    for g in (1, slots):
        # both engines make the same steps, so they stay in one state
        rows = list(range(g))
        first = {}
        for mode, eng in engs.items():
            toks, n_acc = eng.step_group(rows, ssv)
            torch.cuda.synchronize()
            first[mode] = ((toks.tolist(), n_acc.tolist()),
                           [t.clone() for c in (eng.t_caches, eng.d_caches)
                            for t in engine_lib._row_leaves(c, False)])
            out[f"{mode} g={g}"] = step_profile(lambda: eng.step_group(rows, ssv), n)
        bitwise = first["eager"][0] == first["graph"][0] and all(
            torch.equal(a, b) for a, b in zip(first["eager"][1], first["graph"][1]))
        out[f"bitwise g={g}"] = bitwise
        for mode in ("eager", "graph"):
            p = out[f"{mode} g={g}"]
            log(f"[4 group-step profile {cfg.name} D4/k2 g={g} {mode}] ({ctx['card']}): step "
                f"{p['step_wall_ms']:.2f} ms wall, device busy {p['device_busy_ms']:.2f} ms, "
                f"idle share {p['idle_share']:.3f}, {p['device_kernels_per_step']:.0f} device "
                f"kernels/step, {p['host_launch_calls_per_step']:.0f} host launch calls/step, "
                f"{p['htod_per_step']:.0f} HtoD + {p['dtoh_per_step']:.0f} DtoH copies/step")
        log(f"[4 group-step profile {cfg.name} g={g}] bf16 graph replay vs eager step_group "
            f"(first step, tokens and caches): {'bitwise equal' if bitwise else 'NOT bitwise equal'}")
        del first
    del engs
    free()
    return out


def is_copy(name):
    return name.startswith("Memcpy") or name.startswith("Memset")


def report_launches_per_step(key, kernels):
    """Kernel launches per decode step (copies excluded) beside the
    pre-redesign tree's at the same configuration (see PRE_REDESIGN_KERNELS_PER_STEP)."""
    want = PRE_REDESIGN_KERNELS_PER_STEP.get(key)
    if want is None:
        log(f"  [{key}] {kernels} kernel launches per step")
        return
    log(f"  [{key}] {kernels} kernel launches per step (pre-redesign: {want}, "
        f"{kernels - want:+d})")


def profile_batched(eng, prompts, key, n: int = 3):
    """A batched step at len(prompts) rows: n steps after one warm step,
    unprofiled (host clock) for the step time and throughput, then under
    the profiler for device busy time, launches and device-to-host copies
    per step (the engine makes exactly one: its tokens + counts)."""
    from torch.profiler import ProfilerActivity, profile
    R = len(prompts)
    eng.start(prompts)
    active = [True] * R
    eng.step(active)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emitted = 0
    for _ in range(n):
        _, n_acc = eng.step(active)
        emitted += int((n_acc + 1).sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step(active)
        torch.cuda.synchronize()
    busy = launches = kernels = dtoh = 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", 0.0) or \
                getattr(ev, "self_cuda_time_total", 0.0)
            busy += us / n / 1e3
            launches += ev.count
            kernels += 0 if is_copy(ev.key) else ev.count
            if "DtoH" in ev.key:
                dtoh += ev.count
    step_ms = wall * 1e3 / n
    if dtoh != n:
        fail(f"batched step at {R} rows: {dtoh} device-to-host copies in {n} steps, "
             "expected one per step")
    report_launches_per_step(key, kernels // n)
    return {"rows": R, "step_wall_ms": step_ms, "tok_s": emitted / wall,
            "device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
            "kernels_per_step": launches // n, "kernel_launches_per_step": kernels // n,
            "dtoh_per_step": dtoh / n}


def profile_steps(eng, prompt, key, n: int = 3):
    """Where a decode step's time goes: n steps under the profiler (after
    the main-path counts are read), device busy time per kernel against
    the host's wall time."""
    from torch.profiler import ProfilerActivity, profile
    eng.start(prompt)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", 0.0) or \
                getattr(ev, "self_cuda_time_total", 0.0)
            kern.append((us / n / 1e3, ev.count // n, ev.key))
    kern.sort(reverse=True)
    busy = sum(k[0] for k in kern)
    top = [{"ms": ms, "launches": c, "name": name[:80]} for ms, c, name in kern[:10]]
    log(f"  profile: step {wall_ms:.2f} ms wall, device busy {busy:.2f} ms "
        f"(idle share {1 - busy / wall_ms:.3f}), {sum(k[1] for k in kern)} kernels/step")
    for t in top[:6]:
        log(f"    {t['ms']:.3f} ms x{t['launches']} {t['name']}")
    kernels = sum(k[1] for k in kern if not is_copy(k[2]))
    report_launches_per_step(key, kernels)
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "kernels_per_step": sum(k[1] for k in kern), "kernel_launches_per_step": kernels,
            "top": top}


def strict_equals_ar(cfg, layers, n_tok, ctx, prompt_len=2049, tag="5"):
    """Strict == AR (float32, full width; ``layers`` cuts depth): Strict SSV
    tokens equal autoregressive decoding. Returns (weights, prompt, the
    SSV tokens) for further checks on the same weights."""
    from repro_torch.config import ServeConfig, SSVConfig
    from repro_torch.core import engine as engine_lib
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=layers or cfg.num_layers)
    weights = load_weights(cfg32, seed=1)
    tp, dcfg32, dp = weights
    prompt = ctx["corpus"].batch(7, 1, prompt_len)[0] % cfg.vocab_size
    ssv = SSVConfig(tree_depth=4, tree_width=2, precision_class="Strict")
    eng = engine_lib.SSVEngine(tp, cfg32, dp, dcfg32, ServeConfig(
        max_new_tokens=n_tok, temperature=0.0, max_context=8192, ssv=ssv,
        use_planner=False), device=DEV)
    ssv_toks = eng.generate(prompt, max_new_tokens=n_tok).tokens
    ar_toks = engine_lib.autoregressive_decode(tp, cfg32, prompt, n_tok, 8192,
                                               device=DEV).tokens
    tag = f"[{tag} strict==AR f32 {cfg.name}{f' {layers} layers' if layers else ''}]"
    log(f"{tag} ssv {ssv_toks.tolist()}")
    log(f"{tag} ar  {ar_toks.tolist()}")
    if len(ssv_toks) != n_tok or ssv_toks.tolist() != ar_toks.tolist():
        fail(f"{cfg.name}: Strict SSV tokens differ from autoregressive decoding in float32")
    return cfg32, weights, prompt, ssv_toks


def f32_equalities(cfg, ctx, n_tok=16, rows=3, layers=None):
    """Phase 5 on float32 ``cfg`` (``layers`` cuts its depth): Strict ==
    AR; batched ``generate_batch`` over ``rows`` 2049-token prompts equals
    per-request ``SSVEngine.generate``; the paged single stream equals the
    dense one."""
    from repro_torch.config import ServeConfig, SSVConfig
    from repro_torch.core import engine as engine_lib
    cfg32, (tp, dcfg32, dp), prompt, first = strict_equals_ar(cfg, layers, n_tok, ctx)
    if layers:
        cfg32 = dataclasses.replace(cfg32, name=f"{cfg.name}-x{layers}")
    name = cfg32.name
    prompts = [prompt] + [ctx["corpus"].batch(8 + i, 1, 2049)[0] % cfg.vocab_size
                          for i in range(rows - 1)]

    def serve(backend="dense"):
        return ServeConfig(max_new_tokens=n_tok, temperature=0.0, max_context=8192,
                           ssv=SSVConfig(tree_depth=4, tree_width=2, precision_class="Strict"),
                           use_planner=False, kv_backend=backend)

    single = [first.tolist()] + [
        engine_lib.SSVEngine(tp, cfg32, dp, dcfg32, serve(), device=DEV)
        .generate(p, n_tok).tokens.tolist() for p in prompts[1:]]
    batch = engine_lib.BatchedSSVEngine(tp, cfg32, dp, dcfg32, serve(), device=DEV) \
        .generate_batch(prompts, n_tok)
    got = [r.tokens.tolist() for r in batch.results]
    log(f"[5 batched==single f32 {name}] {rows} rows x {n_tok} tokens: "
        f"{'equal' if got == single else 'DIFFERENT'}")
    if got != single:
        fail(f"{name}: batched tokens {got} differ from single-stream tokens {single}")
    paged = engine_lib.SSVEngine(tp, cfg32, dp, dcfg32, serve("paged"), device=DEV) \
        .generate(prompt, n_tok).tokens.tolist()
    log(f"[5 paged==dense f32 {name}] single stream: "
        f"{'equal' if paged == single[0] else 'DIFFERENT'}")
    if paged != single[0]:
        fail(f"{name}: paged single-stream tokens differ from dense")
    bucketed_f32(cfg32, (tp, dcfg32, dp), ctx, n_tok)


def bucketed_f32(cfg32, weights, ctx, n_tok, slots=3):
    """Phase 5, bucketed: ``serve_continuous`` with ``warmup=True`` (one
    CUDA graph per strategy and group size) over 3 rows of the two bucket
    lengths equals each row's ``SSVEngine.generate`` under its bucket's
    strategy; then graph replay against the eager ``step_group`` on the
    same admitted rows (g = 1, 2 and 3, both strategies): bitwise equal
    tokens and caches."""
    from repro_torch.config import ServeConfig
    from repro_torch.core import engine as engine_lib
    tp, dcfg32, dp = weights
    profile = bucket_profile(cfg32)
    prompts = [ctx["corpus"].batch(400 + i, 1, BUCKET_LENS[i % 2])[0] % cfg32.vocab_size
               for i in range(slots)]
    single = [engine_lib.SSVEngine(tp, cfg32, dp, dcfg32, ServeConfig(
        max_new_tokens=n_tok, temperature=0.0, max_context=8192,
        ssv=bucket_strategy(profile, p), use_planner=False), device=DEV)
        .generate(p, n_tok).tokens.tolist() for p in prompts]
    eng = bucket_engine(cfg32, weights, profile, max_new=n_tok)
    res = eng.serve_continuous(prompts, num_slots=slots, max_new_tokens=n_tok, warmup=True)
    got = [r.tokens.tolist() for r in res.results]
    tag = f"[5 bucketed==single f32 {cfg32.name}]"
    log(f"{tag} {slots} rows x {n_tok} tokens ({res.group_launches} group steps, "
        f"{res.kernel_cache['step_cache_misses']} graphs captured by warmup): "
        f"{'equal' if got == single else 'DIFFERENT'}")
    if got != single:
        fail(f"{cfg32.name}: bucketed tokens {got} differ from single-stream tokens {single}")
    eager = bucket_engine(cfg32, weights, profile, graphs=False, max_new=n_tok)
    strategies = [profile.table[(b, "Strict")][0].strategy for b in (0, 1)]
    script = [([0], 0), ([0, 2], 1), ([1], 0), ([0, 1, 2], 1), ([2, 0], 0), ([0, 1, 2], 0)]
    runs = []
    for e in (eng, eager):
        e.start_empty(slots)
        for i, p in enumerate(prompts):
            e.admit(i, p, max_new_tokens=n_tok)
        steps = [[x.tolist() for x in e.step_group(rows, strategies[k])] for rows, k in script]
        torch.cuda.synchronize()
        runs.append((steps, [t.clone() for c in (e.t_caches, e.d_caches)
                             for t in engine_lib._row_leaves(c, False)]))
    if eng.step_cache.misses != res.kernel_cache["step_cache_misses"]:
        fail(f"{tag}: a graph was captured after warmup")
    bitwise = runs[0][0] == runs[1][0] and all(torch.equal(a, b) for a, b in zip(*[r[1] for r in runs]))
    log(f"[5 graph==eager f32 {cfg32.name}] {len(script)} group steps at g = 1, 2, 3 under both "
        f"strategies: {'bitwise equal' if bitwise else 'NOT bitwise equal'}")
    if not bitwise:
        fail(f"{cfg32.name}: graph replay differs from the eager step_group in float32")


def dense_baseline(cfg, ctx):
    """Phase 6: the dense-verification target (``attention="dense"``, the
    paper's dense baseline, as benchmarks/verification.py builds it)."""
    from repro_torch.bridge import init_params
    from repro_torch.config import ServeConfig
    from repro_torch.core import draft as draft_lib, engine as engine_lib
    dense = dataclasses.replace(cfg, attention="dense")
    dcfg = draft_lib.draft_config(cfg)
    gen = torch.Generator(DEV)
    gen.manual_seed(0)
    tp = init_params(dense, gen, DEV)
    dp = init_params(dcfg, gen, DEV)
    prompts = [ctx["corpus"].batch(0, 1, 4097)[0] % cfg.vocab_size]
    ssv = strategy(cfg, "Strict")
    eng = engine_lib.SSVEngine(tp, dense, dp, dcfg, ServeConfig(
        max_new_tokens=16, temperature=0.0, max_context=8192, ssv=ssv,
        use_planner=False), device=DEV)
    torch.cuda.reset_peak_memory_stats()
    passes = draft_passes(ssv)
    res = counted_path(ctx, f"{cfg.name} dense-verification target", 64,
                       lambda: generate_all(eng, prompts, dense, "dense"),
                       lambda r: {"flash_verify": (dense.num_layers + dcfg.num_layers * passes)
                                  * r["steps"]})
    prof = profile_steps(eng, prompts[0], f"{cfg.name} dense-verification target")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[6 dense baseline {cfg.name}] {res['tokens']} tokens in {res['steps']} steps, "
        f"{res['tokens_per_s']:.2f} tok/s, peak memory {peak:.2f} GiB")
    return dict(res, peak_gib=peak, profile=prof)


# ---------------------------------------------------------------- 10. the zoo
# Every arch of the JAX package besides the 1B / 8B ones, each served as its
# NSA variant (``configs.nsa_variant``, as the serve CLIs do; attention-free
# xlstm as it is) at full width with its ``draft_config`` draft. The MoE
# archs keep 4 of their layers (qwen3-moe 2 since phase 13 joined): one
# card holds ~5 GB of bf16 experts per layer, so 56 and 94 layers (~282 and
# ~463 GB) do not fit; nemotron keeps
# 4 of its 96 (~7 GB of bf16 a layer: 96 are ~680 GB; 4 plus the 256k-vocab
# embedding and head are ~47 GB). qwen3-8b, granite-20b and musicgen-medium
# keep 4 layers too, for the 1,200 s the script must finish in: with all
# three at full depth (36-52 layers) a run took 1,217 s, and with qwen3-8b
# alone at full depth 1,175 s on a slower host (every step is
# launch-bound, so time follows layers; their kernels' shapes do not
# depend on depth). smollm-360m, pixtral-12b and recurrentgemma-9b kept 8,
# 8 and 9 layers since phase 11 joined (at full depth the script took
# 1,085.6 s on one H100 80GB HBM3 at 700 W); since phase 13 joined they keep
# 4, 4 and 6 and xlstm-125m 4 of its 12, qwen3-moe 2 (at 8 / 8 / 9 / 12 the
# script took 1,156.1 s there, 96% of its limit; xlstm's 12 layers alone
# took 54.0 s, at 6 29.4 s; with smollm / pixtral 4, recurrentgemma /
# xlstm 6 and qwen3-moe 4 (25.2 s) it took 1,133.8 s). Since phase 13's
# checks grew (the 2-against-4 micro-batch flips, (b) timed alone) every
# arch keeps 2 layers (xlstm one (mlstm, slstm) period) but
# recurrentgemma, which keeps 6: at 3 its one attention layer never
# launched nsa_verify's full fusion at Dh 256 on the served paths. At 4
# layers the script took 1,143.1 s on one H100 80GB HBM3 at 700 W; the
# zoo at 2 layers took 198.2 s on a host 1.3x slower (212.6 s at 4).
ZOO = ("qwen3-8b", "granite-20b", "musicgen-medium", "mixtral-8x22b", "qwen3-moe-235b-a22b",
       "smollm-360m", "pixtral-12b", "nemotron-4-340b", "recurrentgemma-9b", "xlstm-125m")
ZOO_LAYERS = {"qwen3-8b": 2, "granite-20b": 2, "musicgen-medium": 2, "mixtral-8x22b": 2,
              "qwen3-moe-235b-a22b": 2, "nemotron-4-340b": 2, "smollm-360m": 2,
              "pixtral-12b": 2, "recurrentgemma-9b": 6, "xlstm-125m": 2}
# generate_batch at 2 slots, paged == dense
ZOO_PAGED = ("qwen3-8b", "qwen3-moe-235b-a22b", "recurrentgemma-9b", "xlstm-125m")
ZOO_BUCKETED = ("qwen3-moe-235b-a22b", "xlstm-125m")  # 4 slots, captured group steps
# float32 Strict == AR, at these depths (None: the served depth)
ZOO_F32_AR = {"qwen3-8b": None, "granite-20b": None, "musicgen-medium": None,
              "smollm-360m": None, "pixtral-12b": None}
ZOO_MOE = ("mixtral-8x22b", "qwen3-moe-235b-a22b")
ZOO_F32_CPU = ("nemotron-4-340b", "recurrentgemma-9b", "xlstm-125m")


def zoo_config(arch, layers=None):
    from repro_torch import configs
    cfg = configs.nsa_variant(configs.get_config(arch))
    layers = layers or ZOO_LAYERS.get(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def serve_zoo(arch, ctx, n_tok=8):
    """Phase 10, one arch: one 4097-token prompt prefilled once into one
    ``SSVEngine`` (bf16, random weights from a seed, max_context 8192),
    then per precision class (Strict, then Approx+Reuse, each step under
    its strategy): ``n_tok`` D4/k2 steps as a counted path, then a 3-step
    profile (wall, device busy, idle share, launches, host copies: exactly
    one device-to-host copy per step); tok/s, peak memory and the prefill's
    time (an xLSTM layer steps its cell once per prompt position). The
    ``ZOO_PAGED`` archs then serve 2 slots through ``generate_batch`` on
    the dense and the paged store (paged tokens == dense tokens); the
    ``ZOO_BUCKETED`` ones serve bucketed at 4 slots with captured group
    steps (phase 4's ``serve_bucketed``)."""
    from repro_torch.config import ServeConfig
    from repro_torch.core import engine as engine_lib
    cfg = zoo_config(arch)
    Dh, gq = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    weights = load_weights(cfg, seed=0)
    tp, dcfg, dp = weights
    prompt = ctx["corpus"].batch(0, 1, 4097)[0] % cfg.vocab_size
    out = {"layers": cfg.num_layers, "params": cfg.param_count(), "gq": gq, "head_dim": Dh,
           "draft_head_dim": dcfg.head_dim}
    eng = engine_lib.SSVEngine(tp, cfg, dp, dcfg, ServeConfig(
        max_new_tokens=n_tok, temperature=0.0, max_context=8192, use_planner=False),
        device=DEV)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.start(prompt)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    log(f"[10 zoo {cfg.name}] prefill of both models over 4096 tokens: "
        f"{out['prefill_s']:.2f} s ({ctx['card']})")
    if eng.slstm_graphs is not None:
        out["slstm_prefill"] = slstm_prefill_times(cfg, tp, prompt, eng.slstm_graphs, ctx)

    def serve(ssv):
        toks, lat, acc = [], [], []
        for _ in range(n_tok):
            emitted, st = eng.step(ssv)
            toks += emitted
            lat.append(st.latency_s)
            acc.append(st.accepted)
        if not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{cfg.name}: bad tokens {toks}")
        return dict(tokens=len(toks), steps=n_tok, tokens_per_s=len(toks) / sum(lat),
                    mean_accepted=sum(acc) / n_tok)

    for pc in ("Strict", "Approx+Reuse"):
        ssv = strategy(cfg, pc)
        name = f"{cfg.name} {pc}"
        res = counted_path(ctx, name, Dh, lambda: serve(ssv),
                           lambda r: expected_launches(cfg, dcfg, ssv, r["steps"]), gq,
                           dcfg.head_dim)
        prof = step_profile(lambda: eng.step(ssv), 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if prof["dtoh_per_step"] != 1:
            fail(f"{name}: {prof['dtoh_per_step']} device-to-host copies per step, expected 1")
        out[pc] = dict(res, peak_gib=peak, launches=ctx["paths"][name], profile=prof)
        log(f"[10 zoo {name}] {ctx['kind']} ({ctx['card']}): {cfg.num_layers} layers, "
            f"Gq {gq}, Dh {Dh} (draft {dcfg.head_dim}): {res['tokens']} tokens in {res['steps']} steps, "
            f"{res['tokens_per_s']:.2f} tok/s (decode steps only), mean accepted/step "
            f"{res['mean_accepted']:.3f}, peak memory {peak:.2f} GiB; profile: step "
            f"{prof['step_wall_ms']:.2f} ms wall, device busy {prof['device_busy_ms']:.2f} ms, "
            f"idle share {prof['idle_share']:.3f}, {prof['device_kernels_per_step']:.0f} device "
            f"kernels/step, {prof['dtoh_per_step']:.0f} DtoH copy/step")
        for t in prof["top"][:5]:
            log(f"    {t['ms']:.3f} ms x{t['launches']:.0f} {t['name']}")
    del eng
    free()
    if arch in ZOO_PAGED:
        out["batched"] = serve_batched(cfg, Dh, weights, ctx, slots=2, n_req=2,
                                       classes=("Strict",), continuous=False, sweep=(), gq=gq,
                                       prompt_len=2049)
    if arch in ZOO_BUCKETED:
        # 4 slots of T = 129 and of D4/k2 trees: MoE group steps and the
        # recurrent state replay as graphs
        out["bucketed"] = serve_bucketed(cfg, Dh, weights, ctx, slots=4, n_req=4, gq=gq)
    if arch == "qwen3-moe-235b-a22b":
        out["moe_odd_prefill"] = moe_odd_prefill(cfg, tp, ctx)
    del weights, tp, dp
    free()
    return out


def slstm_prefill_times(cfg, tp, prompt, graphs, ctx):
    """The target's prefill over the 4096-token prompt twice, its sLSTM
    scans replaying the engine's chunks (captured by ``start``) and
    stepping eagerly: the time of each, and the largest difference of the
    two final hidden states."""
    from repro_torch.models import model
    toks = torch.as_tensor(prompt[:-1], dtype=torch.long, device=DEV)[None]
    out, hidden = {}, {}
    for name, g in (("captured", graphs), ("eager", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden[name], _ = model.prefill(tp, cfg, toks, 8192, slstm_graphs=g)
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t0
    out["max_abs_diff"] = float((hidden["captured"].float() - hidden["eager"].float()).abs().max())
    if not math.isfinite(out["max_abs_diff"]):
        fail(f"{cfg.name}: the prefill's hidden states are not finite")
    log(f"[10 zoo {cfg.name}] target prefill over 4096 tokens: sLSTM chunks replayed "
        f"{out['captured_s']:.3f} s, stepped eagerly {out['eager_s']:.3f} s, max |diff| "
        f"{out['max_abs_diff']:.3g} ({ctx['card']})")
    return out


def moe_odd_prefill(cfg, tp, ctx):
    """One MoE FFN over 4097 tokens: odd, so the dispatch group falls to 1
    token and the reference's one-hot expert inputs would be 4097 x 128 x 8
    x 4096 bf16 (~34 GB); the port runs its experts one by one over the
    assignments each kept, as a prefill does. Finite output, and the peak
    memory it adds."""
    from repro_torch.models import moe as moe_lib
    g = torch.Generator(DEV)
    g.manual_seed(9)
    x = torch.randn((1, 4097, cfg.d_model), generator=g, device=DEV).to(torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y, _ = moe_lib.moe_apply(tp["layers"][0]["ffn"], cfg, x, by_expert=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    added = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if y.shape != x.shape or not bool(torch.isfinite(y).all()):
        fail("MoE FFN over 4097 tokens: bad output")
    log(f"[10 zoo {cfg.name}] MoE FFN over 4097 tokens (group 1, capacity "
        f"{moe_lib.capacity(1, cfg.moe)}): finite, {dt * 1e3:.1f} ms, peak +{added:.2f} GiB "
        f"({ctx['card']})")
    return dict(ms=dt * 1e3, peak_added_gib=added)


def f32_cut(arch):
    """The float32 config of a ``zoo_f32_card_cpu`` arch, cut so the CPU can
    follow (vocab 4096): MoE archs keep experts, top-k, dispatch group and
    heads (2 layers, d_model 1024, d_expert 256); nemotron keeps Dh 192 and
    Gq 12 (24 / 2 heads; 2 layers, d_model 2304, d_ff 4096);
    recurrentgemma keeps Dh 256 and Gq 16 over one (rglru, rglru, attn)
    period (d_model 1024, d_ff 2048); xlstm keeps its width over one
    (mlstm, slstm) period."""
    full = zoo_config(arch)
    cut = dict(num_layers=2, d_model=1024, d_ff=256, vocab_size=4096, dtype="float32",
               head_dim=full.head_dim)
    if full.moe is not None:
        cut["moe"] = dataclasses.replace(full.moe, d_expert=256)
    if arch == "nemotron-4-340b":
        cut.update(d_model=2304, d_ff=4096, num_heads=24, num_kv_heads=2)
    if arch == "recurrentgemma-9b":
        cut.update(num_layers=len(full.block_pattern), d_ff=2048)
    if arch == "xlstm-125m":
        cut.update(d_model=full.d_model, d_ff=0)
    return dataclasses.replace(full, **cut)


def zoo_f32_card_cpu(arch, ctx, n_tok=8):
    """Phase 10, float32, on ``f32_cut(arch)`` (the draft keeps the
    arch's draft head dim): card tokens and accepted counts == the CPU
    plain path's on the same weights, and batched ``generate_batch`` (2
    rows) == single stream. The MoE archs are not held to AR: the
    reference's verify drops over-capacity assignments that a one-token
    decode never drops."""
    from repro_torch.bridge import init_params
    from repro_torch.config import ServeConfig, SSVConfig
    from repro_torch.core import draft as draft_lib, engine as engine_lib
    from repro_torch.optim.adamw import tree_map
    full = zoo_config(arch)
    cfg = f32_cut(arch)
    dcfg = draft_lib.draft_config(cfg, d_model=draft_lib.draft_config(full).head_dim
                                  * max(2, cfg.num_heads // 4))
    gen = torch.Generator()
    gen.manual_seed(11)
    cpu = (init_params(cfg, gen, "cpu"), init_params(dcfg, gen, "cpu"))
    card = tuple(tree_map(lambda t: t.to(DEV), p) for p in cpu)
    prompts = [ctx["corpus"].batch(20 + i, 1, 700)[0] % cfg.vocab_size for i in range(2)]
    serve = ServeConfig(max_new_tokens=n_tok, temperature=0.0, max_context=1024,
                        ssv=SSVConfig(tree_depth=4, tree_width=2, precision_class="Strict"),
                        use_planner=False)
    runs = {}
    for dev, (tp, dp) in (("cpu", cpu), (DEV, card)):
        eng = engine_lib.SSVEngine(tp, cfg, dp, dcfg, serve, device=dev)
        res = [eng.generate(p, n_tok) for p in prompts]
        runs[dev] = [(r.tokens.tolist(), [s.accepted for s in r.steps]) for r in res]
    batch = engine_lib.BatchedSSVEngine(card[0], cfg, card[1], dcfg, serve, device=DEV) \
        .generate_batch(prompts, n_tok)
    got = [r.tokens.tolist() for r in batch.results]
    tag = (f"[10 zoo f32 {cfg.name} ({cfg.num_layers} layers, d {cfg.d_model}, Dh "
           f"{cfg.head_dim}, Gq {cfg.num_heads // cfg.num_kv_heads}, draft Dh {dcfg.head_dim}"
           + (f", E {cfg.moe.num_experts}, K {cfg.moe.top_k}" if cfg.moe else "") + ")]")
    log(f"{tag} card {runs[DEV]}")
    log(f"{tag} cpu  {runs['cpu']}")
    if runs[DEV] != runs["cpu"]:
        fail(f"{cfg.name}: card tokens / accepted counts differ from the CPU plain path's")
    if got != [t for t, _ in runs[DEV]]:
        fail(f"{cfg.name}: batched tokens {got} differ from single-stream tokens")
    log(f"{tag} card == CPU (tokens and accepted counts), batched == single stream")
    return dict(tokens=runs[DEV], batched=got)


def zoo_phase(ctx):
    """Phase 10: serve the zoo one arch at a time (memory freed between),
    then the float32 equalities."""
    out = {}
    for arch in ZOO:
        t0 = time.time()
        out[arch] = serve_zoo(arch, ctx)
        log(f"[10 zoo] {arch} in {time.time() - t0:.1f}s")
    for arch, layers in ZOO_F32_AR.items():
        strict_equals_ar(zoo_config(arch), layers, 16, ctx, prompt_len=1025, tag="10")
        free()
    for arch in ZOO_MOE + ZOO_F32_CPU:
        out[f"{arch} f32"] = zoo_f32_card_cpu(arch, ctx)
        free()
    return out


# ---------------------------------------------------------------- 9. training
# The head-dim-64 pair trained on the card (benchmarks/common.py's data; a
# target the kernels take: reduced ssv-nsa-1b, d 256, 4 heads of 64; a
# 1-layer draft of d 128, 2 heads of 64), trained in rounds until the
# target has learned the corpus past its unigram statistics and a greedy
# serve of the held-out prompt accepts draft tokens in float32 and bf16.
# ---------------------------------------------------------------- 11. cells
# Cells of the dry run's matrix served from full caches (``python -m
# repro_torch.launch.dryrun --run``): the 1B at 32,768 and 524,288 tokens,
# the 8B at 32,768 (its cache at 524,288 tokens alone is 73 GB)
CELLS = (("ssv-nsa-1b", "decode_32k"), ("ssv-nsa-1b", "long_500k"),
         ("ssv-nsa-8b", "decode_32k"))
LOGITS_TOL = 3e-2          # the bf16 tolerance of tests/test_kernels_nsa_verify.py


def cells_phase(ctx, out_dir, max_err):
    """Phase 11: ``dryrun.run_cell(..., run=True)`` for each of ``CELLS``
    (its steps counted with every counter at 0 before it), then on the
    measured cell ``cell_checks``. Returns ({cell: record}, kernel rows)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import nsa as nsa_lib
    out, rows = {}, []
    for arch, shape in CELLS:
        for c in ctx["counters"]:
            c.reset()
        def inspect(cell, rec, outputs):
            keep_decode_ref(ctx, cell, outputs["decode_step"])
            return cell_checks(cell, rec, outputs, ctx, max_err, rows)
        rec = dryrun.run_cell(arch, shape, out_dir, force=True, run=True, inspect=inspect)
        nsa_lib.overlap_matrix.cache_clear()          # the plain routing's (NCB, NSB) matrix
        nsa_lib._overlap_tensor.cache_clear()
        free()
        rec["checks"]["f32_strict_vs_decode_max_abs_err"] = strict_root_equals_decode(
            arch, shape, ctx)
        r = rec["roofline"]
        log(f"[11 cell {arch} {shape}] {ctx['kind']} ({ctx['card']}): built in "
            f"{rec['build_s']:.1f}s; " + "; ".join(
                f"{k} {v['wall_ms']:.2f} ms wall, {v['device_busy_ms']:.2f} ms busy"
                for k, v in rec["steps"].items()) +
            f"; peak {rec['peak_bytes'] / 2 ** 30:.2f} GiB of "
            f"{rec['capacity_bytes'] / 2 ** 30:.2f}; Roofline row {json.dumps(r)}; decode "
            f"bound {rec['decode_bound_ms']:.4f} ms, model-FLOPs share of the decode "
            f"{100 * rec['decode_model_flops_share']:.4f}%")
        for k, v in rec["steps"].items():
            log(f"    {k}: {v['device_kernels']} device kernels; top " + "; ".join(
                f"{t['ms']:.3f} ms x{t['launches']} {t['name'][:48]}" for t in v["top"][:4]))
        out[f"{arch} {shape}"] = rec
    return out, rows


def strict_root_equals_decode(arch, shape, ctx):
    """The cell built again in float32 (same seed and construction, both
    caches full): a Strict verify's root logits equal ``decode_step``'s at
    the same cache within LOGITS_TOL. Both verify the root alone over the
    committed prefix (one-node semantics, ``models/model.py:decode_step``);
    float32 keeps the comparison free of the bf16 rounding that a 31-row and
    a 1-row pass through the same layers round differently. Returns the
    max abs error."""
    from repro_torch.launch import dryrun
    tag = f"[11 cell {arch} {shape}]"
    t0 = time.time()
    cell = dryrun.FullCell(arch, shape, seed=0, dtype="float32")
    strict = cell.verify(dryrun.strict_ssv())[0][:, :1]
    dec = cell.decode()
    torch.cuda.synchronize()
    keep_decode_ref(ctx, cell, dec)
    err = float((strict - dec).abs().max())
    ok = bool(torch.isfinite(strict).all()) and torch.allclose(strict, dec, rtol=LOGITS_TOL,
                                                               atol=LOGITS_TOL)
    same_top = bool(torch.equal(strict.argmax(-1), dec.argmax(-1)))
    del cell, strict, dec
    free()
    if not ok:
        fail(f"{tag} float32: Strict root logits differ from decode_step's: max abs err "
             f"{err:.3e}")
    log(f"  {tag} float32: Strict root logits == decode_step logits: max abs err {err:.3e} "
        f"(rtol = atol = {LOGITS_TOL}), argmax {'equal' if same_top else 'differs'} "
        f"({time.time() - t0:.1f}s)")
    return err


def keep_decode_ref(ctx, cell, logits):
    """Keep a cell's first ``decode_step`` (its logits and each layer's K/V
    row at the cell's length, on the host) for phase 12's cells."""
    key = (cell.arch, cell.shape.name, cell.cfg.dtype)
    if key not in {(a, s, d) for _, _, _, a, s, d in SHARDED}:
        return
    p = cell.shape.seq_len
    ctx.setdefault("decode_refs", {})[key] = (
        logits.float().cpu(), [(c["kv"]["k"][0, p].float().cpu(), c["kv"]["v"][0, p].float().cpu())
                               for c in cell.caches["layers"]])


# Phase 12: (part, world, backend, arch, shape, dtype). Four ranks share the
# one card over gloo with CUDA tensors (NCCL takes one card per rank). The
# float32 runs hold the logits and every layer's row; in bf16 the deeper
# rows and the logits round apart after the plain and the kernel attention
# (the bf16 sharded decode is phase 14(b)'s and (d)'s; a bf16 run at 524K
# here made room for phase 14(c) and (d)).
SHARDED = (("a", 1, "nccl", "ssv-nsa-1b", "decode_32k", "float32"),
           ("b", 4, "gloo", "ssv-nsa-1b", "decode_32k", "float32"),
           ("b", 4, "gloo", "ssv-nsa-1b", "long_500k", "float32"))


def sharded_phase(ctx, out_dir):
    """Phase 12: ``dryrun.run_sharded`` (``decode_step_sharded`` across
    spawned ranks, each filling only its slice of the cache) for each of
    ``SHARDED``, held against phase 11's ``decode_step`` on the same fill:
    float32 logits within TOL["float32"], the same argmax and written K/V
    rows (layer 0 bitwise, every layer within the float32 tolerance); bf16
    the same argmax and layer 0's row bitwise (the row that depends on the
    token alone), the largest logit and row differences printed (the
    float32 run of the same cell holds the rest). Every rank's logits are
    equal.
    Returns the records."""
    from repro_torch.launch import dryrun, specs
    out = {}
    for part, world, backend, arch, shape, dtype in SHARDED:
        tag = f"[12{part} {arch} {shape} {dtype} world {world} {backend}]"
        t0 = time.time()
        run_dir = out_dir / f"{arch}__{shape}__{dtype}__{world}{backend}"
        cfg = dataclasses.replace(specs.cell_config(arch, shape)[0], dtype=dtype)
        recs = dryrun.run_sharded(arch, shape, world, backend, run_dir, seed=0, cfg=cfg,
                                  timeout=400)
        wall = time.time() - t0
        got = [torch.load(run_dir / f"rank{r}.pt") for r in range(world)]
        logits = got[0]["logits"]
        if not all(torch.equal(g["logits"], logits) for g in got):
            fail(f"{tag} the ranks' logits differ")
        if not torch.isfinite(logits).all():
            fail(f"{tag} logits are not finite")
        ref_logits, ref_rows = ctx["decode_refs"][(arch, shape, dtype)]
        rows = next(g["written"] for g in got if g["written"] is not None)
        err = float((logits - ref_logits).abs().max())
        same_top = bool(torch.equal(logits.argmax(-1), ref_logits.argmax(-1)))
        row_err = max(float((a - b).abs().max()) for r, q in zip(rows, ref_rows)
                      for a, b in zip(r, q))
        row0 = all(torch.equal(a, b) for a, b in zip(rows[0], ref_rows[0]))
        f32 = dtype == "float32"
        rtol, atol = TOL["float32"]
        rows_ok = not f32 or all(torch.allclose(a, b, rtol=rtol, atol=atol)
                                 for r, q in zip(rows, ref_rows) for a, b in zip(r, q))
        if f32 and not torch.allclose(logits, ref_logits, rtol=rtol, atol=atol):
            fail(f"{tag} logits differ from decode_step's: max abs err {err:.3e}")
        if not same_top:
            fail(f"{tag} argmax differs from decode_step's (max abs logit err {err:.3e})")
        if not row0 or not rows_ok:
            fail(f"{tag} written K/V rows differ from decode_step's: layer 0 bitwise {row0}, "
                 f"max abs err {row_err:.3e}")
        log(f"  {tag} {ctx['kind']} ({ctx['card']}): logits vs decode_step max abs err "
            f"{err:.3e}, argmax equal, written K/V row of layer 0 bitwise equal, every "
            f"layer's max abs err {row_err:.3e}" + ("" if f32 else " (observed, not held: in "
            "bf16 a layer's input rounds apart after the plain and the kernel attention; the "
            "float32 run of this cell holds every row)") +
            f"; {wall:.1f}s with the ranks' start and fill")
        for r in recs:
            log(f"    rank {r['rank']} {r['device']} rows {r['rows']}: built in "
                f"{r['build_s']:.1f}s; first token {r['first_wall_ms']:.2f} ms; wall per token "
                + ", ".join(f"{w:.2f}" for w in r["wall_ms"]) +
                f" ms; busy {r['device_busy_ms']:.3f} ms in {r['device_kernels']} device "
                f"kernels ({r['collective_ms']:.3f} ms of it in NCCL kernels); "
                f"{r['collectives_per_token']} collectives per token; peak "
                f"{r['peak_bytes'] / 2 ** 30:.2f} GiB")
        out[f"{part} {arch} {shape} {dtype} world {world} {backend}"] = {
            "ranks": recs, "max_abs_err": err, "row_max_abs_err": row_err, "seconds": wall}
        free()
    return out


# Phase 13 (a): full-width ssv-nsa-1b cut to TRAIN_RANKS_LAYERS layers in
# float32 on four gloo ranks sharing the card, 4 x 2049 tokens (two
# micro-batches of 2 x 2049 cut over 2 data ranks: with 2 x 2049 a
# micro-batch's one row does not divide, which the port refuses where GSPMD
# would pad); (b): the whole model in bf16 on one NCCL rank, at phase 9's
# 1 x 4096 tokens.
TRAIN_RANKS_LAYERS, TRAIN_RANKS_TOKENS = 2, (4, 2049)


def rounding_flips_between(a, b, scales):
    """The int8 rounding flips between two residual trees of a whole state
    (``scales``: ``a``'s, in leaf order), counted as ``train_checks`` counts
    them: {"flips", "expected" (the sum of |du|), "elements"}."""
    from repro_torch.launch.train_checks import rounding_steps
    out = {"flips": 0, "expected": 0.0, "elements": 0}
    for x, y, s in zip(leaves_of(a), leaves_of(b), scales):
        k, e = rounding_steps((x.to(DEV).float() - y.to(DEV).float()) / s)
        out["flips"] += int((k != 0).sum())
        out["expected"] += e
        out["elements"] += k.numel()
    return out


def train_ranks_phase(ctx, out_dir, phase9=None):
    """Phase 13 (see the module docstring). ``phase9``: phase 9's numbers of
    the full-width 1B target (its step ms and peak are printed beside
    13(b)'s). Returns the records."""
    from repro_torch import configs
    from repro_torch.ckpt import restore
    from repro_torch.config import TrainConfig
    from repro_torch.launch import train_checks
    from repro_torch.optim import tree_map
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    note = f"{ctx['kind']} ({ctx['card']})"
    base = configs.get_config("ssv-nsa-1b")
    out = {}

    # ---- (a) four gloo ranks on one card, float32
    cfg = dataclasses.replace(base, num_layers=TRAIN_RANKS_LAYERS, dtype="float32")
    case = {"seed": 0, "batch": TRAIN_RANKS_TOKENS[0], "seq": TRAIN_RANKS_TOKENS[1]}
    whole = train_checks.load_case(case, cfg, torch.device(DEV))   # each rank draws the same
    tcfgs = {"plain": TrainConfig(steps=1, learning_rate=1e-3),
             "int8_ef, 2 micro-batches": TrainConfig(steps=1, learning_rate=1e-3,
                                                     grad_compression="int8_ef",
                                                     micro_batches=2)}
    ck = out_dir / "ck_a"
    jobs = []
    for i, (name, tcfg) in enumerate(tcfgs.items()):
        t0 = time.time()
        ref = train_checks.single_device_reference(cfg, tcfg, whole["params"], whole["tokens"])
        torch.save(ref, out_dir / f"ref_a{i}.pt")
        log(f"  [13a single device {name}] {note}: loss {ref['loss']:.6f}, grad norm "
            f"{ref['grad_norm']:.5f}, step {ref['wall_ms']:.1f} ms, peak "
            f"{ref.get('peak_gib', math.nan):.2f} GiB; {time.time() - t0:.1f}s with its file")
        jobs.append(dict(kind="step", name=name, cfg=cfg, tcfg=tcfg,
                         mesh=((2, 2), ("data", "model")), case=case,
                         refs={"single device": str(out_dir / f"ref_a{i}.pt")},
                         tol=(2e-4, 2e-5, 1e-5), save=str(ck) if i == 0 else None))
        if tcfg.grad_compression == "int8_ef":
            # the same int8 step over 4 micro-batches: one device, another
            # order of the float32 sums, no collective
            other = train_checks.single_device_reference(
                cfg, dataclasses.replace(tcfg, micro_batches=4), whole["params"],
                whole["tokens"])
            out["flips between single-device steps"] = flips = rounding_flips_between(
                ref["residual"], other["residual"], ref["scales"])
            log(f"  [13a single device {name} against 4 micro-batches] {note}: int8 rounding "
                f"flips {flips['flips']} of {flips['elements']} elements "
                f"({flips['flips'] / flips['elements']:.2e}), expected "
                f"{flips['expected']:.1f} from the residuals")
            del other
        del ref
    del whole
    free()
    t0 = time.time()
    ranks_a = train_checks.run_checks(jobs, 4, "gloo", out_dir / "a", timeout=400)
    out["a"] = {"ranks": ranks_a, "seconds": time.time() - t0}
    log(f"  [13a] 4 ranks: {out['a']['seconds']:.1f}s with their start; the checkpoint "
        f"{max(r['jobs'][0]['save_s'] for r in ranks_a):.1f}s")
    for j, job in enumerate(jobs):
        got = [r["jobs"][j] for r in ranks_a]
        tag = f"[13a {cfg.name} x{cfg.num_layers} f32, {job['name']}, (2, 2) over 4 gloo ranks]"
        if len({g["loss"] for g in got}) != 1 or len({g["grad_norm"] for g in got}) != 1:
            fail(f"{tag} the ranks' loss or grad norm differ: {[g['loss'] for g in got]}")
        spans = [g["positions"] for g in got]
        if any(p is None or p[1] - p[0] >= p[2] for p in spans) or not got[0]["activations"]:
            fail(f"{tag} the ranks did not split the positions over model: {spans}, "
                 f"{got[0]['activations']} activation collectives")
        bad = [g["refs"]["single device"] for g in got if not g["refs"]["single device"]["ok"]]
        if bad:
            fail(f"{tag} differs from the single-device step: {bad[0]}")
        ref = got[0]["refs"]["single device"]
        log(f"  {tag} {note}: loss {got[0]['loss']:.6f} (rel err {ref['loss_rel_err']:.2e}), "
            f"grad norm rel err {ref['grad_norm_rel_err']:.2e}; max abs err over the ranks " +
            ", ".join(f"{k} {max(g['refs']['single device']['max_abs_err'][k] for g in got):.3e}"
                      for k in ref["max_abs_err"]) +
            (f"; int8 rounding flips {[g['refs']['single device']['rounding_flips'] for g in got]}"
             f" of {ref['elements']} elements a rank ({ref['rounding_flips'] / ref['elements']:.2e}"
             f" on rank 0), expected "
             f"{[round(g['refs']['single device']['flips_expected'], 1) for g in got]}"
             if "rounding_flips" in ref else "") +
            f"; params held to a moved update (a flip's or an ill-conditioned AdamW one's) "
            f"{[g['refs']['single device']['moved'] for g in got]}, off the single device's "
            f"tolerance {[g['refs']['single device']['moved_off_reference'] for g in got]}, by up "
            f"to {max(g['refs']['single device']['moved_abs_err'] for g in got):.3e}"
            f": equal within rtol 2e-4 / atol 2e-5 (loss 1e-5); positions a rank "
            f"{[f'{p[0]}-{p[1]} ({p[1] - p[0]} of {p[2]})' for p in spans]} a row; "
            f"{got[0]['gathers']} gathers and "
            f"{got[0]['reductions']} reductions a step ({got[0]['bytes'] / 1e9:.3f} GB through "
            f"them a rank), {got[0]['activations']} activation collectives along model "
            f"({got[0]['activation_bytes'] / 1e9:.3f} GB); step wall {[round(g['wall_ms'], 1) for g in got]} ms; peak "
            f"{[round(g.get('peak_gib', math.nan), 2) for g in got]} GiB; resident "
            f"{[round(g['resident_bytes'] / 2 ** 30, 3) for g in got]} GiB a rank")
    # the plain step's checkpoint onto (2, 1) and onto one device, side by
    # side (both load on the host), beside (b)'s start, its first step and
    # its single-device step: (b)'s timed step waits for the restores
    t0 = time.time()
    rjob = dict(kind="restore", name="(2, 2) checkpoint on (2, 1)", cfg=cfg, tcfg=tcfgs["plain"],
                mesh=((2, 1), ("data", "model")), dir=str(ck), whole=str(ck / "whole.pt"))
    restored = out_dir / "restored"
    job_b = dict(kind="step", name="ssv-nsa-1b bf16", cfg=base,
                 tcfg=TrainConfig(steps=3, learning_rate=3e-4, warmup_steps=1),
                 mesh=((1, 1), ("data", "model")), case={"seed": 0, "batch": 1, "seq": 4096},
                 refs={}, single_ref=True, tol=(3e-2, 3e-2, 3e-2), timed=1,
                 timed_after=str(restored))

    def one_device():
        t1 = time.time()
        template = tree_map(lambda t: t.to(DEV), torch.load(ck / "whole.pt", weights_only=False))
        step, back = restore(str(ck), template, cfg)
        same = step == 1 and all(a.dtype == b.dtype and b.device == a.device and torch.equal(a, b)
                                 for a, b in zip(leaves_of(template), leaves_of(back)))
        return same, time.time() - t1

    def world_b():
        t1 = time.time()
        return train_checks.run_checks([job_b], 1, "nccl", out_dir / "b", timeout=400), \
            time.time() - t1

    with ThreadPoolExecutor(2) as pool:
        second = pool.submit(world_b)
        try:
            first = pool.submit(one_device)
            ranks_r = train_checks.run_checks([rjob], 2, "gloo", out_dir / "a21", timeout=300)
            one, t1 = first.result()
        finally:
            restored.touch()                # (b) times its step alone on the card
        ranks_b, t_b = second.result()
    two = all(r["jobs"][0]["bitwise"] and r["jobs"][0]["step"] == 1 for r in ranks_r)
    out["restore"] = {"ranks": ranks_r, "one_device": one}
    log(f"  [13a checkpoint from (2, 2)] onto (2, 1) over 2 gloo ranks: "
        f"{'bitwise equal' if two else 'DIFFERENT'} ({ranks_r[0]['jobs'][0]['leaves']} leaves a "
        f"rank; restore {max(r['jobs'][0]['restore_s'] for r in ranks_r):.1f}s, held "
        f"{max(r['jobs'][0]['held_s'] for r in ranks_r):.1f}s); onto one device: "
        f"{'bitwise equal' if one else 'DIFFERENT'} ({t1:.1f}s)")
    if not (one and two):
        fail("[13a] the checkpoint saved from the (2, 2) world does not restore bitwise")
    g = ranks_b[0]["jobs"][0]
    ref = g["refs"]["single device"]
    out["b"] = {"ranks": ranks_b, "seconds": t_b}
    p9 = (f"phase 9: {phase9['median_step_ms']:.1f} ms a step (median after the first), "
          f"peak {phase9['peak_gib']:.2f} GiB" if phase9 else "phase 9 did not run")
    log(f"  [13b {base.name} bf16, (1, 1) over 1 NCCL rank] {note}: loss "
        f"{g['loss']:.6f} (single device rel err {ref['loss_rel_err']:.2e}), grad norm rel err "
        f"{ref['grad_norm_rel_err']:.2e}; largest differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in ref["max_abs_err"].items()) +
        f" (held within 3e-2); sharded step {g['wall_ms']:.1f} ms first and single-device "
        f"step {g['single_wall_ms']:.1f} ms (the restores may run beside both), then "
        f"{[round(w, 1) for w in g['timed_wall_ms']]} ms after the restores, alone on the "
        f"card; peak {g.get('peak_gib', math.nan):.2f} GiB sharded, "
        f"{g.get('single_peak_gib') or math.nan:.2f} GiB single device; "
        f"{p9}; {g['gathers']} "
        f"gathers, {g['reductions']} reductions; {t_b:.1f}s with the rank's start")
    if not ref["ok"]:
        fail(f"[13b] the sharded bf16 step differs from the single-device step: {ref}")
    log(f"  [13 restores and (b)] {time.time() - t0:.1f}s")
    shutil.rmtree(ck)
    for f in out_dir.glob("ref_a*.pt"):
        f.unlink()
    free()
    out["c"] = train_ranks_recurrent(ctx, out_dir)
    return out


# Phase 13 (c): the recurrent mixers' state carries in the split step. Two
# gloo ranks share the card on (data 1, model 2), one row of 1,025 tokens
# (513 and 512 positions a rank), float32, one period of each recurrent
# arch at full width: xlstm-125m (mlstm, slstm) and recurrentgemma-9b
# (rglru, rglru, attn) with its vocabulary cut to 32,768 (its float32
# period with the whole 256,000-row embedding and head and their moments
# does not fit beside its single-device reference).
TRAIN_RECURRENT = {"xlstm-125m": dict(layers=2),
                   "recurrentgemma-9b": dict(layers=3, vocab_size=32768)}
TRAIN_RECURRENT_TOKENS = (1, 1025)


def train_ranks_recurrent(ctx, out_dir):
    """Phase 13 (c) (see the module docstring): each arch's single-device
    step on the card first (its file on the host), then both split steps in
    one world of two gloo ranks. Returns the records."""
    from repro_torch import configs
    from repro_torch.config import TrainConfig
    from repro_torch.launch import train_checks
    from repro_torch.models import train_sharded
    note = f"{ctx['kind']} ({ctx['card']})"
    tcfg = TrainConfig(steps=1, learning_rate=1e-3)
    B, S = TRAIN_RECURRENT_TOKENS
    jobs, cfgs, t0 = [], [], time.time()
    for i, (arch, cut) in enumerate(TRAIN_RECURRENT.items()):
        cfg = dataclasses.replace(configs.get_config(arch), name=f"{arch}-x{cut['layers']}",
                                  num_layers=cut["layers"], dtype="float32",
                                  **{k: v for k, v in cut.items() if k != "layers"})
        case = {"seed": 30 + i, "batch": B, "seq": S}
        whole = train_checks.load_case(case, cfg, torch.device(DEV))
        ref = train_checks.single_device_reference(cfg, tcfg, whole["params"], whole["tokens"])
        torch.save(ref, out_dir / f"ref_c{i}.pt")
        log(f"  [13c single device {cfg.name} f32, vocab {cfg.vocab_size}] {note}: loss "
            f"{ref['loss']:.6f}, grad norm {ref['grad_norm']:.5f}, step {ref['wall_ms']:.1f} ms, "
            f"peak {ref.get('peak_gib', math.nan):.2f} GiB")
        del whole, ref
        free()
        cfgs.append(cfg)
        jobs.append(dict(kind="step", name=cfg.name, cfg=cfg, tcfg=tcfg,
                         mesh=((1, 2), ("data", "model")), case=case,
                         refs={"single device": str(out_dir / f"ref_c{i}.pt")},
                         tol=(2e-4, 2e-5, 1e-5)))
    t1 = time.time()
    ranks_c = train_checks.run_checks(jobs, 2, "gloo", out_dir / "c", timeout=400)
    out = {"ranks": ranks_c, "seconds": time.time() - t0, "ranks_seconds": time.time() - t1}
    for j, (job, cfg) in enumerate(zip(jobs, cfgs)):
        got = [r["jobs"][j] for r in ranks_c]
        tag = f"[13c {cfg.name} f32, (1, 2) over 2 gloo ranks]"
        if len({g["loss"] for g in got}) != 1:
            fail(f"{tag} the ranks' losses differ: {[g['loss'] for g in got]}")
        spans = [tuple(g["positions"]) for g in got]
        if spans != [(0, 513, S), (513, S, S)]:
            fail(f"{tag} the ranks did not split the positions over model: {spans}")
        want = train_sharded.carry_collectives(cfg, 2, B)
        have = [(g["activation_kinds"]["recurrent"]["count"],
                 g["activation_kinds"]["recurrent"]["bytes"]) for g in got]
        if any(h != want for h in have):
            fail(f"{tag} the recurrent layers' activation collectives {have} are not {want}")
        bad = [g["refs"]["single device"] for g in got if not g["refs"]["single device"]["ok"]]
        if bad:
            fail(f"{tag} differs from the single-device step: {bad[0]}")
        ref = got[0]["refs"]["single device"]
        relay = got[0]["relay_steps"]
        idle = (f"; sLSTM relay idle in {relay['idle']} of {relay['busy'] + relay['idle']} "
                f"lockstep steps a rank ({relay['idle'] / (relay['busy'] + relay['idle']):.3f})"
                if relay["busy"] else "")
        log(f"  {tag} {note}: loss {got[0]['loss']:.6f} (rel err {ref['loss_rel_err']:.2e}), "
            f"grad norm rel err {ref['grad_norm_rel_err']:.2e}; max abs err over the ranks "
            + ", ".join(f"{k} {max(g['refs']['single device']['max_abs_err'][k] for g in got):.3e}"
                        for k in ref["max_abs_err"]) +
            f"; params held to an ill-conditioned AdamW update "
            f"{[g['refs']['single device']['moved'] for g in got]}, off the single device's "
            f"tolerance {[g['refs']['single device']['moved_off_reference'] for g in got]}"
            f": equal within rtol 2e-4 / atol 2e-5 (loss 1e-5); positions a rank "
            f"{[f'{p[0]}-{p[1]} ({p[1] - p[0]} of {p[2]})' for p in spans]}; activation "
            f"collectives along model a rank " + "; ".join(
                ", ".join(f"{k} {v['count']} ({v['bytes'] / 1e6:.3f} MB)"
                          for k, v in sorted(g["activation_kinds"].items())) for g in got)
            + f" (recurrent exactly {want[0]}, {want[1] / 1e6:.3f} MB; the stream's gather "
            f"moved {B * -(-S // 2) * 2 * cfg.d_model * 4 / 1e6:.3f} MB a recurrent layer and "
            f"pass){idle}; {got[0]['gathers']} weight gathers, {got[0]['reductions']} "
            f"reductions; step wall {[round(g['wall_ms'], 1) for g in got]} ms; peak "
            f"{[round(g.get('peak_gib', math.nan), 2) for g in got]} GiB a rank")
    for f in out_dir.glob("ref_c*.pt"):
        f.unlink()
    log(f"  [13c] {out['seconds']:.1f}s, the ranks {out['ranks_seconds']:.1f}s with their start")
    free()
    return out


# Phase 14 (c) and (d): the native-attention archs across four gloo ranks
# sharing the card on (data 2, model 2), each at full width with its depth
# cut ((c) to 1 layer to make room for (e): at 2 its per-token weight
# gathers through gloo took ~3.3 s). (c): pixtral-12b, dense attention
# behind a frontend, in float32 (held to the float32 tolerance against the
# flash kernel's route); (d): mixtral-
# 8x22b, sliding-window attention and MoE, in bf16 (held within 3e-2 of the
# single device's prefill and of its decode on the flash kernel's plain
# version, argmax equal to the kernel's route). max_len 8208 puts (d)'s model
# boundary at row 4104, inside every decode token's 4096-key window.
# (e): the recurrent archs in float32, their states passed along the model
# ranks (the prompt's cut at position 2048): recurrentgemma-9b at one whole
# (rglru, rglru, attn) period, whose max_len 6160 puts the cache's model
# boundary at row 3080, inside every decode token's 2048-key window
# (positions 4096-4099; at 8208 the boundary at 4104 would lie past them);
# xlstm-125m at one (mlstm, slstm) period. Each serves 4 decode tokens (12,
# 8 and 8 until phase 13(c) joined; a gloo token costs 2.4-6.6 s of weight
# gathers through the host, and every check holds at 4).
NATIVE_RANKS = {
    "c": dict(arch="pixtral-12b", layers=1, dtype="float32", rows=2, frames=256, seq=4096,
              max_len=4864, decode=4),
    "d": dict(arch="mixtral-8x22b", layers=1, dtype="bfloat16", rows=4, frames=0, seq=6144,
              max_len=8208, decode=4),
    "e-rg": dict(arch="recurrentgemma-9b", layers=3, dtype="float32", rows=2, frames=0,
                 seq=4096, max_len=6160, decode=4),
    "e-xl": dict(arch="xlstm-125m", layers=2, dtype="float32", rows=2, frames=0, seq=4096,
                 max_len=6160, decode=4)}
BF16_SERVE_TOL = (3e-2, 3e-2)


def serve_report(tag, got, whole, ref, tie_tol=None, job=0, kv=True):
    """Prints each rank's errors, walls, collectives, gathers and peak for a
    ``serve_checks`` job; fails unless every rank held and the assembled
    prefill and decode argmax equal ``ref``'s (the kernels' route). With
    ``tie_tol`` (rtol, atol; a bf16 job) a position whose argmax differs
    passes when ``ref``'s logit there is within that tolerance of its
    maximum (the two tokens tie at the precision the logits are held to);
    each such position and its margin is printed. ``job``: the job's index
    in the ranks' records; ``kv``: whether the stack has K/V (its rows are
    printed). Returns the argmax verdicts."""
    same = {}
    for k, w in (("prefill", "prefill_logits"), ("decode", "decode_logits")):
        got_top, want = whole[k].argmax(-1), ref[w].float().cpu()
        same[k] = bool(torch.equal(got_top, want.argmax(-1)))
        if same[k] or tie_tol is None:
            continue
        top = want.max(-1).values
        at = want.gather(-1, got_top[..., None])[..., 0]
        margin = top - at
        flips = (got_top != want.argmax(-1)).nonzero().tolist()
        ties = bool((margin <= tie_tol[1] + tie_tol[0] * top.abs()).all())
        log(f"  {tag} {k}: argmax differs at {len(flips)} of {got_top.numel()} positions "
            f"{flips[:8]}, the kernels' route's logit there below its maximum by "
            f"{[round(float(margin[tuple(f)]), 5) for f in flips[:8]]}"
            + (" (ties within the held tolerance)" if ties else ""))
        same[k] = ties
    for g in got:
        j = g["jobs"][job]
        log(f"  {tag} rank {g['rank']} coords {j['coords']} rows {j['rows']} "
            + (f"K/V rows {j['kv_rows']} " if kv else "") + f"vocab {j['vocab']}: max abs err " +
            ", ".join(f"{k} {v:.3e}" for k, v in j["max_abs_err"].items()) +
            f"; prefill {j['prefill']['wall_ms']:.1f} ms, {j['prefill']['collectives']} "
            f"activation collectives, {j['prefill']['gathers']} gathers "
            f"({j['prefill']['gathered_bytes'] / 1e9:.3f} GB); decode wall per token "
            f"{[round(w, 1) for w in j['decode']['wall_ms']]} ms, "
            f"{j['decode']['collectives_per_token']} collectives and "
            f"{j['decode']['gathers_per_token']} gathers "
            f"({j['decode']['gathered_bytes_per_token'][0] / 1e9:.3f} GB) per token; "
            f"compressed blocks written {j['written_blocks']} (across the model boundary "
            f"{j['across_boundary']}); peak {j.get('peak_gib', math.nan):.2f} GiB (drawing "
            f"the whole params {j.get('load_peak_gib', math.nan):.2f} GiB, after waiting "
            f"{j['waited_s']:.1f} s); weights resident "
            f"{j['resident_weight_bytes'] / 2 ** 30:.3f} GiB")
    bad = [g["jobs"][job]["held"] for g in got if not g["jobs"][job]["ok"]]
    if bad or not all(same.values()):
        fail(f"{tag} differs from the single device: held {bad}, argmax equal {same}")
    return same


def native_job(out_dir, name):
    """Phase 14 (c), (d) or (e) (``NATIVE_RANKS[name]``) up to its ranks: the
    single device's reference on the card, saved for them. Returns (the
    job, the reference, its seconds)."""
    from repro_torch import configs
    from repro_torch.launch import serve_checks
    c = NATIVE_RANKS[name]
    t0 = time.time()
    base = configs.get_config(c["arch"])
    cfg = dataclasses.replace(base, num_layers=c["layers"], dtype=c["dtype"],
                              name=f"{base.name}-x{c['layers']}")
    bf16 = c["dtype"] == "bfloat16"
    case = {"seed": 0, "batch": c["rows"], "seq": c["seq"], "decode": c["decode"],
            "frames": c["frames"]}
    whole = serve_checks.load_case(case, cfg, torch.device(DEV))
    ref = serve_checks.reference(whole["params"], cfg, whole["tokens"], whole["decode"],
                                 c["max_len"], plain_decode=bf16, frontend=whole.get("frontend"))
    del whole
    free()
    torch.save(ref, out_dir / f"ref_{name}.pt")
    tol, hold = (BF16_SERVE_TOL, ("prefill_logits", "prefill_caches", "plain_decode_logits",
                                  "plain_caches")) if bf16 else (TOL["float32"], None)
    job = dict(name=name, cfg=cfg, mesh=((2, 2), ("data", "model")), case=case,
               max_len=c["max_len"], ref=str(out_dir / f"ref_{name}.pt"), tol=tol,
               out=str(out_dir / "logits"), **({"hold": hold} if hold else {}))
    return job, ref, time.time() - t0


def native_report(ctx, out_dir, name, got, job, ref, t_ref):
    """Phase 14 (c), (d) or (e) after its ranks: the report, the checks of
    the cases it guards (a recurrent arch's collectives exact). Returns the
    record."""
    from repro_torch.launch import serve_checks
    c = NATIVE_RANKS[name]
    i = list(NATIVE_RANKS).index(name) + 1        # (a) is the world's first job
    cfg = job["cfg"]
    bf16 = c["dtype"] == "bfloat16"
    frames = f"{c['frames']} frames + " if c["frames"] else ""
    tag = (f"[14{name} {cfg.name} {c['dtype']}, {c['rows']} x {frames}{c['seq']} tokens + "
           f"{c['decode']} decode, (2, 2) over 4 gloo ranks]")
    whole = serve_checks.assemble(out_dir / "logits", name, 4)
    kinds = cfg.layer_kinds()
    recurrent = [k for k in kinds if k in ("rglru", "mlstm", "slstm")]
    kv = len(recurrent) < len(kinds)
    same = serve_report(tag, got, whole, ref, BF16_SERVE_TOL if bf16 else None, job=i, kv=kv)
    route = " through the flash kernel" if kv else ""
    slices = " and ".join(["K/V slices"] * kv + ["states"] * bool(recurrent))
    what = (f"the prefill within 3e-2 of the single device's, the {c['decode']} decode "
            "tokens within 3e-2 of its decode_step on the flash kernel's plain version "
            "(logits and caches)" if bf16 else
            f"equal to model.prefill + {c['decode']} decode_steps{route} within rtol 2e-4 / "
            f"atol 2e-5 (logits and every rank's {slices})")
    rec = {"ranks": [g["jobs"][i] for g in got], "single_prefill_ms": ref["prefill_ms"],
           "single_decode_ms": ref["decode_ms"], "reference_s": t_ref}
    if cfg.attention == "swa":
        b, p0 = c["max_len"] // 2, c["frames"] + c["seq"]
        if not all(p - cfg.window + 1 < b <= p for p in range(p0, p0 + c["decode"])):
            fail(f"{tag} a decode token's window does not straddle the model boundary at {b}")
        what += f"; every decode token's {cfg.window}-key window straddles row {b}"
    if recurrent:
        # one all-gather an RG-LRU / mLSTM / attention layer, two an sLSTM's relay
        # on two model ranks, + 2 a prefill; 2 an attention layer a token + 1
        want = (sum(2 if k == "slstm" else 1 for k in kinds) + 2, 2 * kinds.count("attn") + 1)
        counts = {(g["jobs"][i]["prefill"]["collectives"],
                   tuple(g["jobs"][i]["decode"]["collectives_per_token"])) for g in got}
        if counts != {(want[0], (want[1],))}:
            fail(f"{tag} collectives {counts}, not {want} (prefill, a decode token)")
        what += (f"; the {'/'.join(dict.fromkeys(recurrent))} states carried across the "
                 f"model cut at position {c['seq'] // 2}; collectives exact: {want[0]} a "
                 f"prefill, {want[1]} a token")
    if cfg.moe is not None:
        drops = got[0]["jobs"][i]["decode"]["moe_drops"]
        rec["moe_drops"] = drops
        what += (f"; the whole batch's MoE group dropped {drops['whole']} expert assignments "
                 f"over the decode, per-rank groups would have dropped {drops['per_rank']} "
                 f"({drops['whole_only']} only the whole group drops)")
    versus = "the kernels' route" if kv else "the single device"
    log(f"  {tag} {ctx['kind']} ({ctx['card']}): {what}; argmax equal to {versus} "
        f"{same}; single device prefill {ref['prefill_ms']:.1f} ms, decode "
        f"{statistics.median(ref['decode_ms']):.1f} ms a token (median); {t_ref:.1f}s for the "
        "reference")
    return rec


# Phase 14 (a): full-width ssv-nsa-1b cut to SERVE_RANKS_LAYERS layers in
# float32, SERVE_RANKS_ROWS rows of SERVE_RANKS_PROMPT tokens, on four gloo
# ranks sharing the card on (data 2, model 2), then SERVE_RANKS_DECODE
# decode tokens. max_len 8208 puts the model boundary of the K/V rows at
# 4104, inside the decode's positions 4096-4111: block 255 (rows 4080-4111)
# completes at 4111 with rows on both model ranks, and model rank 0 (blocks
# 0-255 of the 512 padded ones) writes it. (b): the whole model in bf16 on
# one NCCL rank, prefill_32k at batch 1, then 2 decode tokens.
SERVE_RANKS_LAYERS, SERVE_RANKS_ROWS, SERVE_RANKS_PROMPT = 2, 2, 4096
SERVE_RANKS_MAX_LEN, SERVE_RANKS_DECODE = 8208, 16


def serve_ranks_phase(ctx, out_dir):
    """Phase 14: the dry run's serve cells across ranks, ``launch.
    serve_checks``' jobs in spawned ranks. (a) four gloo ranks on one card,
    (data 2, model 2), float32: ``prefill_sharded`` == ``model.prefill`` on
    the card (the last position's logits, every rank's K/V rows and
    compressed blocks), then ``SERVE_RANKS_DECODE`` batched
    ``decode_step_sharded`` tokens == as many ``decode_step``s through the
    kernels (each token's logits, the caches after the last, a compressed
    block written across the model boundary), rtol 2e-4 / atol 2e-5,
    argmax equal. (b) beside (a), one NCCL rank on (1, 1), whole
    ssv-nsa-1b in bf16: ``prefill_32k`` at batch 1 == the single-device
    prefill on the same card within 3e-2 (logits and caches), argmax
    equal, then 2 decode tokens == the single device's ``decode_step`` on
    the plain ``nsa_verify_ref`` within 3e-2 and with the argmax of its
    ``decode_step`` through the kernels (the largest differences from it
    printed, per layer too). (c), (d) and (e) (``NATIVE_RANKS``) run in
    (a)'s world after it, their references computed first, once (b) has
    ended. Returns the records."""
    from repro_torch import configs
    from repro_torch.launch import serve_checks, specs
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    note = f"{ctx['kind']} ({ctx['card']})"
    base = configs.get_config("ssv-nsa-1b")
    out = {}

    # ---- (b) one NCCL rank, whole ssv-nsa-1b in bf16 at prefill_32k, batch 1,
    # started beside (a): its passes are device-bound, (a)'s gloo ranks host-bound
    t_all = time.time()
    shape = specs.SHAPE_BY_NAME["prefill_32k"]
    job_b = dict(name="b", cfg=base, mesh=((1, 1), ("data", "model")),
                 case={"seed": 0, "batch": 1, "seq": shape.seq_len, "decode": 2},
                 max_len=shape.seq_len + specs.CACHE_SLACK, single_ref=True, plain_ref=True,
                 tol=(3e-2, 3e-2), hold=("prefill_logits", "prefill_caches",
                                         "plain_decode_logits", "plain_caches"),
                 out=str(out_dir / "logits"))

    def world_b():
        t1 = time.time()
        return serve_checks.run_checks([job_b], 1, "nccl", out_dir / "b", timeout=400), \
            time.time() - t1

    with ThreadPoolExecutor(1) as pool:
        second = pool.submit(world_b)

        # ---- (a), (c), (d) and (e): the single device's references on the card,
        # then one world of four gloo ranks that runs the jobs in turn
        t0 = time.time()
        cfg = dataclasses.replace(base, num_layers=SERVE_RANKS_LAYERS, dtype="float32")
        case = {"seed": 0, "batch": SERVE_RANKS_ROWS, "seq": SERVE_RANKS_PROMPT,
                "decode": SERVE_RANKS_DECODE}
        whole = serve_checks.load_case(case, cfg, torch.device(DEV))
        ref = serve_checks.reference(whole["params"], cfg, whole["tokens"], whole["decode"],
                                     SERVE_RANKS_MAX_LEN)
        del whole
        free()
        torch.save(ref, out_dir / "ref_a.pt")
        t_ref = time.time() - t0
        job = dict(name="a", cfg=cfg, mesh=((2, 2), ("data", "model")), case=case,
                   max_len=SERVE_RANKS_MAX_LEN, ref=str(out_dir / "ref_a.pt"),
                   tol=TOL["float32"], out=str(out_dir / "logits"))
        native = {}
        for name in NATIVE_RANKS:
            t1 = time.time()
            native[name] = native_job(out_dir, name)
            log(f"  [14{name} reference] {time.time() - t1:.1f}s")
        # (c), (d) and (e) start only once (b) has handed its memory back: the card
        # holds (b)'s passes beside (a)'s alone
        b_done = out_dir / "b_done"
        second.add_done_callback(lambda _: b_done.touch())
        for name in NATIVE_RANKS:
            native[name][0]["after"] = str(b_done)
        t1 = time.time()
        got = serve_checks.run_checks([job] + [native[n][0] for n in NATIVE_RANKS], 4,
                                      "gloo", out_dir / "acd", timeout=900)
        t_world = time.time() - t1
        for name in ["a", *NATIVE_RANKS]:
            (out_dir / f"ref_{name}.pt").unlink()
        got_b, t_b = second.result()
    tag = (f"[14a {cfg.name} x{cfg.num_layers} f32, {SERVE_RANKS_ROWS} x {SERVE_RANKS_PROMPT} "
           f"tokens + {SERVE_RANKS_DECODE} decode, (2, 2) over 4 gloo ranks]")
    whole = serve_checks.assemble(out_dir / "logits", "a", 4)
    same = serve_report(tag, got, whole, ref)
    across = sorted({b for g in got for b in g["jobs"][0]["across_boundary"]})
    if not across:
        fail(f"{tag} no compressed block was written across the model boundary")
    log(f"  {tag} {note}: equal to model.prefill + {SERVE_RANKS_DECODE} decode_steps on the "
        f"card within rtol 2e-4 / atol 2e-5 (argmax equal {same}); blocks written across the "
        f"model boundary {across}; single device prefill {ref['prefill_ms']:.1f} ms, decode "
        f"{statistics.median(ref['decode_ms']):.1f} ms a token (median); {t_ref:.1f}s for the "
        f"reference; the world's four ranks ran (a), (c), (d) and (e) in {t_world:.1f}s (14(b) "
        f"beside (a), (c) after waiting {got[0]['jobs'][1]['waited_s']:.1f}s for it)")
    out["a"] = {"ranks": [g["jobs"][0] for g in got], "world_s": t_world}
    del ref, whole
    free()

    tag = f"[14b {base.name} bf16 prefill_32k batch 1 + 2 decode, (1, 1) over 1 NCCL rank]"
    whole = serve_checks.assemble(out_dir / "logits", "b", 1)
    ref = torch.load(out_dir / "logits" / "single_b.pt")
    serve_report(tag, got_b, whole, ref)
    j = got_b[0]["jobs"][0]
    per_layer = {k: [f"{e:.3g}" for e in v] for k, v in j["layer_err"].items()}
    log(f"  {tag} {note}: the prefill (logits, every K/V row and compressed block) equal to "
        f"the single device's within 3e-2, argmax equal; the 2 decode tokens (logits, every "
        f"K/V row and compressed block) equal to the single device's decode_step with its NSA "
        f"layers on the plain nsa_verify_ref within 3e-2; largest differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in j["max_abs_err"].items()) +
        f" (decode_logits and caches against the single device's kernels observed, not held: "
        f"14(a) holds that decode in float32); caches after the decode, max abs err a layer "
        f"{per_layer}; sharded prefill "
        f"{j['prefill']['wall_ms']:.1f} ms against the single device's "
        f"{j['single']['prefill_ms']:.1f} ms, decode {[round(w, 1) for w in j['decode']['wall_ms']]}"
        f" against {[round(w, 1) for w in j['single']['decode_ms']]} ms (beside 14(a)); "
        f"{t_b:.1f}s with the rank's start")
    out["b"] = {"ranks": got_b, "seconds": t_b}
    del ref, whole
    for name, (job, ref, t_ref) in native.items():
        out[name] = native_report(ctx, out_dir, name, got, job, ref, t_ref)
    del native
    free()
    log(f"  [14] {time.time() - t_all:.1f}s")
    return out


def cell_checks(cell, rec, outputs, ctx, max_err, rows):
    """On a measured cell: the launches of its steps, exact (each step ran
    three times: warm, timed, profiled); the bf16 Strict root logits beside
    the first decode's (printed; ``strict_root_equals_decode`` checks the
    equality in float32); layer 0's
    routing, nsa_verify (exact C=2, full and partial fusion) and the draft's
    flash against their plain versions at the cell's inputs, to phase 2's
    tolerances, each timed beside its plain version, its bound and (flash)
    SDPA. Appends the kernel rows to ``rows``."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.kernels.flash import ops as fops, ref as fref
    from repro_torch.kernels.nsa_verify import ops as vops
    from repro_torch.kernels.routing import ops as rops
    from repro_torch.launch import dryrun
    from repro_torch.models import attention as attn_lib, layers, nsa as nsa_lib
    cfg, dcfg, shape = cell.cfg, cell.dcfg, cell.shape.name
    tag = f"[11 cell {cell.arch} {shape}]"
    counts = {c.name: c.count for c in ctx["counters"]}
    steps = {"verify Strict": dryrun.strict_ssv(),
             "verify Approx+Reuse": dryrun.approx_reuse_ssv(cfg.num_layers)}
    want_steps = {k: {n: v for n, v in expected_launches(cfg, dcfg, ssv, 1).items()
                      if n != "flash_verify"} for k, ssv in steps.items()}
    want_steps["draft expand_tree"] = {"flash_verify": dcfg.num_layers * draft_passes(
        dryrun.strict_ssv())}
    want_steps["decode_step"] = {"routing": cfg.num_layers, "nsa_verify_partial": cfg.num_layers}
    want = {c.name: 0 for c in ctx["counters"]}
    for name, w in want_steps.items():
        if rec["steps"][name]["launches"] != w:
            fail(f"{tag} {name}: launches {rec['steps'][name]['launches']}, expected {w}")
        for k, v in w.items():
            want[k] += 3 * v
    if counts != want:
        fail(f"{tag} launch counts {counts}, expected {want}")
    Dh = cfg.head_dim
    for k, v in counts.items():
        if v:
            key = f"{launch_key(k, dcfg.head_dim if k == 'flash_verify' else Dh)}@{shape}"
            ctx["launches"][key] = ctx["launches"].get(key, 0) + v
    ctx["paths"][f"{cfg.name} {shape} dryrun --run"] = counts
    log(f"  {tag} launches {counts} (per step {want_steps}; each step 3 times)")

    strict = outputs["verify Strict"][:, :1]
    dec = outputs["decode_step"]
    if not (torch.isfinite(outputs["verify Strict"]).all() and torch.isfinite(dec).all()):
        fail(f"{tag} logits are not finite")
    err = float((strict - dec).abs().max())
    same_top = bool(torch.equal(strict.argmax(-1), dec.argmax(-1)))
    log(f"  {tag} bf16: Strict root logits vs decode_step's max abs err {err:.3e}, "
        f"argmax {'equal' if same_top else 'differs'} (observed; the equality is checked "
        "in float32, strict_root_equals_decode)")

    # ---- layer 0's kernels at the cell: the target's q, gates and draft K/V
    # of the tree, its full caches, positions at the committed length
    lp, c = cell.params["layers"][0], cell.caches["layers"][0]
    plen = cell.caches["length"]
    pos = (cell.tree.depths[None] + plen.reshape(-1, 1)).to(torch.int32)
    hn = layers.rmsnorm(lp["norm1"], layers.embed(cell.params["embed"], cell.tokens), cfg.norm_eps)
    q_s, k_new, v_new, g_all, plen, ncb_valid = vops._layer_inputs(lp["mix"], cfg, hn, plen, pos)
    S = c["kv"]["k"].shape[1]
    o_cmp, p_slc = rops.routing_fused(q_s, c["cmp"]["k_cmp"], c["cmp"]["v_cmp"], pos,
                                      ncb_valid, cfg.nsa, kv_len=S)
    sel_idx, sel_valid = nsa_lib.select_topn(p_slc, pos, plen, cfg.nsa)
    inp = dict(q=q_s, k_cache=c["kv"]["k"], v_cache=c["kv"]["v"], k_cmp=c["cmp"]["k_cmp"],
               v_cmp=c["cmp"]["v_cmp"], k_draft=k_new.contiguous(), v_draft=v_new.contiguous(),
               sel_idx=sel_idx, sel_valid=sel_valid, positions=pos,
               prefix_len=plen.to(torch.int32), ncb_valid=ncb_valid.to(torch.int32),
               tree_mask=cell.tree_mask, gates=g_all, o_cmp_in=o_cmp)
    sfx = f"@{shape}"

    def note(key, e):
        max_err[key + sfx] = max(max_err.get(key + sfx, 0.0), e)

    check_routing(cfg, inp, "bfloat16", lambda e: note(f"routing_dh{Dh}", e), f"{shape} ")
    check_verify_cases(cfg, inp, "bfloat16", note, f"{shape} ", cases=VERIFY_CASES[:2])
    sig = f"— {ctx['kind']} ({ctx['card']})"
    times = {}
    ms, src, ev = time_kernel(lambda: run_routing(cfg, inp, False), "routing_kernel", iters=20)
    plain = time_events(lambda: run_routing(cfg, inp, True), 3, warmup=1)
    bnd = rl.routing_bound(cfg, inp)
    times[f"routing_dh{Dh}"] = (ms, plain, bnd, None)
    log(f"[11 time] routing Dh {Dh} {shape} (NCB {inp['k_cmp'].shape[1]}, "
        f"{rops.routing_plan(inp['k_cmp'].shape[1], cfg.nsa)[0]} chunks): {ms:.4f} ms ({src}; "
        f"{ev:.4f} ms by CUDA events), plain {plain:.4f} ms, {bound_text(bnd)} {sig}")
    for label, C, mode, full, branch in VERIFY_CASES[:2]:
        args = verify_layouts(cfg, inp, C, mode)
        oc = None if full else inp["o_cmp_in"]
        ms, src, ev = time_kernel(lambda: run_verify(cfg, args, full, oc, False),
                                  "nsa_verify_kernel", iters=20)
        plain = time_events(lambda: run_verify(cfg, args, full, oc, True), 3, warmup=1)
        bnd = rl.verify_bound(cfg, inp, args, full)
        times[f"{case_kernel(full, branch)}_dh{Dh}"] = (ms, plain, bnd, None)
        log(f"[11 time] nsa_verify {label} Dh {Dh} {shape}: {ms:.4f} ms ({src}; {ev:.4f} ms "
            f"by CUDA events), plain {plain:.4f} ms, {bound_text(bnd)} {sig}")
    del args

    # ---- the draft's flash at layer 0 (its cache is not committed by the steps)
    dl, dc = cell.dparams["layers"][0], cell.dcaches["layers"][0]
    hd = layers.rmsnorm(dl["norm1"], layers.embed(cell.dparams["embed"], cell.tokens),
                        dcfg.norm_eps)
    q, kd, vd = attn_lib.qkv(dl["mix"], dcfg, hd, cell.positions)
    finp = dict(q=(q.float() / dcfg.head_dim ** 0.5).contiguous(), k_cache=dc["kv"]["k"],
                v_cache=dc["kv"]["v"], k_draft=kd.contiguous(), v_draft=vd.contiguous(),
                positions=cell.positions, prefix_len=cell.dcaches["length"].to(torch.int32),
                tree_mask=cell.tree_mask)
    Hkv, Gq = dcfg.num_kv_heads, dcfg.num_heads // dcfg.num_kv_heads

    def flash_plain():
        """The plain flash one kv head at a time (at 524,288 keys the
        whole score tensor would take gigabytes)."""
        return torch.cat([fref.ref_flash_verify(
            finp["q"][:, :, h * Gq:(h + 1) * Gq], finp["k_cache"][:, :, h:h + 1],
            finp["v_cache"][:, :, h:h + 1], finp["k_draft"][:, :, h:h + 1],
            finp["v_draft"][:, :, h:h + 1], finp["positions"], finp["prefix_len"],
            finp["tree_mask"]) for h in range(Hkv)], dim=2)

    got = fops.flash_verify(**finp)
    want_f = flash_plain()
    torch.cuda.synchronize()
    fkey = f"flash_verify_dh{dcfg.head_dim}"
    note(fkey, check_close(f"{shape} flash draft layer 0 (S {finp['k_cache'].shape[1]}, "
                           f"KS {fops.split_keys(finp['k_cache'].shape[1])})",
                           got, want_f, "bfloat16"))
    del got, want_f
    ms, src, ev = time_kernel(lambda: fops.flash_verify(**finp), "flash_verify_kernel", iters=20)
    plain = time_events(flash_plain, 2, warmup=1)
    sdpa = sdpa_call(finp)
    lib = time_events(sdpa, 5, warmup=1)
    del sdpa
    bnd = rl.flash_bound(finp)
    times[fkey] = (ms, plain, bnd, lib)
    log(f"[11 time] flash draft Dh {dcfg.head_dim} {shape}: {ms:.4f} ms ({src}; {ev:.4f} ms "
        f"by CUDA events), plain {plain:.4f} ms, {bound_text(bnd)}, library "
        f"(scaled_dot_product_attention) {lib:.4f} ms {sig}")
    source = {"routing": ("routing.cu", "routing/kernel.py:70"),
              "nsa": ("nsa_verify.cu", "nsa_verify/kernel.py:156"),
              "flash": ("flash_verify.cu", "flash/kernel.py:69")}
    for key, (ms, plain, bnd, lib) in times.items():
        src, tpu = source[key.split("_")[0]]
        src, tpu = "src/repro_torch/csrc/" + src, "src/repro/kernels/" + tpu
        rows.append(dict(name=key + sfx, route="cuda", source=src, replaces=tpu, launches=0,
                         max_abs_err=None, ms=ms, plain_ms=plain, bound_ms=bnd[0],
                         bound_by=bnd[1], library_ms=lib))
    return {"bf16_strict_vs_decode_max_abs_err": err, "bf16_same_argmax": same_top,
            "launches": counts,
            "kernels": {k: dict(ms=v[0], plain_ms=v[1], bound_ms=v[2][0], bound_by=v[2][1],
                                library_ms=v[3]) for k, v in times.items()}}


PAIR = dict(vocab=256, data_seed=11, batch=8, seq=1024, lr=3e-3, per_round=100,
            max_rounds=8, prompt_step=10_000, prompt_len=1024, tokens=16,
            loss_margin=0.1, min_distinct=4)


def leaves_of(tree):
    from repro_torch.optim import tree_leaves
    return tree_leaves(tree)


def train_full_width(cfg, ctx, steps=3, B=1, S=4096):
    """``steps`` Trainer steps of full-width ``cfg`` from ``init_params``;
    returns (numbers, trainer)."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.bridge import init_params
    from repro_torch.config import ShapeConfig, TrainConfig
    from repro_torch.data.synthetic import SyntheticConfig
    from repro_torch.runtime.trainer import Trainer
    gen = torch.Generator(DEV)
    gen.manual_seed(0)
    params = init_params(cfg, gen, DEV)
    before = [p.clone() for p in leaves_of(params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, TrainConfig(steps=steps, learning_rate=3e-4, warmup_steps=1,
                                  checkpoint_every=0, seed=0),
                 data_cfg=SyntheticConfig(vocab_size=cfg.vocab_size), batch_size=B, seq_len=S,
                 params=params, device=DEV, resume=False)
    tr.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m = tr.metrics_log
    tag = f"[9 train {cfg.name} {cfg.dtype}]"
    if len(m) != steps or not all(map(torch.isfinite, torch.tensor(
            [[x["loss"], x["grad_norm"]] for x in m]).flatten())):
        fail(f"{tag} a loss or grad norm is not finite: {m}")
    after = leaves_of(tr.state.params)
    still = [i for i, (a, b) in enumerate(zip(before, after)) if a.ndim >= 2 and torch.equal(a, b)]
    if still:
        fail(f"{tag} {len(still)} weight matrices did not move")
    moved = sum(not torch.equal(a, b) for a, b in zip(before, after))
    del before, after
    n_params = sum(p.numel() for p in leaves_of(tr.state.params))
    n_matmul = n_params - tr.state.params["embed"]["table"].numel()   # the lookup is no product
    step_s = statistics.median(x["time_s"] for x in m[1:])          # the first step warms up
    # the share: roofline.model_flops (6 x active params x tokens + the
    # causal / NSA attention term, the JAX formula) over the step time at
    # 989 TFLOP/s; beside it the needed-FLOPs formula
    flops = rl.model_flops(cfg, ShapeConfig("train", S, B, "train"))
    needed = rl.train_flops_needed(cfg, n_matmul, B, S)
    res = dict(steps=steps, batch=B, seq=S, params=n_params, losses=[x["loss"] for x in m],
               grad_norms=[x["grad_norm"] for x in m], step_ms=[x["time_s"] * 1e3 for x in m],
               median_step_ms=step_s * 1e3, tokens_per_s=B * S / step_s, peak_gib=peak,
               model_flops=flops, flops_share=rl.flops_share(flops, step_s),
               needed_flops=needed, needed_flops_share=rl.flops_share(needed, step_s),
               leaves_moved=moved, leaves=len(leaves_of(tr.state.params)))
    log(f"{tag} {ctx['kind']} ({ctx['card']}): {n_params / 1e9:.3f}e9 params, {B} x {S} "
        f"tokens/step; losses {[round(x, 4) for x in res['losses']]}; grad norms "
        f"{[round(x, 3) for x in res['grad_norms']]}; step ms "
        f"{[round(x, 1) for x in res['step_ms']]} (median after the first "
        f"{res['median_step_ms']:.1f}); {res['tokens_per_s']:.0f} trained tokens/s; peak "
        f"{peak:.2f} GiB; model FLOPs (roofline.model_flops) {flops / 1e12:.2f} TFLOP/step, "
        f"{100 * res['flops_share']:.2f}% of 989 TFLOP/s (the needed-FLOPs formula, 6 x "
        f"non-embedding params x tokens + needed attention: {needed / 1e12:.2f} TFLOP/step, "
        f"{100 * res['needed_flops_share']:.2f}%); {moved}/{res['leaves']} leaves moved")
    return res, tr


def profile_train_step(tr, tag):
    """One more train step under the profiler: its wall time, device busy
    time, idle share, kernel count and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.run(1)
        torch.cuda.synchronize()
    wall_ms = tr.metrics_log[-1]["time_s"] * 1e3
    kern = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", 0.0) or \
                getattr(ev, "self_cuda_time_total", 0.0)
            kern.append((us / 1e3, ev.count, ev.key))
    kern.sort(reverse=True)
    busy = sum(k[0] for k in kern)
    top = [{"ms": ms, "launches": c, "name": name[:90]} for ms, c, name in kern[:8]]
    log(f"  {tag} profiled step: {wall_ms:.1f} ms wall (profiler on), device busy "
        f"{busy:.1f} ms (idle share {1 - busy / wall_ms:.3f}), "
        f"{sum(k[1] for k in kern if not is_copy(k[2]))} kernels")
    for t in top[:6]:
        log(f"    {t['ms']:.2f} ms x{t['launches']} {t['name']}")
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "kernels": sum(k[1] for k in kern if not is_copy(k[2])), "top": top}


def checkpoint_round_trip(cfg, tr, ckdir):
    """The trainer's state through an ``AsyncCheckpointer`` checkpoint and
    back onto the card: every tensor bitwise, dtype and device kept."""
    from repro_torch.ckpt import AsyncCheckpointer, restore
    shutil.rmtree(ckdir, ignore_errors=True)
    tree = {"params": tr.state.params, "opt": tr.state.opt, "residual": tr.state.residual}
    t0 = time.time()
    ck = AsyncCheckpointer(str(ckdir), cfg)
    ck.save(tr.state.step, tree)
    ck.wait()
    step, back = restore(str(ckdir), tree, cfg)
    a, b = leaves_of(tree), leaves_of(back)
    same = step == tr.state.step and len(a) == len(b) and all(
        x.dtype == y.dtype and y.device == x.device and torch.equal(x, y) for x, y in zip(a, b))
    nbytes = sum(x.numel() * x.element_size() for x in a)
    log(f"[9 checkpoint {cfg.name}] {len(a)} tensors, {nbytes / 2 ** 30:.2f} GiB on the card, "
        f"save + restore {time.time() - t0:.1f}s: {'bitwise equal' if same else 'DIFFERENT'}")
    shutil.rmtree(ckdir, ignore_errors=True)
    if not same:
        fail(f"{cfg.name}: the checkpoint round trip on the card is not bitwise")
    return dict(tensors=len(a), gib=nbytes / 2 ** 30, bitwise=same)


def card_step_equals_cpu(cfg, seed=0, B=2, S=256):
    """One train step's loss and gradients of float32 ``cfg`` on the card
    and on the CPU (TF32 off): loss rtol 2e-4 / atol 2e-5, every gradient
    leaf rtol 1e-3 / atol 1e-6."""
    from repro_torch.bridge import init_params
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus
    from repro_torch.models import model
    from repro_torch.optim import tree_map
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    tokens = torch.from_numpy(SyntheticCorpus(SyntheticConfig(vocab_size=cfg.vocab_size))
                              .batch(seed, B, S))
    out = []
    for dev in ("cpu", DEV):
        p = tree_map(lambda t: t.to(dev), params)
        leaves = leaves_of(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss_fn(p, cfg, tokens.to(dev), remat=True)
        grads = torch.autograd.grad(loss, leaves)
        out.append((loss.detach().cpu(), [g.cpu() for g in grads]))
    (lc, gc_), (lg, gg) = out
    worst = max(float(((a - b).abs() / (1e-6 + 1e-3 * b.abs())).max()) for a, b in zip(gg, gc_))
    ok = torch.allclose(lg, lc, rtol=2e-4, atol=2e-5) and all(
        torch.allclose(a, b, rtol=1e-3, atol=1e-6) for a, b in zip(gg, gc_))
    log(f"[9 card step == CPU step {cfg.name} f32] loss {float(lg):.6f} vs {float(lc):.6f}; "
        f"{len(gg)} gradient leaves, worst |diff| / (1e-6 + 1e-3 |cpu|) {worst:.3f}: "
        f"{'equal within tolerance' if ok else 'DIFFERENT'}")
    if not ok:
        fail(f"{cfg.name}: the train step on the card differs from the CPU's")
    return dict(loss_card=float(lg), loss_cpu=float(lc), worst_grad_ratio=worst)


def restart_equals_uninterrupted(cfg, workdir, B=2, S=256):
    """8 steps with a checkpoint every 4, and the same with a failure
    injected at step 6 and a restart from the step-4 checkpoint, under
    ``torch.use_deterministic_algorithms(True)``: params and the last
    losses bitwise equal."""
    from repro_torch.config import TrainConfig
    from repro_torch.runtime.fault import FailureInjector, run_with_restarts
    from repro_torch.runtime.trainer import Trainer
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for inject in (False, True):
            ckdir = workdir / f"restart_{int(inject)}"
            shutil.rmtree(ckdir, ignore_errors=True)
            tc = TrainConfig(steps=8, checkpoint_every=4, checkpoint_dir=str(ckdir),
                             learning_rate=1e-3, seed=3)
            inj = FailureInjector(fail_at_steps=[6]) if inject else None
            holder = {}

            def driver():
                holder["tr"] = Trainer(cfg, tc, batch_size=B, seq_len=S, injector=inj,
                                       device=DEV)
                return holder["tr"].run()

            rep = run_with_restarts(driver)
            if not rep.completed or rep.restarts != int(inject):
                fail(f"restart run: {rep}")
            runs.append(holder["tr"])
            shutil.rmtree(ckdir, ignore_errors=True)
    finally:
        torch.use_deterministic_algorithms(False)
    plain, crashed = runs
    same = crashed.metrics_log[0]["step"] == 4 and all(
        torch.equal(a, b) for a, b in zip(leaves_of(plain.state.params),
                                          leaves_of(crashed.state.params))) and \
        [m["loss"] for m in plain.metrics_log[-2:]] == [m["loss"] for m in crashed.metrics_log[-2:]]
    log(f"[9 restart == uninterrupted {cfg.name} f32] failure at step 6, resumed at step "
        f"{crashed.metrics_log[0]['step']}: {'bitwise equal' if same else 'DIFFERENT'}")
    if not same:
        fail(f"{cfg.name}: the restarted run left the uninterrupted trajectory")
    return dict(bitwise=same, losses=[m["loss"] for m in plain.metrics_log])


def as_dtype(params, cfg, dtype):
    """The params with each leaf in the dtype ``init_params`` gives it for
    ``cfg`` at ``dtype`` (bf16 weights; float32 gates and pooling logits)."""
    from repro_torch.bridge import init_params
    from repro_torch.optim import tree_map
    tmpl = init_params(dataclasses.replace(cfg, dtype=dtype), torch.Generator(), "cpu")
    return tree_map(lambda p, t: p.to(t.dtype), params, tmpl)


def train_pair(ctx):
    """The head-dim-64 pair, trained on the card in rounds of
    ``per_round`` steps until the target has learned the corpus (its loss
    ``loss_margin`` nats below the unigram entropy, at least
    ``min_distinct`` distinct tokens in its greedy continuation of the
    held-out prompt) and greedy serving accepts draft tokens in float32
    Strict and bf16 Strict and Approx+Reuse. Then the three kernels are
    held against their plain versions at the pair's shapes, and the pair
    is served: float32 Strict on the card equals the CPU's and its
    commits equal a chain replay; bf16 Strict / Approx+Reuse SSV (counted
    launches) and AR."""
    from repro_torch import configs
    from repro_torch.config import ServeConfig, SSVConfig, TrainConfig
    from repro_torch.core import draft as draft_lib, engine as engine_lib
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus
    from repro_torch.optim import tree_map
    from repro_torch.runtime.trainer import Trainer
    tcfg = configs.reduced("ssv-nsa-1b", vocab=PAIR["vocab"])
    dcfg = draft_lib.draft_config(tcfg, num_layers=1, d_model=128)
    if (tcfg.head_dim, dcfg.head_dim) != (64, 64):
        fail(f"the pair's head dims {tcfg.head_dim}, {dcfg.head_dim} are not the kernels' 64")
    data = SyntheticConfig(vocab_size=PAIR["vocab"], num_classes=8, seed=PAIR["data_seed"])
    total = PAIR["per_round"] * PAIR["max_rounds"]
    trainers = [Trainer(cfg, TrainConfig(steps=total, learning_rate=PAIR["lr"], warmup_steps=10,
                                         checkpoint_every=0, seed=seed),
                        data_cfg=data, batch_size=PAIR["batch"], seq_len=PAIR["seq"],
                        device=DEV, resume=False)
                for cfg, seed in ((tcfg, 0), (dcfg, 1))]
    prompt = SyntheticCorpus(data).batch(PAIR["prompt_step"], 1, PAIR["prompt_len"])[0]
    n_tok = PAIR["tokens"]

    def engine(tp, dp, dtype, ssv, dev=DEV):
        t32 = dataclasses.replace(tcfg, dtype=dtype)
        d32 = dataclasses.replace(dcfg, dtype=dtype)
        return engine_lib.SSVEngine(as_dtype(tp, tcfg, dtype), t32, as_dtype(dp, dcfg, dtype),
                                    d32, ServeConfig(max_new_tokens=n_tok, temperature=0.0,
                                                     max_context=2048, ssv=ssv,
                                                     use_planner=False), device=dev)

    served_as = [("float32", "Strict"), ("bfloat16", "Strict"), ("bfloat16", "Approx+Reuse")]
    unigram, oracle = corpus_losses(SyntheticCorpus(data))
    rounds = []
    t0 = time.time()
    for r in range(PAIR["max_rounds"]):
        for tr in trainers:
            tr.run(PAIR["per_round"])
        tp, dp = (tr.state.params for tr in trainers)
        res = {f"{dt} {pc}": engine(tp, dp, dt, strategy(tcfg, pc)).generate(prompt, 2 * n_tok)
               for dt, pc in served_as}
        acc = {k: v.mean_accepted for k, v in res.items()}
        loss = statistics.mean(m["loss"] for m in trainers[0].metrics_log[-20:])
        distinct = len(set(res["float32 Strict"].tokens.tolist()))
        rounds.append(dict(steps=trainers[0].state.step, target_loss=loss,
                           draft_loss=statistics.mean(m["loss"] for m in
                                                      trainers[1].metrics_log[-20:]),
                           distinct_tokens=distinct, mean_accepted=acc))
        log(f"  [9 pair] {rounds[-1]}")
        learned = loss < unigram - PAIR["loss_margin"] and distinct >= PAIR["min_distinct"]
        if learned and min(acc.values()) > 0:
            break
    train_s = time.time() - t0
    step_ms = {cfg.name: statistics.median(m["time_s"] for m in tr.metrics_log) * 1e3
               for cfg, tr in zip((tcfg, dcfg), trainers)}
    tok_s = {k: PAIR["batch"] * PAIR["seq"] / v * 1e3 for k, v in step_ms.items()}
    log(f"[9 pair trained] {ctx['kind']} ({ctx['card']}): {rounds[-1]['steps']} steps of "
        f"{PAIR['batch']} x {PAIR['seq']} tokens each model in {train_s:.1f}s (median step ms "
        f"{step_ms}; trained tokens/s {tok_s}); losses target "
        f"{rounds[-1]['target_loss']:.4f}, draft "
        f"{rounds[-1]['draft_loss']:.4f} (the corpus: unigram entropy {unigram:.4f}, the "
        f"true model's next-token loss {oracle:.4f} nats)")
    if min(rounds[-1]["mean_accepted"].values()) <= 0:
        fail(f"the trained pair accepts no draft tokens after {rounds[-1]['steps']} steps")
    if not learned:
        fail(f"after {rounds[-1]['steps']} steps the target's loss {loss:.4f} is not "
             f"{PAIR['loss_margin']} nats below the unigram entropy {unigram:.4f}, or its "
             f"greedy output has fewer than {PAIR['min_distinct']} distinct tokens")

    tp, dp = (tr.state.params for tr in trainers)
    check_pair_kernels(tcfg, dcfg, ctx)
    # float32 Strict, step by step: the tokens and accepted counts equal the
    # CPU's plain path on the same weights; the caches equal a chain replay
    strict = strategy(tcfg, "Strict")
    runs = {}
    for dev in (DEV, "cpu"):
        eng = engine(tree_map(lambda t: t.to(dev), tp), tree_map(lambda t: t.to(dev), dp),
                     "float32", strict, dev)
        eng.start(prompt)
        steps = []
        while sum(map(len, steps)) < 2 * n_tok:
            steps.append(eng.step()[0])
        runs[dev] = (eng, steps)
    eng, steps = runs[DEV]
    ssv_toks = [t for toks in steps for t in toks]
    log(f"[9 pair f32 Strict] {ssv_toks} (accepted per step {[len(t) - 1 for t in steps]})")
    if steps != runs["cpu"][1]:
        fail(f"the card's float32 Strict serve differs from the CPU's: {runs['cpu'][1]}")
    log("[9 pair f32 Strict] card == CPU (plain versions): the same tokens and accepted counts")
    commit_err = commit_equals_replay(eng, prompt, steps, strict)
    # Not a check: Strict verifies a tree node's cmp and slc branches
    # against the committed prefix only (the JAX reference's semantics),
    # so after an accepted draft the target sees less than autoregressive
    # decoding at the same position and the two may part.
    ar_toks = engine_lib.autoregressive_decode(tp, tcfg, prompt, len(ssv_toks), 2048,
                                               device=DEV).tokens.tolist()
    agree = next((i for i, (a, b) in enumerate(zip(ssv_toks, ar_toks)) if a != b),
                 len(ssv_toks))
    log(f"[9 pair f32 AR] {ar_toks} (the first {agree} tokens equal the Strict serve's)")
    del eng, runs
    served = {}
    t16 = dataclasses.replace(tcfg, dtype="bfloat16")
    for pc in ("Strict", "Approx+Reuse"):
        ssv = strategy(tcfg, pc)
        eng = engine(tp, dp, "bfloat16", ssv)
        eng.generate(prompt, n_tok)                                  # warm
        res = counted_path(ctx, f"trained pair {pc}", 64,
                           lambda: generate_all(eng, [prompt], t16, pc, 2 * n_tok),
                           lambda r: expected_launches(tcfg, dcfg, ssv, r["steps"]))
        eng.start(prompt)
        res["profile"] = step_profile(eng.step, 3)
        served[pc] = res
        log(f"  [trained pair {pc}] step profile "
            f"{ {k: v for k, v in res['profile'].items() if k != 'top'} }")
        log(f"[9 pair serve bf16 {pc}] {ctx['kind']} ({ctx['card']}): {res['tokens']} tokens in "
            f"{res['steps']} steps, {res['tokens_per_s']:.2f} tok/s, mean accepted/step "
            f"{res['mean_accepted']:.3f}")
        if res["mean_accepted"] <= 0:
            fail(f"the trained pair accepts no draft tokens in bf16 {pc}")
    tp16 = as_dtype(tp, tcfg, "bfloat16")
    engine_lib.autoregressive_decode(tp16, t16, prompt, 4, 2048, device=DEV)   # warm
    ar = engine_lib.autoregressive_decode(tp16, t16, prompt, 2 * n_tok, 2048, device=DEV)
    served["AR"] = dict(tokens=len(ar.tokens), tokens_per_s=ar.accepted_token_throughput)
    log(f"[9 pair AR bf16] {ctx['kind']} ({ctx['card']}): {len(ar.tokens)} tokens, "
        f"{ar.accepted_token_throughput:.2f} tok/s; SSV Strict / AR = "
        f"{served['Strict']['tokens_per_s'] / ar.accepted_token_throughput:.2f}x")
    return dict(rounds=rounds, train_s=train_s, median_step_ms=step_ms, tokens_per_s=tok_s,
                served=served, f32_strict_tokens=ssv_toks, f32_ar_tokens=ar_toks,
                f32_tokens_equal_to_ar=agree,
                f32_accepted_per_step=[len(t) - 1 for t in steps],
                commit_equals_replay_max_err=commit_err, corpus_unigram_nats=unigram,
                corpus_true_model_nats=oracle)


def check_pair_kernels(tcfg, dcfg, ctx, prefix=1024, S=2048):
    """The three kernels against their plain versions at the trained
    pair's serving shapes (prefix ``prefix``, cache ``S``, D4/k2 tree):
    routing and the fused nsa_verify cases at the target's heads, flash at
    the draft's, in float32 and bf16 K/V."""
    note = ctx["note_err"]
    for dt_name, dt in DTYPES.items():
        inp = verify_inputs(tcfg, dt, seed=21, prefix=prefix, S=S)
        check_routing(tcfg, inp, dt_name, lambda e: note(f"routing_dh{tcfg.head_dim}", e),
                      tag="pair ")
        check_verify_cases(tcfg, inp, dt_name, note, "pair ", VERIFY_CASES[:4])
        del inp
        check_flash("pair draft", dcfg.num_heads, dcfg.num_kv_heads, dcfg.head_dim, dt_name,
                    note, seed=22, prefix=prefix, S=S)
    free()


def commit_equals_replay(eng, prompt, steps, ssv):
    """After a float32 greedy serve driven step by step (``steps``: the
    tokens each step emitted), rebuild each model's caches without the
    tree: from the prefill, each step's accepted path (the pending token
    and the accepted drafts) goes through ``verify_step`` as a chain (node
    d sees nodes < d) at the step's committed length and is committed
    whole. Each of the target's chain nodes must predict (argmax) the
    token the serve emitted after it, and each model's caches (the
    committed K/V rows, the compressed blocks, the length) and the next
    logits must equal the serve's within the float32 tolerance; the
    compressed blocks must also equal ``compress_kv`` of the committed
    rows. Returns the worst |diff| per model."""
    from repro_torch.models import model, nsa as nsa_lib
    L = eng.committed_len
    emitted = [t for toks in steps for t in toks]
    fed = [int(prompt[-1])] + emitted[:-1]
    pending = torch.tensor([[eng.pending]], device=DEV)
    worst = {}
    for label, params, cfg, caches in (("target", eng.tp, eng.tcfg, eng.t_caches),
                                       ("draft", eng.dp, eng.dcfg, eng.d_caches)):
        _, ref = model.prefill(params, cfg, torch.as_tensor(prompt[:-1], device=DEV)[None],
                               eng.serve.max_context)
        i = 0
        for toks in steps:
            n = len(toks)
            pos = (torch.arange(n, device=DEV) + int(ref["length"][0])).to(torch.int32)[None]
            chain = torch.ones((n, n), dtype=torch.bool, device=DEV).tril()[None]
            logits, up = model.verify_step(params, cfg, ref, torch.tensor([fed[i:i + n]],
                                           device=DEV), pos, chain, None, ssv)
            if label == "target" and logits[0].argmax(-1).tolist() != toks:
                fail(f"the target's chain replay predicts {logits[0].argmax(-1).tolist()} "
                     f"where the serve emitted {toks} (tokens {i}-{i + n - 1})")
            ref = model.commit(params, cfg, ref, up, torch.arange(n, device=DEV)[None],
                               torch.tensor([n], dtype=torch.int32, device=DEV))
            i += n
        if int(caches["length"][0]) != L or int(ref["length"][0]) != L:
            fail(f"{label}: committed lengths {int(caches['length'][0])}, "
                 f"{int(ref['length'][0])}, expected {L}")
        pairs = []
        for li, (got, want) in enumerate(zip(caches["layers"], ref["layers"])):
            pairs += [(f"layer {li} {k}", got["kv"][k][:, :L], want["kv"][k][:, :L])
                      for k in ("k", "v")]
            if "cmp" in got:
                nb = nsa_lib.num_cmp_blocks(L, cfg.nsa)
                pairs += [(f"layer {li} {k}", got["cmp"][k][:, :nb], want["cmp"][k][:, :nb])
                          for k in ("k_cmp", "v_cmp")]
                # and the blocks the prefill's compression makes of the rows
                pooled = nsa_lib.compress_kv(params["layers"][li]["mix"], got["kv"]["k"][:, :L],
                                             got["kv"]["v"][:, :L], cfg.nsa)
                pairs += [(f"layer {li} {k} (compress_kv of the rows)", got["cmp"][k][:, :nb], c)
                          for k, c in zip(("k_cmp", "v_cmp"), pooled)]
        pairs.append(("next logits", model.decode_step(params, cfg, caches, pending)[0],
                      model.decode_step(params, cfg, ref, pending)[0]))
        worst[label] = max(check_close(f"[9 pair commit == replay f32] {label} {name}", g, w,
                                       "float32", "the replay") for name, g, w in pairs)
    return worst


def corpus_losses(corpus, n=4000, burn=100):
    """(unigram entropy, the next-token loss of the corpus's own model
    (the order-2 class chain, filtered exactly over its C x C states) on
    one sampled sequence), in nats: the floor a trained model can reach."""
    import numpy as np
    x = corpus.batch(PAIR["prompt_step"] + 1, 1, n)[0]
    C = corpus.cfg.num_classes
    belief = np.full((C, C), 1.0 / (C * C))
    nll = []
    for tok in x:
        joint = np.einsum("ab,abc->bc", belief, corpus.trans)    # (c2, c3)
        nll.append(-np.log(joint.sum(0) @ corpus.emis[:, tok]))
        post = joint * corpus.emis[:, tok][None, :]
        belief = post / post.sum()
    u = np.bincount(corpus.batch(0, 8, 2048).ravel(), minlength=corpus.cfg.vocab_size) / 16384
    return float(-(u[u > 0] * np.log(u[u > 0])).sum()), float(np.mean(nll[burn:]))


def train_cli(workdir):
    """The train CLI as a user runs it: 2 steps, then again to step 4 (the
    second run resumes from the first's checkpoint)."""
    ckdir = workdir / "cli_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "ssv-nsa-1b",
            "--reduced", "--batch", "2", "--seq", "256", "--ckpt", str(ckdir),
            "--ckpt-every", "2"]
    for steps, want in ((2, ("resume step 0", "done at step 2")),
                        (4, ("resume step 2", "done at step 4"))):
        t0 = time.time()
        cli = subprocess.run(base + ["--steps", str(steps)], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=600)
        tag = f"[9 train CLI --steps {steps}]"
        for line in (cli.stdout + cli.stderr).strip().splitlines()[-4:]:
            log(f"{tag} {line}")
        if cli.returncode != 0 or not all(w in cli.stdout for w in want):
            fail(f"train CLI --steps {steps} exited {cli.returncode}")
        log(f"{tag} {time.time() - t0:.1f}s")
    shutil.rmtree(ckdir, ignore_errors=True)


def train_phase(cfg, ctx, workdir):
    """Phase 9 (see the module docstring)."""
    from repro_torch import configs
    from repro_torch.core import draft as draft_lib
    workdir.mkdir(parents=True, exist_ok=True)
    out = {}
    out["target"], tr = train_full_width(cfg, ctx)
    out["target"]["profile"] = profile_train_step(tr, f"[9 train {cfg.name}]")
    del tr
    free()
    dcfg = draft_lib.draft_config(cfg)
    out["draft"], tr = train_full_width(dcfg, ctx)
    out["checkpoint"] = checkpoint_round_trip(dcfg, tr, workdir / "ckpt_draft")
    del tr
    free()
    small = configs.reduced("ssv-nsa-1b")
    # the train CLI's two runs, processes of their own on the card, beside
    # the reduced checks and the pair's rounds
    with ThreadPoolExecutor(1) as pool:
        cli = pool.submit(train_cli, workdir)
        out["card_step_equals_cpu"] = card_step_equals_cpu(small)
        out["restart"] = restart_equals_uninterrupted(small, workdir)
        free()
        out["pair"] = train_pair(ctx)
        free()
        cli.result()
    return out


def serve_clis(runs):
    """Run the serve CLI (``python -m repro_torch.launch.serve``) once per
    (arch, flags, expected output) of ``runs``, all at once: each is a
    process of its own on the shared card, bound by its host's launches,
    so together they take little more than the longest. Fails unless each
    exits 0 and prints what it should; stops every process it started."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    procs = []
    try:
        for arch, flags, expect in runs:
            procs.append((arch, flags, expect, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--tokens",
                 "8", *flags], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        for arch, flags, expect, p in procs:
            out, err = p.communicate(timeout=max(1.0, 600 - (time.time() - t0)))
            tag = f"[7 serve {arch} {' '.join(flags)}]"
            for line in (out + err).strip().splitlines()[-5:]:
                log(f"{tag} {line}")
            expect = (expect,) if isinstance(expect, str) else expect
            if p.returncode != 0 or not all(e in out for e in expect):
                fail(f"serve CLI --arch {arch} {' '.join(flags)} exited {p.returncode}")
            log(f"{tag} done at {time.time() - t0:.1f}s")
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def kernel_row(name, Dh, source, replaces, launches, max_err, ms, plain, bnd, library=None,
               gq=4):
    key = launch_key(name, Dh, gq)
    return dict(name=key, route="cuda", source=source, replaces=replaces,
                launches=launches.get(key, 0), max_abs_err=max_err.get(key), ms=ms,
                plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1], library_ms=library)


def bound_text(bnd):
    return f"bound {bnd[0]:.5f} ms ({bnd[1]}; bytes alone {bnd[2]:.5f} ms)"


def pre_redesign_text(key, ms):
    """The pre-redesign kernel's time of the same case beside this run's."""
    old = PRE_REDESIGN_MS.get(key)
    return f"pre-redesign {old:.4f} ms ({old / ms:.2f}x)" if old else "pre-redesign: none"


def kernel_times(cfgs, launches, max_err, kind, card, zoo=True):
    from repro_torch.analysis import roofline as rl
    from repro_torch.kernels.nsa_verify import ops as vops
    rows = []
    bounds = {}
    sig = f"— {kind} ({card})"
    verify_src, verify_tpu = "src/repro_torch/csrc/nsa_verify.cu", "src/repro/kernels/nsa_verify/kernel.py:156"
    for Dh, cfg in cfgs.items():
        inp = verify_inputs(cfg, torch.bfloat16, seed=2)
        r_ms, r_src, r_ev = time_kernel(lambda: run_routing(cfg, inp, False), "routing_kernel")
        r_plain = time_events(lambda: run_routing(cfg, inp, True), 10)
        r_bound = rl.routing_bound(cfg, inp)
        bounds[f"routing_dh{Dh}"] = r_bound
        log(f"[8 time] routing Dh {Dh}: {r_ms:.4f} ms ({r_src}; {r_ev:.4f} ms by CUDA events; "
            f"{pre_redesign_text(f'routing dh{Dh}', r_ms)}), plain {r_plain:.4f} ms, "
            f"{bound_text(r_bound)}, library call: none {sig}")
        rows.append(kernel_row("routing", Dh, "src/repro_torch/csrc/routing.cu",
                               "src/repro/kernels/routing/kernel.py:70", launches, max_err,
                               r_ms, r_plain, r_bound))
        times = {}
        for label, C, mode, full, branch in VERIFY_CASES:
            args = verify_layouts(cfg, inp, C, mode)
            oc = inp["o_cmp_in"] if (not full and branch == "all") else None
            ms, src, ev = time_kernel(lambda: run_verify(cfg, args, full, oc, False, branch),
                                      "nsa_verify_kernel")
            plain = time_events(lambda: run_verify(cfg, args, full, oc, True, branch), 5)
            bnd = rl.verify_bound(cfg, inp, args, full, branch)
            times[label] = (ms, plain, bnd)
            bounds[f"nsa_verify {label} dh{Dh}"] = bnd
            log(f"[8 time] nsa_verify {label} Dh {Dh}: {ms:.4f} ms ({src}; {ev:.4f} ms by "
                f"CUDA events; {pre_redesign_text(f'nsa_verify {label} dh{Dh}', ms)}), plain "
                f"{plain:.4f} ms, {bound_text(bnd)}, library call: none {sig}")
        for key, label in (("nsa_verify_full", "exact C=2 full"),
                           ("nsa_verify_partial", "exact C=2 partial")):
            ms, plain, bnd = times[label]
            rows.append(kernel_row(key, Dh, verify_src, verify_tpu, launches, max_err,
                                   ms, plain, bnd))
        # paged: the same inputs re-homed into a shuffled pool (page size =
        # sel_block, every page mapped); the row is the refresh-layer case
        pool = paged_pool(cfg, inp, 1, holes=False, seed=3)
        for label, C, mode, full in (("exact C=2 partial", 2, "exact", False),
                                     ("exact C=2 full", 2, "exact", True)):
            args = verify_layouts(cfg, inp, C, mode, pool)
            oc = None if full else inp["o_cmp_in"]
            ms, src, ev = time_kernel(lambda: run_verify(cfg, args, full, oc, False),
                                      "nsa_verify_kernel")
            plain = time_events(lambda: run_verify(cfg, args, full, oc, True), 5)
            bnd = rl.verify_bound(cfg, inp, args, full)
            bounds[f"nsa_verify paged {label} dh{Dh}"] = bnd
            log(f"[8 time] nsa_verify paged {label} Dh {Dh}: {ms:.4f} ms ({src}; {ev:.4f} ms "
                f"by CUDA events; dense {times[label][0]:.4f} ms; "
                f"{pre_redesign_text(f'nsa_verify paged {label} dh{Dh}', ms)}), plain {plain:.4f} ms, "
                f"{bound_text(bnd)}, library call: none {sig}")
            if not full:
                rows.append(kernel_row("nsa_verify_paged", Dh, verify_src,
                                       "src/repro/kernels/nsa_verify/kernel.py:193 (paged=True)",
                                       launches, max_err, ms, plain, bnd))
        del pool
        # vanilla: the mean of its two single-branch launches
        (ms_s, pl_s, b_s), (ms_w, pl_w, b_w) = times["vanilla slc"], times["vanilla win"]
        b_v = ((b_s[0] + b_w[0]) / 2, b_s[1] if b_s[0] >= b_w[0] else b_w[1])
        rows.append(kernel_row("nsa_verify_vanilla", Dh, verify_src,
                               "src/repro/kernels/nsa_verify/kernel.py:156 (combine=False)",
                               launches, max_err, (ms_s + ms_w) / 2, (pl_s + pl_w) / 2, b_v))
        del inp
    if zoo:
        rows += zoo_kernel_times(cfgs, launches, max_err, bounds, sig)
    layer_times = {}
    for Dh, cfg in cfgs.items():
        lcfg, mix, x, kv, cmp, plen, pos, tm = layer_inputs(cfg, "bfloat16", seed=4)
        vanilla = time_events(lambda: vops.nsa_verify_vanilla_layer(
            mix, lcfg, x, kv, cmp, plen, pos, tm), 20)
        fused = time_events(lambda: vops.nsa_verify_kernel_layer(
            mix, lcfg, x, kv, cmp, plen, pos, tm, C=1, mode="exact", reuse=False), 20)
        vanilla2 = time_events(lambda: vops.nsa_verify_vanilla_layer(
            mix, lcfg, x, kv, cmp, plen, pos, tm), 20)
        layer_times[f"dh{Dh}"] = dict(vanilla_ms=[vanilla, vanilla2], fused_c1_ms=fused)
        log(f"[8 time] NSA layer Dh {Dh} (bf16, prefix 4096, T=31, C=1, CUDA events per "
            f"layer call): vanilla (routing + 2 branch launches + combine) {vanilla:.4f} / "
            f"{vanilla2:.4f} ms, fused refresh layer (routing + partial fusion) {fused:.4f} ms {sig}")
        del lcfg, mix, x, kv, cmp
    for label, Hq, Hkv, Dh in FLASH_CASES:
        inp = flash_inputs(Hq, Hkv, Dh, torch.bfloat16, seed=5)
        ms, src, ev = time_kernel(lambda: run_flash(inp, False), "flash_verify_kernel")
        plain = time_events(lambda: run_flash(inp, True), 10)
        lib = time_events(sdpa_call(inp), 20)
        bnd = rl.flash_bound(inp)
        bounds[f"flash {label} dh{Dh}"] = bnd
        log(f"[8 time] flash {label} Dh {Dh}: {ms:.4f} ms ({src}; {ev:.4f} ms by CUDA "
            f"events; {pre_redesign_text(f'flash {label} dh{Dh}', ms)}), plain {plain:.4f} ms, "
            f"{bound_text(bnd)}, library (scaled_dot_product_attention) {lib:.4f} ms {sig}")
        if label != "1B dense target":
            rows.append(kernel_row("flash_verify", Dh, "src/repro_torch/csrc/flash_verify.cu",
                                   "src/repro/kernels/flash/kernel.py:69", launches, max_err,
                                   ms, plain, bnd, lib))
        layer_times[f"flash {label}"] = dict(ms=ms, events_ms=ev, plain_ms=plain,
                                             library_ms=lib, bound_ms=bnd[0], bound_by=bnd[1])
    layer_times["bounds"] = {k: dict(bound_ms=b[0], bound_by=b[1], bytes_ms=b[2])
                             for k, b in bounds.items()}
    layer_times["float32"] = float32_times(cfgs, sig)
    return rows, layer_times


def zoo_kernel_times(cfgs, launches, max_err, bounds, sig):
    """Phase 8 at the zoo's query-head groups and head dims (bf16, prefix
    4096, S 8192, T 31): routing and nsa_verify (exact C=2 and approx C=4,
    full and partial; the paged refresh case where a zoo path runs paged).
    Rows: routing, exact C=2 full / partial and, at Gq 16, paged partial;
    then flash at the drafts' head dims (beside SDPA)."""
    from repro_torch.analysis import roofline as rl
    rows = []
    verify_src = "src/repro_torch/csrc/nsa_verify.cu"
    for label, Dh, Hq, Hkv in ZOO_SHAPES:
        gq = Hq // Hkv
        cfg = zoo_kernel_cfg(cfgs, Dh, Hq, Hkv)
        inp = verify_inputs(cfg, torch.bfloat16, seed=2)
        tag = f"{label} Gq {gq} Dh {Dh}"
        ms, src, ev = time_kernel(lambda: run_routing(cfg, inp, False), "routing_kernel")
        plain = time_events(lambda: run_routing(cfg, inp, True), 5)
        bnd = rl.routing_bound(cfg, inp)
        bounds[f"routing dh{Dh} gq{gq}"] = bnd
        log(f"[8 time] routing {tag}: {ms:.4f} ms ({src}; {ev:.4f} ms by CUDA events), plain "
            f"{plain:.4f} ms, {bound_text(bnd)}, library call: none {sig}")
        rows.append(kernel_row("routing", Dh, "src/repro_torch/csrc/routing.cu",
                               "src/repro/kernels/routing/kernel.py:70", launches, max_err,
                               ms, plain, bnd, gq=gq))
        cases = [(c, None) for c in VERIFY_CASES[:4]]
        if gq == 16:
            cases.append((VERIFY_CASES[1], paged_pool(cfg, inp, 1, holes=False, seed=3)))
        for (case, C, mode, full, branch), pool in cases:
            args = verify_layouts(cfg, inp, C, mode, pool)
            oc = inp["o_cmp_in"] if not full else None
            ms, src, ev = time_kernel(lambda: run_verify(cfg, args, full, oc, False),
                                      "nsa_verify_kernel")
            plain = time_events(lambda: run_verify(cfg, args, full, oc, True), 3)
            bnd = rl.verify_bound(cfg, inp, args, full)
            what = ("paged " if pool else "") + case
            bounds[f"nsa_verify {what} dh{Dh} gq{gq}"] = bnd
            log(f"[8 time] nsa_verify {what} {tag} ({C * gq} rows, "
                f"{-(-C * gq // 16)} row tiles): {ms:.4f} ms ({src}; {ev:.4f} ms by CUDA "
                f"events), plain {plain:.4f} ms, {bound_text(bnd)}, library call: none {sig}")
            if mode == "exact":
                key = ("nsa_verify_paged" if pool else
                       "nsa_verify_full" if full else "nsa_verify_partial")
                rows.append(kernel_row(key, Dh, verify_src,
                                       "src/repro/kernels/nsa_verify/kernel.py:156", launches,
                                       max_err, ms, plain, bnd, gq=gq))
        del inp, cases
        free()
    for label, Hq, Hkv, Dh in DRAFT_FLASH_CASES:
        inp = flash_inputs(Hq, Hkv, Dh, torch.bfloat16, seed=5)
        ms, src, ev = time_kernel(lambda: run_flash(inp, False), "flash_verify_kernel")
        plain = time_events(lambda: run_flash(inp, True), 10)
        lib = time_events(sdpa_call(inp), 20)
        bnd = rl.flash_bound(inp)
        bounds[f"flash {label} dh{Dh}"] = bnd
        log(f"[8 time] flash {label} Dh {Dh}: {ms:.4f} ms ({src}; {ev:.4f} ms by CUDA "
            f"events), plain {plain:.4f} ms, {bound_text(bnd)}, library "
            f"(scaled_dot_product_attention) {lib:.4f} ms {sig}")
        rows.append(kernel_row("flash_verify", Dh, "src/repro_torch/csrc/flash_verify.cu",
                               "src/repro/kernels/flash/kernel.py:69", launches, max_err,
                               ms, plain, bnd, lib))
    return rows


def float32_times(cfgs, sig):
    """The redesigned kernels with float32 K/V (the float32 equality runs):
    device time per launch (profiler; CUDA events beside) at the bf16 rows'
    shapes, bound at the float32 CUDA-core rate. {case: numbers}."""
    from repro_torch.analysis import roofline as rl
    out = {}

    def record(key, fn, name, bnd):
        ms, src, ev = time_kernel(fn, name)
        out[key] = dict(ms=ms, source=src, events_ms=ev, bound_ms=bnd[0], bound_by=bnd[1])
        log(f"[8 time f32] {key}: {ms:.4f} ms ({src}; {ev:.4f} ms by CUDA events), "
            f"{bound_text(bnd)} {sig}")

    for Dh, cfg in cfgs.items():
        inp = verify_inputs(cfg, torch.float32, seed=2)
        record(f"routing dh{Dh}", lambda: run_routing(cfg, inp, False), "routing_kernel",
               rl.routing_bound(cfg, inp))
        for label, C, mode, full, branch in VERIFY_CASES:
            args = verify_layouts(cfg, inp, C, mode)
            oc = inp["o_cmp_in"] if (not full and branch == "all") else None
            record(f"nsa_verify {label} dh{Dh}",
                   lambda: run_verify(cfg, args, full, oc, False, branch), "nsa_verify_kernel",
                   rl.verify_bound(cfg, inp, args, full, branch))
        pool = paged_pool(cfg, inp, 1, holes=False, seed=3)
        args = verify_layouts(cfg, inp, 2, "exact", pool)
        record(f"nsa_verify paged exact C=2 partial dh{Dh}",
               lambda: run_verify(cfg, args, False, inp["o_cmp_in"], False), "nsa_verify_kernel",
               rl.verify_bound(cfg, inp, args, False))
        del inp, pool
        free()
    for label, Hq, Hkv, Dh in FLASH_CASES:
        inp = flash_inputs(Hq, Hkv, Dh, torch.float32, seed=5)
        record(f"flash {label} dh{Dh}", lambda: run_flash(inp, False), "flash_verify_kernel",
               rl.flash_bound(inp))
    return out


if __name__ == "__main__":
    sys.exit(main())
