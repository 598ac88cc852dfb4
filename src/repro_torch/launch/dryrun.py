"""Dry run of the cell matrix on one card — the counterpart of
``repro.launch.dryrun``, which lowers and compiles every (architecture x
input shape x mesh) cell on placeholder devices.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ssv-nsa-1b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ssv-nsa-1b \
      --shape decode_32k,long_500k --run          # on the card
  ... --force     re-write cells whose record already exists

One card has no mesh and no placeholder compile. ``--list`` prints the 12 x
4 matrix with each cell's static bytes (``launch.specs.cell_bytes``, on the
``meta`` device, so it runs on the CPU), the largest batch that fits one
80 GiB card and its analytic ``Roofline`` row (``analysis.roofline``). With
no ``--run`` each selected cell's record (the same numbers) is written to
``<--out>/static/<arch>__<shape>.json``.

``--run`` is for the card only (without one it raises; it never falls back
to the CPU), for decode cells whose static bytes fit the card at batch 1
and for prefill cells. A prefill cell (``measure_prefill``) runs
``model.prefill`` over ``--batch`` rows (default: the most whose static
bytes fit) one row at a time, timed and profiled, and records its wall,
busy time, peak memory and ``Roofline`` row. A decode cell builds the cell at full width from ``--seed`` (target and its
``draft_config`` draft), fills both caches to ``seq_len`` — the JAX dry
run's semantics, the cache is FULL — with seeded random K/V rows, the
target's compressed blocks being ``nsa.compress_kv`` of those rows (in
chunks), and then runs, on the D4/k2 tree (T = 31) at positions ``seq_len
...``: one Strict and one Approx+Reuse ``model.verify_step``, the draft's
tree expansion (its ``verify_step`` passes through the flash kernel) and
``model.decode_step``. Each step runs once to warm up, once timed on the
host clock (synchronised) and once under the profiler (device busy time);
the record holds wall and busy time per step, the port's kernel launches
per step, peak device memory, and the cell's ``Roofline`` row at batch 1,
checked against the card's ``total_memory``. It goes to
``<--out>/run/<arch>__<shape>.json``.

Across ranks (the JAX dry run's sequence-sharded decode of batch-1 cells):
``--list --world N`` prints each decode cell's static bytes per rank
(``rank_bytes``: the target's weights whole, its cache split by sequence
under ``sharding.cache_specs(shard_sequence=True)``) and the cells that fit
N cards but not one. ``--run --world N --backend {nccl,gloo}`` spawns N
ranks (``run_sharded``) that each fill only their slice of the target's
cache, as ``fill_caches`` fills the whole, and serve one
``nsa_sharded.decode_step_sharded`` token, then three timed and one
profiled; each rank's record (wall, busy, NCCL time, peak, all-reduces per
token) goes to ``<--out>/world/<arch>__<shape>__<N><backend>/``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --list --world 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --run --world 4 \
      --backend nccl --arch ssv-nsa-8b --shape long_500k   # four cards

The ``train_4k`` cells across ranks (the JAX dry run lowers them on a mesh
under ``param_specs``): ``--list --world N [--model M]`` also prints each
train cell's bytes per rank (``train_rank_bytes``: the local shapes under
``param_specs`` on ``elastic.plan_mesh(N, prefer_model=M)`` of the weights,
their gradients and two float32 moments) and the train cells that fit N
cards but not one. ``--run --world N`` also takes train cells
(``run_train_sharded``): each rank builds its blocks of the state from
``--seed`` one layer at a time (``runtime.sharded.init_state``) and runs
``make_train_step(cfg, tcfg, mesh)`` once to warm up, three times timed
(``--steps``) and once profiled, on one 4,096-token sequence per data rank (the cell's
global batch of 256 cut to the data ranks' count: ``reduced`` in the
record). With ``--model M`` > 1 each rank computes its positions of its
row (``sharding.seq_chunk``: 2,048 of 4,096 at M = 2). Each rank's record
(the positions, loss, grad norm, step wall, busy time, NCCL time, peak,
weight gathers and reductions and the activation collectives along
``model`` per step with their bytes, split into the attention layers'
K/V, the recurrent layers' state carries and the MoE ids, the sLSTM
relays' idle steps, model-FLOPs share) goes to
``<--out>/world/<arch>__train_4k__<N>x<M><backend>/``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --list --world 4 --model 2
  PYTHONPATH=src python -m repro_torch.launch.dryrun --run --world 4 --model 2 \
      --backend nccl --arch ssv-nsa-8b --shape train_4k   # four cards

The serve cells across ranks (the JAX dry run's ``prefill_32k`` and batched
``decode_32k``: ``model.prefill`` / ``model.decode_step`` under
``param_specs``, the caches under ``cache_specs(shard_sequence=False)``):
``--list --world N --model M`` adds each prefill and batched decode cell's
bytes per rank at its global batch (``serve_rank_bytes``) and the ones that
fit N cards but not one. ``--run --world N --model M`` takes them
(``run_serve_sharded``): each rank draws its weight blocks
(``runtime.sharded.ServeWeights``) and its rows of the global batch (or
``--batch``, recorded as ``reduced``); a prefill cell runs one
``prefill_sharded`` pass, timed, and one row's pass profiled; a decode cell
fills its slices of the cache and serves one ``decode_step_sharded`` token, three
timed and one profiled. Records (walls, busy and NCCL time, collectives,
gathered bytes, peak, rows) go to
``<--out>/world/<arch>__<shape>__<N>x<M><backend>/``. Every arch runs:
attention (NSA, dense or sliding-window) and MoE blocks each over its
native attention, an arch with a frontend with its frames in front of the
tokens (``cell_frontend``, as in the one-card prefill and the train
cells), and the recurrent archs (recurrentgemma-9b, xlstm-125m) with their
states passed along the ``model`` ranks in the prefill
(``models.recurrent_sharded``) and stepped on each rank's rows in the
decode. The batch-1 sequence-sharded decode (``--world N`` on a
``long_500k`` cell) takes the NSA targets and the recurrent archs, which
run natively: their windowed K/V split over every rank, the states whole
on each. ``fill_caches`` fills K/V and compressed caches; recurrent states
keep their initial values, in the records as on one card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --run --world 4 --model 2 \
      --backend nccl --arch ssv-nsa-8b --shape prefill_32k  # four cards
  PYTHONPATH=src python -m repro_torch.launch.dryrun --run --world 4 --model 2 \
      --backend nccl --arch ssv-nsa-1b --shape decode_32k   # four cards
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import configs as cfglib
from repro_torch.analysis import roofline as rl
from repro_torch.bridge import init_params
from repro_torch.config import SHAPES, MeshConfig, ModelConfig, ShapeConfig, SSVConfig, TrainConfig
from repro_torch.core import draft as draft_lib
from repro_torch.core import planner as planner_lib
from repro_torch.core.tree import build_topology
from repro_torch.device import resolve_device
from repro_torch.kernels import LaunchCounter
from repro_torch.launch import sharding, specs
from repro_torch.models import model
from repro_torch.models import nsa as nsa_lib
from repro_torch.models import prefill_sharded, recurrent

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESH = "card"                 # one card, no mesh
CMP_CHUNK = 4096              # compressed blocks built per compress_kv call


# ---------------------------------------------------------------- static cells
def static_record(arch_id: str, shape_name: str,
                  capacity: float = rl.HBM_PER_CARD) -> Dict:
    """The cell's static bytes at batch 1, the largest batch that fits
    ``capacity`` and the analytic ``Roofline`` row at that batch (at batch 1
    when none fits)."""
    shape = specs.SHAPE_BY_NAME[shape_name]
    cfg, over = specs.cell_config(arch_id, shape_name)
    fit = specs.fit_batch(arch_id, shape_name, capacity)
    b = max(fit, 1)
    at = specs.cell_bytes(arch_id, shape_name, b)
    cost = rl.step_cost(cfg, shape, batch=b, weight_bytes=specs.param_bytes(cfg))
    roof = rl.build(arch_id, dataclasses.replace(shape, global_batch=b), MESH, 1, cfg, cost,
                    at["total"], capacity)
    return {"arch": arch_id, "shape": shape_name, "kind": shape.kind, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch, "config_name": cfg.name, "overrides": over,
            "params": cfg.param_count(), "active_params": cfg.active_param_count(),
            "bytes_batch1": specs.cell_bytes(arch_id, shape_name, 1), "fit_batch": fit,
            "batch": b, "bytes": at, "roofline": roof.row(), "capacity_bytes": capacity}


def list_cells(archs: List[str], shapes: List[str]) -> List[Dict]:
    """Print the cell matrix with its fit table; returns the records."""
    gb = 1e9
    print(f"{'arch':22s} {'shape':12s} {'kind':8s} {'weights GB':>10s} {'cache GB':>9s} "
          f"{'B=1 GB':>8s} {'fit B':>6s} {'of':>4s} {'bottleneck':>10s} {'step ms':>9s}")
    recs = []
    for a in archs:
        for s in shapes:
            r = static_record(a, s)
            one = r["bytes_batch1"]
            cache = one.get("target_cache", 0) + one.get("draft_cache", 0)
            roof = r["roofline"]
            step_ms = 1e3 * max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
            print(f"{a:22s} {s:12s} {r['kind']:8s} {one['weights'] / gb:10.2f} "
                  f"{cache / gb:9.2f} {one['total'] / gb:8.2f} {r['fit_batch']:6d} "
                  f"{r['global_batch']:4d} {roof['bottleneck']:>10s} {step_ms:9.3f}")
            recs.append(r)
    print(f"{len(recs)} cells; {sum(r['fit_batch'] > 0 for r in recs)} fit one card "
          f"({rl.HBM_PER_CARD / 2 ** 30:.0f} GiB) at batch >= 1; activations not reckoned")
    return recs


# ---------------------------------------------------------------- full cells on the card
def strict_ssv() -> SSVConfig:
    return SSVConfig(tree_depth=4, tree_width=2)


def approx_reuse_ssv(num_layers: int) -> SSVConfig:
    return SSVConfig(tree_depth=4, tree_width=2, group_size=4, group_mode="approx",
                     refresh_schedule=planner_lib.default_schedule(num_layers),
                     precision_class="Approx+Reuse")


FILL_CHUNK = 8192             # K/V rows drawn from one seeded generator
DRAFT_FILL = 7919             # the draft's fill seed, past the target's


def _chunk_seed(seed: int, layer: int, chunk: int, row: int = 0) -> int:
    base = ((seed * 1_000_003 + layer) * 1_000_033 + chunk) % 2 ** 62
    return base if row == 0 else (base * 1_000_037 + row) % 2 ** 62


def draw_rows(like, seed: int, layer: int, a: int, b: int, row0: int = 0):
    """Global K/V rows ``a .. b`` of ``layer`` for the batch rows ``row0
    ..`` (``like``'s count; standard normal, ``like``'s dtype and device):
    each ``FILL_CHUNK`` rows of each batch row come from a generator of
    their own, seeded by (seed, layer, chunk, batch row) and always drawn
    whole, so a row is the same whichever slice of the cache asks for it.
    Batch row 0 keeps the seed of (seed, layer, chunk)."""
    B, _, H, Dh = like.shape
    ks, vs = [], []
    for c in range(a // FILL_CHUNK, (b - 1) // FILL_CHUNK + 1):
        base = c * FILL_CHUNK
        lo, hi = max(a, base) - base, min(b, base + FILL_CHUNK) - base
        kr, vr = [], []
        for r in range(row0, row0 + B):
            g = torch.Generator(like.device)
            g.manual_seed(_chunk_seed(seed, layer, c, r))
            shape = (1, FILL_CHUNK, H, Dh)
            kr.append(torch.randn(shape, generator=g, device=like.device,
                                  dtype=like.dtype)[:, lo:hi])
            vr.append(torch.randn(shape, generator=g, device=like.device,
                                  dtype=like.dtype)[:, lo:hi])
        ks.append(torch.cat(kr))
        vs.append(torch.cat(vr))
    return torch.cat(ks, 1), torch.cat(vs, 1)


@torch.no_grad()
def fill_caches(params, cfg, caches, seq_len: int, seed: int) -> None:
    """Fill ``caches`` to ``seq_len`` committed tokens: K/V rows from
    ``draw_rows`` (seeded per (layer, chunk, batch row)), each NSA layer's
    compressed blocks ``nsa.compress_kv`` of its rows, ``CMP_CHUNK`` blocks
    per call at fixed block boundaries, one batch row at a time. Recurrent
    states keep their initial values. ``params``: whole weights or a
    ``runtime.sharded.ServeWeights`` (each layer gathered as it is filled).

    ``caches`` may hold a slice of each layer: ``caches["global_rows"]``
    (``nsa_sharded.init_local_caches``) gives the K/V and compressed rows it
    holds and its batch rows. A slice fills only its own rows, each equal to
    the same row of a whole cache's fill: a compressed chunk whose tokens
    leave the slice draws those rows again."""
    nsa = cfg.nsa
    rows = caches.get("global_rows")
    row0 = rows["batch"][0] if rows and "batch" in rows else 0
    mix_of = (lambda i: params.layer_params(i, "mix")) if hasattr(params, "layer_params") \
        else (lambda i: params["layers"][i]["mix"])
    for li, c in enumerate(caches["layers"]):
        if "kv" not in c:
            continue
        k, v = c["kv"]["k"], c["kv"]["v"]
        r0, r1 = rows["kv"] if rows else (0, k.shape[1])
        top = min(r1, seq_len)
        for ch in range(r0 // FILL_CHUNK, (top - 1) // FILL_CHUNK + 1) if top > r0 else ():
            a, b = max(r0, ch * FILL_CHUNK), min(top, (ch + 1) * FILL_CHUNK)
            k[:, a - r0:b - r0], v[:, a - r0:b - r0] = draw_rows(k, seed, li, a, b, row0)
        if "cmp" not in c:
            continue
        c0, c1 = rows["cmp"] if rows else (0, c["cmp"]["k_cmp"].shape[1])
        ncb = nsa_lib.num_cmp_blocks(seq_len, nsa)
        last = min(c1, ncb)
        mix = mix_of(li)        # a collective: every rank gathers, whatever its slice holds
        for j in range(c0 // CMP_CHUNK, (last - 1) // CMP_CHUNK + 1) if last > c0 else ():
            n0, n1 = j * CMP_CHUNK, min(ncb, (j + 1) * CMP_CHUNK)
            a, b = n0 * nsa.cmp_stride, (n1 - 1) * nsa.cmp_stride + nsa.cmp_block
            lo, hi = max(n0, c0), min(n1, c1)
            for r in range(k.shape[0]):
                if r0 <= a and b <= top:
                    kk, vv = k[r:r + 1, a - r0:b - r0], v[r:r + 1, a - r0:b - r0]
                else:
                    kk, vv = draw_rows(k[r:r + 1], seed, li, a, b, row0 + r)
                kc, vc = nsa_lib.compress_kv(mix, kk, vv, nsa)
                c["cmp"]["k_cmp"][r, lo - c0:hi - c0] = kc[0, lo - n0:hi - n0]
                c["cmp"]["v_cmp"][r, lo - c0:hi - c0] = vc[0, lo - n0:hi - n0]
        del mix
    caches["length"].fill_(seq_len)


def cell_tokens(cfg, T: int, seed: int, device) -> torch.Tensor:
    """The cell's (1, T) tree tokens, from a generator of their own."""
    g = torch.Generator(device)
    g.manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (1, T), generator=g, device=device)


class FullCell:
    """A decode cell at full width on the card, batch 1: target and draft
    weights from ``seed``, both caches full to ``seq_len`` (``CACHE_SLACK``
    more slots), a D4/k2 tree of seeded tokens at positions ``seq_len +
    depth``. ``verify``, ``draft`` and ``decode`` are the steps ``--run``
    measures; ``decode`` commits one token each call. ``dtype`` replaces
    the config's (both models), e.g. "float32" for an equality check
    free of bf16 rounding."""

    def __init__(self, arch_id: str, shape_name: str, seed: int = 0, device=None,
                 dtype: Optional[str] = None):
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise RuntimeError("dryrun --run measures a cell on the card; it has no CPU mode")
        shape = specs.SHAPE_BY_NAME[shape_name]
        if shape.kind != "decode":
            raise ValueError(f"--run drives decode cells; {shape_name} is a {shape.kind} cell")
        capacity = torch.cuda.get_device_properties(dev).total_memory
        cfg = specs.cell_config(arch_id, shape_name)[0]
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        if specs.config_bytes(cfg, shape, 1)["total"] > capacity:
            raise ValueError(f"{arch_id} x {shape_name} ({cfg.dtype}) does not fit one card "
                             "at batch 1")
        self._build(arch_id, cfg, shape, seed, dev, capacity)

    def _build(self, arch_id: str, cfg, shape, seed: int, dev, capacity: float) -> None:
        """Weights, filled caches and the tree on ``dev`` (the CPU tests
        build a reduced cell this way; ``--run`` only ever on the card)."""
        self.arch, self.shape, self.device, self.capacity = arch_id, shape, dev, capacity
        self.cfg = cfg
        self.dcfg = draft_lib.draft_config(self.cfg)
        g = torch.Generator(dev)
        g.manual_seed(seed)
        self.params = init_params(self.cfg, g, dev)
        self.dparams = init_params(self.dcfg, g, dev)
        max_len = shape.seq_len + specs.CACHE_SLACK
        self.caches = model.init_caches(self.cfg, 1, max_len, dev)
        self.dcaches = model.init_caches(self.dcfg, 1, max_len, dev)
        fill_caches(self.params, self.cfg, self.caches, shape.seq_len, seed)
        fill_caches(self.dparams, self.dcfg, self.dcaches, shape.seq_len, seed + DRAFT_FILL)
        self.topo = build_topology(4, 2, "bfs")
        self.tree = draft_lib.TreeTensors(self.topo, dev)
        self.tokens = cell_tokens(self.cfg, self.topo.num_nodes, seed, dev)
        self.positions = (self.tree.depths[None] + shape.seq_len).to(torch.int32)
        self.tree_mask = self.tree.mask[None]

    def verify(self, ssv: SSVConfig):
        """The target's tree verify: (logits (1, T, V), updates)."""
        return model.verify_step(self.params, self.cfg, self.caches, self.tokens,
                                 self.positions, self.tree_mask, self.topo.parents, ssv)

    def draft(self):
        """The draft's tree expansion from the root token: levels + 1
        verify passes (the engine's draft work per step)."""
        def dverify(caches, tk, pos, tm):
            return model.verify_step(self.dparams, self.dcfg, caches, tk, pos, tm,
                                     self.topo.parents)
        return draft_lib.expand_tree(dverify, self.dcaches, self.tree, self.tokens[:, 0])

    def decode(self):
        """One ``decode_step`` of the root token; commits it. Its logits."""
        logits, self.caches = model.decode_step(self.params, self.cfg, self.caches,
                                                self.tokens[:, :1])
        return logits


def _profile(fn, top: int = 6) -> Dict:
    """One call of ``fn`` under the profiler: device busy time (every
    kernel and copy), device kernels, the time in NCCL's collective
    kernels (part of the busy time, their wait for the other ranks
    included), and the ``top`` kernels by time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = sorted(((getattr(ev, "self_device_time_total", 0.0) or
                    getattr(ev, "self_cuda_time_total", 0.0)) / 1e3, ev.count, ev.key[:80])
                  for ev in prof.key_averages()
                  if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA)
    return {"device_busy_ms": sum(k[0] for k in kern),
            "device_kernels": sum(k[1] for k in kern),
            # NCCL's kernels spin on the device until every rank arrives
            "collective_ms": sum(k[0] for k in kern if k[2].startswith("nccl")),
            "top": [{"ms": ms, "launches": n, "name": name} for ms, n, name in kern[::-1][:top]]}


def measure(cell: FullCell, outputs: Optional[Dict] = None) -> Dict:
    """Run ``cell``'s steps (each warm, timed, profiled; the decode last, as
    it commits) and return the record; ``outputs`` (a dict) receives the
    first Strict verify's logits and the first decode's, at the same cache."""
    steps = [("verify Strict", lambda: cell.verify(strict_ssv())),
             ("verify Approx+Reuse", lambda: cell.verify(approx_reuse_ssv(cell.cfg.num_layers))),
             ("draft expand_tree", cell.draft),
             ("decode_step", cell.decode)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = {}
    for name, fn in steps:
        snap = LaunchCounter.snapshot()
        first = fn()
        torch.cuda.synchronize()
        launches = {c.name: n for c, n in LaunchCounter.since(snap).items()}
        if outputs is not None and name in ("verify Strict", "decode_step"):
            outputs[name] = (first[0] if isinstance(first, tuple) else first).float()
        del first
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rec[name] = {"wall_ms": wall, **_profile(fn), "launches": launches}
    peak = torch.cuda.max_memory_allocated()
    shape1 = dataclasses.replace(cell.shape, global_batch=1)
    cost = rl.step_cost(cell.cfg, shape1, batch=1,
                        weight_bytes=specs.param_bytes(cell.cfg))
    roof = rl.build(cell.arch, shape1, MESH, 1, cell.cfg, cost, peak, cell.capacity)
    dec_s = rec["decode_step"]["wall_ms"] / 1e3
    return {"arch": cell.arch, "shape": cell.shape.name, "seq_len": cell.shape.seq_len,
            "batch": 1, "config_name": cell.cfg.name, "draft_config": cell.dcfg.name,
            "device": torch.cuda.get_device_name(cell.device), "steps": rec,
            "peak_bytes": peak, "capacity_bytes": cell.capacity,
            "static_bytes": specs.cell_bytes(cell.arch, cell.shape.name, 1),
            "roofline": roof.row(), "decode_bound_ms": roof.step_time_s * 1e3,
            "decode_model_flops_share": rl.flops_share(rl.model_flops(cell.cfg, shape1), dec_s)}


# ---------------------------------------------------------------- prefill cells
def cell_prompt(cfg, rows, seq: int, seed: int, device) -> torch.Tensor:
    """Rows ``rows`` (range) of a prefill cell's prompt, (len(rows), seq):
    each row from a generator of its own, seeded by (seed, row), so a rank
    draws only its rows and they equal the same rows of the whole batch."""
    out = []
    for r in rows:
        g = torch.Generator(device)
        g.manual_seed(_chunk_seed(seed + 1, 0, 0, r))
        out.append(torch.randint(0, cfg.vocab_size, (1, seq), generator=g, device=device))
    return torch.cat(out)


def cell_frontend(cfg, arch_id: str, rows, seed: int, device) -> Optional[torch.Tensor]:
    """Rows ``rows`` (range) of a cell's frontend input, (len(rows),
    ``configs.frontend_len(arch_id)``, ``cfg.frontend_dim``) in bf16 (the
    JAX dry run's ``fe``), each row standard normal from a generator of its
    own, seeded by (seed, row), so a rank draws only its rows and they equal
    the same rows of the whole batch. None for an arch without a frontend."""
    F = cfglib.frontend_len(arch_id)
    if not F or not cfg.frontend_dim:
        return None
    out = []
    for r in rows:
        g = torch.Generator(device)
        g.manual_seed(_chunk_seed(seed + 3, 0, 0, r))
        out.append(torch.randn((1, F, cfg.frontend_dim), generator=g, device=device))
    return torch.cat(out).to(torch.bfloat16)


def measure_prefill(arch_id: str, shape_name: str, batch: int = 0, seed: int = 0,
                    device=None) -> Dict:
    """A prefill cell on one card (``--run``): weights from ``seed``,
    ``batch`` rows of the cell's prompt (default: the most whose static
    bytes fit the card), and one ``model.prefill`` pass that fills caches
    of ``batch`` rows to ``seq_len`` (``CACHE_SLACK`` slots more) with the
    last position's logits — one row at a time, to bound the attention's
    (chunk, S) score tensors (a row's prefill is independent of the
    others'). The pass runs once, timed on the host clock, and then row 0's
    prefill once under the profiler (the profiler doubled the wall of a
    profiled 32K pass on the H100, so it stays out of the timed one); the
    record holds the pass's wall, the profiled row's busy time, peak memory
    and the ``Roofline`` row at ``batch``. An arch with a frontend
    (``cell_frontend``) prefills its frames in front of the tokens, as the
    JAX cell does: its caches then hold ``frontend_len + seq_len``
    positions, within ``CACHE_SLACK``. An sLSTM layer replays its captured
    chunks (``recurrent.SlstmGraphs``), as the serving engines' prefill
    does."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("dryrun --run measures a cell on the card; it has no CPU mode")
    shape = specs.SHAPE_BY_NAME[shape_name]
    if shape.kind != "prefill":
        raise ValueError(f"{shape_name} is a {shape.kind} cell, not a prefill cell")
    capacity = torch.cuda.get_device_properties(dev).total_memory
    cfg = specs.cell_config(arch_id, shape_name)[0]
    fit = specs.fit_batch(arch_id, shape_name, capacity)
    batch = batch or fit
    if batch < 1 or specs.cell_bytes(arch_id, shape_name, batch)["total"] > capacity:
        raise ValueError(f"{arch_id} x {shape_name} at batch {batch} does not fit one card")
    t0 = time.time()
    g = torch.Generator(dev)
    g.manual_seed(seed)
    params = init_params(cfg, g, dev)
    tokens = cell_prompt(cfg, range(batch), shape.seq_len, seed, dev)
    frames = cell_frontend(cfg, arch_id, range(batch), seed, dev)
    n_frames = 0 if frames is None else frames.shape[1]
    max_len = shape.seq_len + specs.CACHE_SLACK
    caches = model.init_caches(cfg, batch, max_len, dev)
    graphs = recurrent.SlstmGraphs(dev) if "slstm" in cfg.layer_kinds() else None
    build_s = time.time() - t0
    out = []

    def one_pass(rows):
        logits = []
        for b in rows:
            hidden, c = model.prefill(params, cfg, tokens[b:b + 1], max_len,
                                      None if frames is None else frames[b:b + 1],
                                      slstm_graphs=graphs)
            logits.append(model.logits_fn(params, cfg, hidden[:, -1:]).float())
            del hidden
            for dst, src in zip(caches["layers"], c["layers"]):
                for part in src:
                    for name, t in src[part].items():
                        dst[part][name][b] = t[0]
            del c
        caches["length"].fill_(n_frames + shape.seq_len)
        out.append(torch.cat(logits))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one_pass(range(batch))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    prof = _profile(lambda: one_pass(range(1)))
    logits = out[0]
    shape_b = dataclasses.replace(shape, global_batch=batch)
    cost = rl.step_cost(cfg, shape_b, batch=batch, weight_bytes=specs.param_bytes(cfg))
    roof = rl.build(arch_id, shape_b, MESH, 1, cfg, cost, peak, capacity)
    return {"arch": arch_id, "shape": shape_name, "kind": "prefill", "seq_len": shape.seq_len,
            "frontend_frames": n_frames, "batch": batch, "fit_batch": fit, "config_name": cfg.name,
            "device": torch.cuda.get_device_name(dev), "build_s": build_s,
            "steps": {"prefill": {"wall_ms": wall, "profiled_rows": 1, **prof}},
            "peak_bytes": peak,
            "capacity_bytes": capacity, "static_bytes": specs.cell_bytes(arch_id, shape_name, batch),
            "logits_finite": bool(torch.isfinite(logits).all()),
            "argmax": logits.argmax(-1)[:, 0].tolist(), "roofline": roof.row(),
            "bound_ms": roof.step_time_s * 1e3,
            "model_flops_share": rl.flops_share(rl.model_flops(cfg, shape_b), wall / 1e3)}


def run_cell(arch_id: str, shape_name: str, out_dir: Path, force: bool = False,
             run: bool = False, seed: int = 0, inspect: Optional[Callable] = None,
             batch: int = 0) -> Dict:
    """One cell's record: static (no ``run``) or measured on the card
    (``run``: a decode cell's ``FullCell`` at batch 1, a prefill cell's
    ``measure_prefill`` at ``batch``, 0 for the most that fit). Reads an
    existing record unless ``force``; writes it as JSON under ``out_dir``.
    ``inspect(cell, record, outputs)``, called on a measured decode cell
    before it is freed, returns what goes under the record's ``"checks"``
    (``outputs``: the first Strict verify's and decode's logits)."""
    path = Path(out_dir) / ("run" if run else "static") / f"{arch_id}__{shape_name}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())
    t0 = time.time()
    if run and specs.SHAPE_BY_NAME[shape_name].kind == "prefill":
        rec = measure_prefill(arch_id, shape_name, batch, seed)
    elif run:
        cell = FullCell(arch_id, shape_name, seed)
        build_s = time.time() - t0
        outputs = {}
        rec = {"build_s": build_s, **measure(cell, outputs)}
        if inspect is not None:
            rec["checks"] = inspect(cell, rec, outputs)
        del cell, outputs
        torch.cuda.empty_cache()
    else:
        rec = static_record(arch_id, shape_name)
    rec["wall_s"] = time.time() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


# ---------------------------------------------------------------- across ranks
def world_mesh(world: int) -> MeshConfig:
    """The mesh of ``--world N``: (N, 1) over (data, model); the decode
    splits the sequence over both axes, as the JAX dry run does."""
    return MeshConfig(shape=(world, 1), axes=("data", "model"))


def sharded_decode_ok(cfg) -> bool:
    """Whether ``nsa_sharded.decode_step_sharded`` takes ``cfg`` at batch 1
    with the sequence over every axis: NSA stacks (the attention archs'
    ``long_500k`` cells run their NSA variants) and the recurrent archs,
    which run theirs natively (``long_500k``'s ``"native"``: the windowed
    K/V split, the states whole on every rank)."""
    kinds = set(cfg.layer_kinds())
    if kinds & set(model.RECURRENT_KINDS):
        return prefill_sharded.takes(cfg)
    return cfg.attention == "nsa" and kinds <= {"attn", "moe"}


def rank_bytes(arch_id: str, shape_name: str, world: int) -> Dict:
    """A decode cell's static bytes on each of ``world`` ranks at batch 1
    under ``sharding.cache_specs(shard_sequence=True)``: the target's
    weights whole, its cache split by sequence (``cache_split``, bytes per
    rank) apart from the leaves every rank holds whole
    (``cache_replicated``: the length, recurrent states). No draft: the
    sequence-sharded decode runs the target alone. ``divides`` says whether
    every split leaf divides by ``world``."""
    cfg = specs.cell_config(arch_id, shape_name)[0]
    shape = specs.SHAPE_BY_NAME[shape_name]
    tree = rl.cache_tree(cfg, 1, shape.seq_len + specs.CACHE_SLACK)
    mc = world_mesh(world)
    split = repl = 0
    divides = True
    sizes = dict(zip(mc.axes, mc.shape))
    for key, leaf in sharding.flatten(tree).items():
        sp = sharding.cache_spec(key, tuple(leaf.shape), mc, shard_sequence=True)
        n = 1
        for e in sp:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n *= sizes[a]
        if n == 1:
            repl += leaf.nbytes
        else:
            divides &= leaf.nbytes % n == 0
            split += leaf.nbytes // n
    w = specs.param_bytes(cfg)
    return {"world": world, "weights": w, "cache_split": split, "cache_replicated": repl,
            "target_cache": split + repl, "total": w + split + repl, "divides": divides,
            "sharded_decode": sharded_decode_ok(cfg)}


def train_rank_bytes(arch_id: str, shape_name: str, world: int, model_axis: int = 1) -> Dict:
    """A train cell's static bytes on each of ``world`` ranks on
    ``elastic.plan_mesh(world, prefer_model=model_axis)``: each leaf's local
    shape under ``param_specs`` for the weights, their gradients (the
    weights' dtype) and AdamW's two float32 moments. ``split``: the per-rank
    bytes of the leaves split over every rank; ``partial``: of the rest
    (replicated along some axis), whose whole bytes are ``partial_whole``
    (so ``split * world + partial_whole`` is one card's). ``divides``:
    whether every sharded dimension divides."""
    from repro_torch.runtime.elastic import plan_mesh
    cfg = specs.cell_config(arch_id, shape_name)[0]
    mc = plan_mesh(world, prefer_model=model_axis)
    sizes = dict(zip(mc.axes, mc.shape))
    meta = rl.param_tree(cfg)
    out = dict(weights=0, grads=0, adam_moments=0, split=0, partial=0, partial_whole=0)
    divides = True

    def count(key, leaf, sp):
        nonlocal divides
        n = 1
        for a in sharding.split_axes(sp, mc.axes):
            n *= sizes[a]
        try:
            numel = math.prod(sharding.local_shape(leaf.shape, sp, sizes))
        except ValueError:
            divides, numel = False, -(-leaf.numel() // n)
        w = numel * leaf.element_size()
        out["weights"] += w
        out["grads"] += w
        out["adam_moments"] += 8 * numel
        if n == world:
            out["split"] += 2 * w + 8 * numel
        else:
            out["partial"] += 2 * w + 8 * numel
            out["partial_whole"] += 2 * leaf.nbytes + 8 * leaf.numel()
    sharding.map_specs(count, meta, sharding.param_specs(meta, mc))
    out["total"] = out["weights"] + out["grads"] + out["adam_moments"]
    return dict(world=world, mesh=list(mc.shape), axes=list(mc.axes), divides=divides, **out)


@functools.lru_cache(maxsize=128)
def _split_bytes(cfg, mc: MeshConfig, part: str, batch: int, max_len: int) -> Dict:
    """The per-rank bytes of ``cfg``'s weights under ``param_specs`` (part
    "weights") or of its caches at ``batch`` x ``max_len`` under
    ``cache_specs(shard_sequence=False)`` ("cache") on the mesh ``mc``:
    {"bytes", "split" (of the leaves split over every rank), "partial" (of
    the rest), "partial_whole" (the rest's whole bytes), "divides"}."""
    sizes = dict(zip(mc.axes, mc.shape))
    out = dict(bytes=0, split=0, partial=0, partial_whole=0, divides=True)

    def count(leaf, sp):
        n = math.prod(sizes[a] for a in sharding.split_axes(sp, mc.axes))
        try:
            numel = math.prod(sharding.local_shape(leaf.shape, sp, sizes))
        except ValueError:
            out["divides"], numel = False, -(-leaf.numel() // n)
        b = numel * leaf.element_size()
        out["bytes"] += b
        if n == mc.num_devices:
            out["split"] += b
        else:
            out["partial"] += b
            out["partial_whole"] += leaf.nbytes
    if part == "weights":
        meta = rl.param_tree(cfg)
        sharding.map_specs(lambda _, t, sp: count(t, sp), meta, sharding.param_specs(meta, mc))
    else:
        for key, leaf in sharding.flatten(rl.cache_tree(cfg, batch, max_len)).items():
            count(leaf, sharding.cache_spec(key, tuple(leaf.shape), mc, shard_sequence=False))
    return out


def serve_rank_bytes(arch_id: str, shape_name: str, world: int, model_axis: int = 1,
                     batch: int = 0) -> Dict:
    """A prefill or batched decode cell's static bytes on each of ``world``
    ranks on ``elastic.plan_mesh(world, prefer_model=model_axis)``, at
    ``batch`` rows (0: the shape's global batch): the weights' local shapes
    under ``param_specs`` and the target cache's under
    ``cache_specs(shard_sequence=False)`` (no draft: the cells across ranks
    serve the target alone). ``split``: the per-rank bytes of the leaves
    split over every rank; ``partial``: of the rest, whose whole bytes are
    ``partial_whole`` (so ``split * world + partial_whole`` is
    ``one_card``'s, the weights and the target cache). ``divides``: whether
    every sharded dimension divides."""
    from repro_torch.runtime.elastic import plan_mesh
    cfg = specs.cell_config(arch_id, shape_name)[0]
    shape = specs.SHAPE_BY_NAME[shape_name]
    B = batch or shape.global_batch
    mc = plan_mesh(world, prefer_model=model_axis)
    w = _split_bytes(cfg, mc, "weights", 0, 0)
    c = _split_bytes(cfg, mc, "cache", B, shape.seq_len + specs.CACHE_SLACK)
    out = {"weights": w["bytes"], "cache": c["bytes"]}
    for k in ("split", "partial", "partial_whole"):
        out[k] = w[k] + c[k]
    divides = w["divides"] and c["divides"]
    one = specs.config_bytes(cfg, shape, B)
    return dict(world=world, mesh=list(mc.shape), axes=list(mc.axes), batch=B, divides=divides,
                total=out["weights"] + out["cache"],
                one_card=one["weights"] + one["target_cache"],
                sharded_serve=prefill_sharded.takes(cfg), **out)


def list_world(archs: List[str], shapes: List[str], world: int,
               model_axis: int = 1) -> List[Dict]:
    """Print each train cell's state bytes per rank (``train_rank_bytes``),
    each decode cell's bytes per rank across ``world`` ranks at batch 1
    (``rank_bytes``), each prefill and batched decode
    cell's at its global batch (``serve_rank_bytes``), and which of the
    cells that do not fit one card fit ``world`` cards."""
    gb = 1e9
    train = [s for s in shapes if specs.SHAPE_BY_NAME[s].kind == "train"]
    recs = []
    if train:
        print(f"{'arch':22s} {'shape':12s} {'mesh':>8s} {'weights/rank GB':>15s} "
              f"{'state/rank GB':>13s} {'1 card':>7s} {f'{world} cards':>8s}")
        for a in archs:
            for s in train:
                r = {"arch": a, "shape": s, **train_rank_bytes(a, s, world, model_axis),
                     "fits_one": specs.fit_batch(a, s) > 0}
                r["fits_world"] = r["divides"] and r["total"] <= rl.HBM_PER_CARD
                mesh = "x".join(map(str, r["mesh"]))
                print(f"{a:22s} {s:12s} {mesh:>8s} {r['weights'] / gb:15.2f} "
                      f"{r['total'] / gb:13.2f} {'yes' if r['fits_one'] else 'no':>7s} "
                      f"{'yes' if r['fits_world'] else 'no':>8s}")
                recs.append(r)
        gained = [f"{r['arch']} x {r['shape']}" for r in recs
                  if not r["fits_one"] and r["fits_world"]]
        print(f"train cells that do not fit one card but fit {world} "
              f"({rl.HBM_PER_CARD / 2 ** 30:.0f} GiB each; weights, gradients and two float32 "
              f"moments under param_specs, activations not reckoned): "
              f"{', '.join(gained) or 'none'}")
    print(f"{'arch':22s} {'shape':12s} {'weights GB':>10s} {'cache/rank GB':>13s} "
          f"{'rank GB':>8s} {'1 card':>7s} {f'{world} cards':>8s} {'sharded decode':>14s}")
    decode = []
    for a in archs:
        for s in shapes:
            if specs.SHAPE_BY_NAME[s].kind != "decode":
                continue
            r = {"arch": a, "shape": s, **rank_bytes(a, s, world),
                 "fits_one": specs.fit_batch(a, s) > 0}
            r["fits_world"] = r["divides"] and r["total"] <= rl.HBM_PER_CARD
            print(f"{a:22s} {s:12s} {r['weights'] / gb:10.2f} {r['target_cache'] / gb:13.2f} "
                  f"{r['total'] / gb:8.2f} {'yes' if r['fits_one'] else 'no':>7s} "
                  f"{'yes' if r['fits_world'] else 'no':>8s} "
                  f"{'yes' if r['sharded_decode'] else 'no':>14s}")
            decode.append(r)
    gained = [f"{r['arch']} x {r['shape']}" for r in decode
              if not r["fits_one"] and r["fits_world"]]
    print(f"decode cells that do not fit one card but fit {world} "
          f"({rl.HBM_PER_CARD / 2 ** 30:.0f} GiB each, weights whole, target cache split by "
          f"sequence): {', '.join(gained) or 'none'}")
    batched = [s for s in shapes if specs.SHAPE_BY_NAME[s].global_batch > 1
               and specs.SHAPE_BY_NAME[s].kind in ("prefill", "decode")]
    served = []
    if batched:
        print(f"{'arch':22s} {'shape':12s} {'mesh':>6s} {'batch':>5s} {'weights/rank GB':>15s} "
              f"{'cache/rank GB':>13s} {'rank GB':>8s} {'1 card GB':>9s} {'1 card':>7s} "
              f"{f'{world} cards':>8s} {'across ranks':>12s}")
        for a in archs:
            for s in batched:
                r = {"arch": a, "shape": s, **serve_rank_bytes(a, s, world, model_axis)}
                r["fits_one"] = r["one_card"] <= rl.HBM_PER_CARD
                r["fits_world"] = r["divides"] and r["total"] <= rl.HBM_PER_CARD
                mesh = "x".join(map(str, r["mesh"]))
                print(f"{a:22s} {s:12s} {mesh:>6s} {r['batch']:5d} {r['weights'] / gb:15.2f} "
                      f"{r['cache'] / gb:13.2f} {r['total'] / gb:8.2f} {r['one_card'] / gb:9.2f} "
                      f"{'yes' if r['fits_one'] else 'no':>7s} "
                      f"{'yes' if r['fits_world'] else 'no':>8s} "
                      f"{'yes' if r['sharded_serve'] else 'no':>12s}")
                served.append(r)
        gained = [f"{r['arch']} x {r['shape']} (batch {r['batch']})" for r in served
                  if not r["fits_one"] and r["fits_world"]]
        print(f"prefill and batched decode cells at their global batch that do not fit one card "
              f"but fit {world} ({rl.HBM_PER_CARD / 2 ** 30:.0f} GiB each; the target's weights "
              f"under param_specs, its cache under cache_specs(shard_sequence=False); the gathered "
              f"layer and activations not reckoned): {', '.join(gained) or 'none'}")
    return recs + decode + served


def sharded_rank(rank: int, world: int, dev, arch_id: str, shape_name: str, seed: int,
                 cfg: Optional[ModelConfig], out_dir: str, timed: int = 3) -> Dict:
    """One rank of ``--run --world N``: the cell's target at full width
    (``cfg`` in place of the cell's config when given; weights from
    ``seed``, whole), this rank's slices of its cache filled
    as ``FullCell`` fills the whole cache, and ``decode_step_sharded`` of
    the cell's root token. The first token's logits and the K/V rows it
    wrote (on the owning rank) go to ``<out_dir>/rank<r>.pt``; then
    ``timed`` tokens on the host clock and one under the profiler.
    Returns the rank's record (also ``<out_dir>/rank<r>.json``)."""
    import torch.distributed as dist
    from repro_torch.models import nsa_sharded
    from repro_torch.runtime.elastic import build_mesh
    shape = specs.SHAPE_BY_NAME[shape_name]
    cfg = cfg or specs.cell_config(arch_id, shape_name)[0]
    if not sharded_decode_ok(cfg):
        raise ValueError(f"{arch_id} x {shape_name}: the batch-1 sharded decode takes NSA "
                         "stacks and the recurrent archs")
    mc = world_mesh(world)
    mesh = build_mesh(mc, dev.type)
    t0 = time.time()
    g = torch.Generator(dev)
    g.manual_seed(seed)
    params = init_params(cfg, g, dev)
    caches = nsa_sharded.init_local_caches(cfg, 1, shape.seq_len + specs.CACHE_SLACK, mesh,
                                           mc.axes, dev)
    fill_caches(params, cfg, caches, shape.seq_len, seed)
    token = cell_tokens(cfg, build_topology(4, 2, "bfs").num_nodes, seed, dev)[:, :1]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    dist.barrier()
    build_s = time.time() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def step():
        return nsa_sharded.decode_step_sharded(params, cfg, mesh, caches, token, mc.axes)[0]

    nsa_sharded.reset_collectives()
    t0 = time.perf_counter()
    logits = step()
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    collectives = nsa_sharded.collectives()
    r0, r1 = caches["global_rows"]["kv"]
    owner = r0 <= shape.seq_len < r1
    written = [(c["kv"]["k"][0, shape.seq_len - r0].float().cpu(),
                c["kv"]["v"][0, shape.seq_len - r0].float().cpu())
               for c in caches["layers"] if "kv" in c] if owner else None
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.save({"logits": logits.float().cpu(), "written": written}, out / f"rank{rank}.pt")
    walls = []
    for _ in range(timed):
        dist.barrier()
        t0 = time.perf_counter()
        step()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    rec = {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(dev),
           "arch": arch_id, "shape": shape_name, "dtype": cfg.dtype, "seq_len": shape.seq_len,
           "rows": [r0, r1], "cmp_rows": list(caches["global_rows"]["cmp"]),
           "owner": owner, "build_s": build_s, "first_wall_ms": first_ms,
           "wall_ms": walls, "collectives_per_token": collectives}
    if dev.type == "cuda":
        dist.barrier()
        rec.update(_profile(step))
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["card"] = torch.cuda.get_device_name(dev)
    (out / f"rank{rank}.json").write_text(json.dumps(rec, indent=1))
    return rec


def run_sharded(arch_id: str, shape_name: str, world: int, backend: str, out_dir: Path,
                seed: int = 0, cfg: Optional[ModelConfig] = None, device_type: str = "cuda",
                timeout: float = 900.0, timed: int = 3,
                threads: Optional[int] = None) -> List[Dict]:
    """``sharded_rank`` on ``world`` spawned ranks (``launch.ranks``);
    ``cfg`` replaces the cell's config (e.g. in float32). Returns every
    rank's record."""
    from repro_torch.launch import ranks
    args = (arch_id, shape_name, seed, cfg, str(out_dir), timed)
    ranks.spawn(sharded_rank, world, backend, device_type, args=args, timeout=timeout,
                threads=threads)
    return [json.loads((Path(out_dir) / f"rank{r}.json").read_text()) for r in range(world)]


SERVE_TIMED = 3               # timed decode tokens of a serve cell across ranks


def layer_tracer(rank: int, layout, dev) -> Callable[[int], None]:
    """``--trace``: a callback for ``prefill_sharded(trace=)`` that prints,
    flushed, one timestamped line per layer for this rank: the activation
    collectives and weight gathers so far and, on a card, the caching
    allocator's allocated, reserved and peak bytes, its allocation retries
    (each one frees the cache and synchronises the device) and its
    out-of-memory errors."""
    from repro_torch.models import nsa_sharded
    t0 = time.time()
    gib = 2 ** 30

    def trace(i: int) -> None:
        mem = ""
        if dev.type == "cuda":
            st = torch.cuda.memory_stats(dev)
            mem = (f"; allocated {st.get('allocated_bytes.all.current', 0) / gib:.2f} GiB, "
                   f"reserved {st.get('reserved_bytes.all.current', 0) / gib:.2f} GiB, peak "
                   f"{st.get('allocated_bytes.all.peak', 0) / gib:.2f} GiB, "
                   f"{st.get('num_alloc_retries', 0)} allocation retries, "
                   f"{st.get('num_ooms', 0)} out-of-memory errors")
        print(f"[trace] {time.strftime('%H:%M:%S')} +{time.time() - t0:.1f}s rank {rank} "
              f"{layout.coords} layer {i} done: {nsa_sharded.collectives()} activation "
              f"collectives, {layout.counts['gathers']} gathers" + mem, flush=True)
    return trace


def serve_rank(rank: int, world: int, dev, arch_id: str, shape_name: str, model_axis: int,
               seed: int, batch: int, out_dir: str, cfg: Optional[ModelConfig] = None,
               trace: bool = False) -> Dict:
    """One rank of ``--run --world N --model M`` on a prefill or batched
    decode cell (the JAX dry run's ``prefill_32k`` / ``decode_32k`` steps on
    a (data, model) mesh): its ``ServeWeights`` blocks drawn from ``seed``
    one layer at a time, on ``elastic.plan_mesh(N, prefer_model=M)``, and
    its rows of ``batch`` (0: the shape's global batch).

    A prefill cell runs one ``prefill_sharded`` pass over the rank's rows
    of the prompt (``cell_prompt``), timed on the host clock, and then, on
    a card, a pass of its first row under the profiler (which would double
    the timed pass's wall). A decode cell fills the rank's slices of the
    cache (rows over the data axes, sequence over ``model``) to
    ``seq_len`` as ``fill_caches`` fills a whole cache, then serves one
    ``decode_step_sharded`` token, ``SERVE_TIMED`` timed ones and one
    profiled. Returns the rank's record (also ``<out_dir>/rank<r>.json``):
    walls, busy and NCCL time, the collectives, the weights' gathers and
    their bytes, the peak, its ``rows`` and, when the batch was cut,
    ``reduced``; the first pass's logits (the rank's vocab slice) go to
    ``<out_dir>/rank<r>.pt``. ``cfg`` replaces the cell's config; ``trace``
    prints ``layer_tracer``'s lines during the timed prefill."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import nsa_sharded
    from repro_torch.runtime.elastic import build_mesh, plan_mesh
    from repro_torch.runtime.sharded import ServeWeights
    ps = prefill_sharded
    shape = specs.SHAPE_BY_NAME[shape_name]
    cfg = cfg or specs.cell_config(arch_id, shape_name)[0]
    mc = plan_mesh(world, prefer_model=model_axis)
    mesh = build_mesh(mc, dev.type)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    B = batch or shape.global_batch
    d_idx, n_dp = mesh_lib.axes_index(mesh, mesh_lib.dp_axes(mesh))
    if B % n_dp:
        raise ValueError(f"a batch of {B} rows does not divide over {n_dp} data ranks")
    rows = range(d_idx * (B // n_dp), (d_idx + 1) * (B // n_dp))
    max_len = shape.seq_len + specs.CACHE_SLACK
    t0 = time.time()
    view = ServeWeights.init(cfg, seed, mesh, dev)
    layout = view.layout
    rec = {"rank": rank, "world": world, "mesh": list(mc.shape), "axes": list(mc.axes),
           "coords": layout.coords, "backend": dist.get_backend(), "device": str(dev),
           "arch": arch_id, "shape": shape_name, "kind": shape.kind, "dtype": cfg.dtype,
           "seq_len": shape.seq_len, "batch": B, "rows": [rows.start, rows.stop],
           "vocab": list(view.vocab), "resident_weight_bytes": view.resident_bytes()}
    if B != shape.global_batch:
        rec["reduced"] = {"global_batch": B, "of": shape.global_batch, "why": "--batch"}
    if shape.kind == "prefill":
        tokens = cell_prompt(cfg, rows, shape.seq_len, seed, dev)
        frames = cell_frontend(cfg, arch_id, rows, seed, dev)
        rec["frontend_frames"] = 0 if frames is None else frames.shape[1]
        sync()
        dist.barrier()
        rec["build_s"] = time.time() - t0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        nsa_sharded.reset_collectives()
        layout.reset_counts()
        t0 = time.perf_counter()
        logits, caches = ps.prefill_sharded(
            view, cfg, mesh, tokens, max_len, frontend=frames,
            trace=layer_tracer(rank, layout, dev) if trace else None)
        sync()
        rec["wall_ms"] = [(time.perf_counter() - t0) * 1e3]
        rec["kv_rows"] = list(caches["global_rows"]["kv"])
        rec.update(collectives=nsa_sharded.collectives(), gathers=layout.counts["gathers"],
                   gathered_bytes=layout.bytes, logits_finite=bool(torch.isfinite(logits).all()))
        if dev.type == "cuda":
            dist.barrier()
            rec.update(_profile(lambda: ps.prefill_sharded(
                view, cfg, mesh, tokens[:1], max_len,
                frontend=None if frames is None else frames[:1])), profiled_rows=1)
        flops = rl.model_flops(cfg, dataclasses.replace(shape, global_batch=B))
        rec["model_flops_share"] = rl.flops_share(flops, rec["wall_ms"][0] / 1e3,
                                                  world * rl.PEAK_FLOPS)
    else:
        caches = nsa_sharded.init_local_caches(cfg, B, max_len, mesh, ps.SEQ_AXES, dev,
                                               shard_sequence=False)
        fill_caches(view, cfg, caches, shape.seq_len, seed)
        g = torch.Generator(dev)
        g.manual_seed(seed + 1)
        token = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                              device=dev)[rows.start:rows.stop]
        rec["kv_rows"] = list(caches["global_rows"]["kv"])
        sync()
        dist.barrier()
        rec["build_s"] = time.time() - t0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        def step():
            return nsa_sharded.decode_step_sharded(view, cfg, mesh, caches, token,
                                                   ps.SEQ_AXES)[0]

        nsa_sharded.reset_collectives()
        layout.reset_counts()
        t0 = time.perf_counter()
        logits = step()
        sync()
        rec.update(first_wall_ms=(time.perf_counter() - t0) * 1e3,
                   collectives_per_token=nsa_sharded.collectives(),
                   gathers_per_token=layout.counts["gathers"],
                   gathered_bytes_per_token=layout.bytes,
                   logits_finite=bool(torch.isfinite(logits).all()))
        walls = []
        for _ in range(SERVE_TIMED):
            dist.barrier()
            t0 = time.perf_counter()
            step()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        rec["wall_ms"] = walls
        if dev.type == "cuda":
            dist.barrier()
            rec.update(_profile(step))
    if dev.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["card"] = torch.cuda.get_device_name(dev)
    out_path = Path(out_dir)
    out_path.mkdir(parents=True, exist_ok=True)
    torch.save({"logits": logits.float().cpu(), "rows": rec["rows"], "vocab": rec["vocab"]},
               out_path / f"rank{rank}.pt")
    (out_path / f"rank{rank}.json").write_text(json.dumps(rec, indent=1))
    return rec


def run_serve_sharded(arch_id: str, shape_name: str, world: int, backend: str, out_dir: Path,
                      model_axis: int = 1, seed: int = 0, batch: int = 0,
                      cfg: Optional[ModelConfig] = None, device_type: str = "cuda",
                      timeout: float = 3000.0, threads: Optional[int] = None,
                      trace: bool = False) -> List[Dict]:
    """``serve_rank`` on ``world`` spawned ranks (``cfg`` in place of the
    cell's config when given); every rank's record."""
    from repro_torch.launch import ranks
    args = (arch_id, shape_name, model_axis, seed, batch, str(out_dir), cfg, trace)
    ranks.spawn(serve_rank, world, backend, device_type, args=args, timeout=timeout,
                threads=threads)
    return [json.loads((Path(out_dir) / f"rank{r}.json").read_text()) for r in range(world)]


TRAIN_TIMED = 3               # timed steps of a train cell across ranks


def live_at_peak(events, before: int = 0, top: int = 8) -> Dict:
    """Replays the caching allocator's history (``_snapshot()``'s
    ``device_traces`` of one device: "alloc" and "free_completed" events
    with "addr", "size" and "frames") from ``before`` bytes allocated when
    it began. Returns the peak of allocated bytes and what was live then,
    grouped by the innermost frame of this package that allocated it
    ("before the call" for blocks allocated earlier, "elsewhere" for none),
    the ``top`` largest groups first."""
    def owner(e) -> str:
        for f in e.get("frames") or ():
            if "repro_torch" in f["filename"]:
                return f"{Path(f['filename']).name}:{f['name']}"
        return "elsewhere"

    def replay(stop: int):
        live, old, cur, peak, at = {}, before, before, before, -1
        for j, e in enumerate(events[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                cur += e["size"]
                if cur > peak:
                    peak, at = cur, j + 1
            elif e["action"] == "free_completed":
                cur -= e["size"]
                if live.pop(e["addr"], None) is None:
                    old -= e["size"]
        return live, old, peak, at

    _, _, peak, at = replay(len(events))
    live, old, _, _ = replay(at) if at > 0 else ({}, before, 0, 0)
    groups: Dict[str, int] = {"before the call": old}
    for e in live.values():
        groups[owner(e)] = groups.get(owner(e), 0) + e["size"]
    ranked = sorted(groups.items(), key=lambda kv: -kv[1])[:top]
    return {"peak_bytes": peak, "before_bytes": before, "events": len(events),
            "owners": [{"where": k, "bytes": v} for k, v in ranked]}


TRACE_EVENTS = 4_000_000       # the allocator history's ring buffer under --trace


def peak_owners(fn, dev) -> Dict:
    """``--trace`` on a train cell: one call of ``fn`` with the caching
    allocator recording its history (Python stacks), then ``live_at_peak``
    of it. ``truncated``: the ring buffer filled, so early events are lost
    and the replay is not the call's."""
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.memory._record_memory_history(max_entries=TRACE_EVENTS, stacks="python")
    try:
        fn()
        torch.cuda.synchronize(dev)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    events = snap["device_traces"][dev.index or 0]
    return dict(live_at_peak(events, before), truncated=len(events) >= TRACE_EVENTS)


def train_rank(rank: int, world: int, dev, arch_id: str, shape_name: str, model_axis: int,
               seed: int, out_dir: str, trace: bool = False, timed: int = TRAIN_TIMED) -> Dict:
    """One rank of ``--run --world N`` on a train cell: its blocks of the
    state from ``seed`` (``sharded.init_state``), its data rank's row of a
    batch of one ``seq_len`` sequence per data rank (``SyntheticCorpus``,
    seeded; an arch with a frontend also its rows' ``cell_frontend``
    frames, as the JAX cell feeds them), and ``make_train_step(cfg, tcfg,
    mesh)``: one step to warm up, ``timed`` steps on the host clock,
    one under the profiler (on a card) and, with ``trace``, one more under
    ``peak_owners``. Returns the rank's record (also
    ``<out_dir>/rank<r>.json``)."""
    import torch.distributed as dist
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import sharded
    from repro_torch.runtime.elastic import build_mesh, plan_mesh
    from repro_torch.runtime.trainer import make_train_step
    shape = specs.SHAPE_BY_NAME[shape_name]
    cfg = specs.cell_config(arch_id, shape_name)[0]
    mc = plan_mesh(world, prefer_model=model_axis)
    mesh = build_mesh(mc, dev.type)
    tcfg = TrainConfig(steps=timed + 2, learning_rate=3e-4, warmup_steps=1, seed=seed)
    step = make_train_step(cfg, tcfg, mesh)
    layout = step.layout
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.time()
    state = list(sharded.init_state(cfg, tcfg, seed, layout, step.specs, dev))
    dp_index, n_dp = mesh_lib.axes_index(mesh, layout.dp)
    corpus = SyntheticCorpus(SyntheticConfig(vocab_size=cfg.vocab_size, seed=seed))
    batches = [torch.from_numpy(corpus.batch(i, n_dp, shape.seq_len, dp_index, n_dp)).to(dev)
               for i in range(timed + 2)]
    # an arch with a frontend trains on its frames too, the rank's rows of each step's
    rows = lambda b: range(dp_index * b.shape[0], (dp_index + 1) * b.shape[0])
    frames = [cell_frontend(cfg, arch_id, rows(b), seed + i, dev) for i, b in enumerate(batches)]
    sync()
    dist.barrier()
    build_s = time.time() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    steps = []

    def one(i):
        layout.reset_counts()
        *state[:], m = step(*state, batches[i], frames[i])
        steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      **layout.counts, "bytes": layout.bytes,
                      "activation_bytes": layout.activation_bytes,
                      "activation_kinds": layout.activation_kinds,
                      "relay_steps": layout.relay_steps})

    walls = []
    for i in range(timed + 1):
        dist.barrier()
        t0 = time.perf_counter()
        one(i)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    rec = {"rank": rank, "world": world, "mesh": list(mc.shape), "axes": list(mc.axes),
           "coords": layout.coords, "backend": dist.get_backend(), "device": str(dev),
           "arch": arch_id, "shape": shape_name, "dtype": cfg.dtype, "seq_len": shape.seq_len,
           "reduced": {"global_batch": n_dp, "of": shape.global_batch,
                       "why": "one sequence per data rank"},
           "frontend_frames": 0 if frames[0] is None else frames[0].shape[1],
           "positions": layout.positions, "build_s": build_s, "first_wall_ms": walls[0],
           "wall_ms": walls[1:], "steps": steps}
    if dev.type == "cuda":
        dist.barrier()
        rec.update(_profile(lambda: one(timed + 1)))
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["card"] = torch.cuda.get_device_name(dev)
        if trace:
            dist.barrier()
            rec["peak_owners"] = peak_owners(
                lambda: step(*state, batches[timed + 1], frames[timed + 1]), dev)
    flops = rl.model_flops(cfg, ShapeConfig(shape_name, shape.seq_len, n_dp, "train"))
    rec["model_flops"] = flops
    rec["model_flops_share"] = rl.flops_share(flops, sorted(walls[1:])[len(walls[1:]) // 2] / 1e3,
                                              world * rl.PEAK_FLOPS)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rank{rank}.json").write_text(json.dumps(rec, indent=1))
    return rec


def run_train_sharded(arch_id: str, shape_name: str, world: int, backend: str, out_dir: Path,
                      model_axis: int = 1, seed: int = 0, trace: bool = False,
                      timed: int = TRAIN_TIMED) -> List[Dict]:
    """``train_rank`` on ``world`` spawned ranks, one card each or sharing
    the cards (gloo); every rank's record."""
    from repro_torch.launch import ranks
    args = (arch_id, shape_name, model_axis, seed, str(out_dir), trace, timed)
    ranks.spawn(train_rank, world, backend, "cuda", args=args, timeout=900.0)
    return [json.loads((Path(out_dir) / f"rank{r}.json").read_text()) for r in range(world)]


def _relay_text(steps: Dict[str, int]) -> str:
    """The sLSTM relays' idle share of a step's lockstep steps, if any ran."""
    n = steps["busy"] + steps["idle"]
    return f"; sLSTM relay idle {steps['idle']} of {n} steps" if n else ""


def _run_world_train(a: str, s: str, args, capacity: float, per_card: int) -> None:
    rb = train_rank_bytes(a, s, args.world, args.model)
    if not rb["divides"] or rb["total"] * per_card > capacity:
        print(f"[SKIP] {a:22s} {s:12s} (its blocks do not divide or do not fit the cards)")
        return
    out = Path(args.out) / "world" / f"{a}__{s}__{args.world}x{args.model}{args.backend}"
    recs = run_train_sharded(a, s, args.world, args.backend, out, args.model, args.seed,
                             args.trace, args.steps)
    for r in recs:
        st = r["steps"]
        p0, p1, S = r["positions"] or (0, r["seq_len"] + r["frontend_frames"],
                                       r["seq_len"] + r["frontend_frames"])
        print(f"[RUN]  {a:22s} {s:12s} rank {r['rank']}/{r['world']} mesh {r['mesh']} "
              f"({r['backend']}, {r['device']}): positions {p0}-{p1} ({p1 - p0} of {S}) "
              "a row; losses "
              + ", ".join(f"{x['loss']:.6f}" for x in st) + "; grad norms "
              + ", ".join(f"{x['grad_norm']:.4f}" for x in st) + "; step wall "
              + ", ".join(f"{w:.1f}" for w in r["wall_ms"]) +
              f" ms (first {r['first_wall_ms']:.1f}); busy "
              f"{r.get('device_busy_ms', float('nan')):.1f} ms (of it "
              f"{r.get('collective_ms', float('nan')):.1f} in NCCL kernels); "
              f"{st[-1]['gathers']} gathers and {st[-1]['reductions']} reductions a step "
              f"({st[-1]['bytes'] / 1e9:.2f} GB through them), {st[-1]['activations']} "
              f"activation collectives ({st[-1]['activation_bytes'] / 1e9:.2f} GB: "
              + (", ".join(f"{k} {v['count']} ({v['bytes'] / 1e9:.4f} GB)"
                           for k, v in sorted(st[-1]["activation_kinds"].items())) or "none")
              + _relay_text(st[-1]["relay_steps"]) + "); peak "
              f"{r.get('peak_bytes', 0) / 2 ** 30:.2f} GiB; model-FLOPs share "
              f"{100 * r['model_flops_share']:.3f}% of {r['world']} x 989 TFLOP/s", flush=True)
        po = r.get("peak_owners")
        if po:
            print(f"[trace] {a} {s} rank {r['rank']}: one more step's peak "
                  f"{po['peak_bytes'] / 2 ** 30:.2f} GiB ({po['before_bytes'] / 2 ** 30:.2f} "
                  f"allocated before it; {po['events']} allocator events"
                  f"{', truncated' if po['truncated'] else ''}); live at the peak: "
                  + ", ".join(f"{o['where']} {o['bytes'] / 2 ** 30:.2f} GiB"
                              for o in po["owners"]), flush=True)


def _run_world_serve(a: str, s: str, args, capacity: float, per_card: int) -> None:
    rb = serve_rank_bytes(a, s, args.world, args.model, args.batch)
    if not rb["divides"] or rb["total"] * per_card > capacity:
        print(f"[SKIP] {a:22s} {s:12s} (its blocks and slices do not divide or do not fit the "
              "cards)")
        return
    out = Path(args.out) / "world" / f"{a}__{s}__{args.world}x{args.model}{args.backend}"
    recs = run_serve_sharded(a, s, args.world, args.backend, out, args.model, args.seed,
                             args.batch, trace=args.trace)
    for r in recs:
        head = (f"[RUN]  {a:22s} {s:12s} rank {r['rank']}/{r['world']} mesh {r['mesh']} "
                f"({r['backend']}, {r['device']}) rows {r['rows']} of {r['batch']}: ")
        busy = (f"busy {r.get('device_busy_ms', float('nan')):.1f} ms (of it "
                f"{r.get('collective_ms', float('nan')):.1f} in NCCL kernels); peak "
                f"{r.get('peak_bytes', 0) / 2 ** 30:.2f} GiB")
        if r["kind"] == "prefill":
            print(head + f"prefill {r['wall_ms'][0]:.1f} ms; {r['collectives']} activation "
                  f"collectives, {r['gathers']} gathers ({r['gathered_bytes'] / 1e9:.2f} GB); "
                  f"one row profiled: " + busy + f"; logits finite {r['logits_finite']}",
                  flush=True)
        else:
            print(head + f"{r['collectives_per_token']} activation collectives and "
                  f"{r['gathers_per_token']} gathers ({r['gathered_bytes_per_token'] / 1e9:.2f} "
                  f"GB) per token; wall per token " + ", ".join(f"{w:.1f}" for w in r["wall_ms"])
                  + f" ms (first {r['first_wall_ms']:.1f}); " + busy +
                  f"; logits finite {r['logits_finite']}", flush=True)


def run_world(archs: List[str], shapes: List[str], args) -> int:
    """``--run --world N``: ``run_train_sharded`` for each selected train
    cell, ``run_serve_sharded`` for each prefill cell and each decode cell
    of more than one row (its global batch, or ``--batch``), and
    ``run_sharded`` for each batch-1 decode cell that the sharded decode
    takes, whose ranks fit their cards."""
    resolve_device("cuda")                    # raises without a card
    cards = torch.cuda.device_count()
    capacity = torch.cuda.get_device_properties(0).total_memory
    per_card = -(-args.world // cards)
    for a in archs:
        for s in shapes:
            shape = specs.SHAPE_BY_NAME[s]
            if shape.kind == "train":
                _run_world_train(a, s, args, capacity, per_card)
                continue
            if shape.kind == "prefill" or (args.batch or shape.global_batch) > 1:
                _run_world_serve(a, s, args, capacity, per_card)
                continue
            rb = rank_bytes(a, s, args.world)
            if not rb["sharded_decode"] or not rb["divides"] or \
                    rb["total"] * per_card > capacity:
                print(f"[SKIP] {a:22s} {s:12s} (the batch-1 sequence-sharded decode takes NSA "
                      f"and recurrent decode cells whose ranks fit {cards} card(s))")
                continue
            out = Path(args.out) / "world" / f"{a}__{s}__{args.world}{args.backend}"
            recs = run_sharded(a, s, args.world, args.backend, out, args.seed)
            for r in recs:
                print(f"[RUN]  {a:22s} {s:12s} rank {r['rank']}/{r['world']} "
                      f"({r['backend']}, {r['device']}): {r['collectives_per_token']} "
                      f"collectives per token, wall per token " +
                      ", ".join(f"{w:.2f}" for w in r["wall_ms"]) +
                      f" ms, busy {r.get('device_busy_ms', float('nan')):.2f} ms (of it "
                      f"{r.get('collective_ms', float('nan')):.2f} in NCCL kernels), peak "
                      f"{r.get('peak_bytes', 0) / 2 ** 30:.2f} GiB", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="comma-separated ids, or all")
    ap.add_argument("--shape", default="all", help="comma-separated shape names, or all")
    ap.add_argument("--force", action="store_true", help="re-write existing records")
    ap.add_argument("--list", action="store_true", help="print the cell matrix and exit")
    ap.add_argument("--run", action="store_true",
                    help="measure the selected decode cells that fit at batch 1 on the card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ART_DIR))
    ap.add_argument("--world", type=int, default=0,
                    help="ranks: --list gives each train and decode cell's bytes per rank, "
                         "--run trains steps of a train cell or serves one token of a decode "
                         "cell across the ranks")
    ap.add_argument("--model", type=int, default=1,
                    help="the model axis of a train, prefill or batched decode cell's mesh "
                         "(elastic.plan_mesh(world, prefer_model=M))")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="collective backend of --run --world (gloo shares the cards)")
    ap.add_argument("--trace", action="store_true",
                    help="with --run --world on a prefill cell: a line per rank and layer "
                         "(collectives, gathers, the allocator's bytes, retries and "
                         "out-of-memory errors); on a train cell: one more step under the "
                         "allocator's history and what was live at its peak")
    ap.add_argument("--steps", type=int, default=TRAIN_TIMED,
                    help="timed steps of a train cell across ranks (after one to warm up "
                         "and before one profiled)")
    ap.add_argument("--batch", type=int, default=0,
                    help="rows of a prefill cell (--run on one card; 0: the most that fit) or "
                         "of a prefill or decode cell across ranks (--run --world; 0: the "
                         "shape's global batch)")
    args = ap.parse_args(argv)
    archs = list(cfglib.ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in SHAPES] if args.shape == "all" else args.shape.split(",")
    for s in shapes:
        if s not in specs.SHAPE_BY_NAME:
            raise KeyError(f"unknown shape {s!r}; known: {tuple(specs.SHAPE_BY_NAME)}")
    if args.list:
        if args.world:
            list_world(archs, shapes, args.world, args.model)
        else:
            list_cells(archs, shapes)
        return 0
    if args.run and args.world:
        return run_world(archs, shapes, args)
    if args.run:
        dev = resolve_device("cuda")          # raises without a card
        capacity = torch.cuda.get_device_properties(dev).total_memory
    for a in archs:
        for s in shapes:
            kind = specs.SHAPE_BY_NAME[s].kind
            if args.run and (kind == "train" or specs.fit_batch(a, s, capacity) < 1):
                print(f"[SKIP] {a:22s} {s:12s} (--run takes decode cells that fit at batch 1 "
                      "and prefill cells that fit at --batch rows)")
                continue
            rec = run_cell(a, s, Path(args.out), args.force, args.run, args.seed,
                           batch=args.batch)
            r = rec["roofline"]
            if args.run and kind == "prefill":
                p = rec["steps"]["prefill"]
                print(f"[RUN]  {a:22s} {s:12s} batch {rec['batch']} (fit {rec['fit_batch']}): "
                      f"prefill {p['wall_ms']:.1f} ms (one row profiled: busy "
                      f"{p['device_busy_ms']:.1f} ms); peak "
                      f"{rec['peak_bytes'] / 2 ** 30:.2f} GiB; bound {rec['bound_ms']:.2f} ms "
                      f"({r['bottleneck']}); model-FLOPs share "
                      f"{100 * rec['model_flops_share']:.2f}%", flush=True)
            elif args.run:
                st = rec["steps"]
                print(f"[RUN]  {a:22s} {s:12s} " + ", ".join(
                    f"{k} {v['wall_ms']:.2f} ms (busy {v['device_busy_ms']:.2f})"
                    for k, v in st.items()) +
                    f"; peak {rec['peak_bytes'] / 2 ** 30:.2f} GiB; decode bound "
                    f"{rec['decode_bound_ms']:.4f} ms ({r['bottleneck']})", flush=True)
            else:
                step = max(r["compute_s"], r["memory_s"], r["collective_s"])
                print(f"[OK]   {a:22s} {s:12s} fit batch {rec['fit_batch']:4d} "
                      f"bottleneck={r['bottleneck']:10s} step={step:.4f}s "
                      f"bytes/card={rec['bytes']['total'] / 2 ** 30:.2f}GiB", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
