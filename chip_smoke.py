#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build both CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
     source, in parallel) and print their ``-Xptxas -v`` lines; print the
     card's name and power limit;
  2. hold each kernel against its plain PyTorch version at the full-width
     ``ssv-nsa-1b`` shapes (verify: exact C=2 and approx C=4, full and
     partial fusion; routing: o_cmp and p_slc), in float32 and bfloat16;
  3. serve full-width ``ssv-nsa-1b`` (bf16, random weights from a seed,
     max_context 8192) through ``SSVEngine``: two 4097-token prompts, 16 new
     tokens each, D4/k2 tree, under Strict and Approx+Reuse, with the
     kernels' launch counters checked against layers x verify passes;
  4. Strict SSV equals autoregressive decoding on the card (float32);
  5. the serve CLI (``python -m repro_torch.launch.serve``);
  6. kernel times (CUDA events / profiler device time) beside the plain
     version's time and the bound;
  7. the summary lines: a ``kernels`` JSON line, the card line, and the
     ``{"ok": true, "device": ...}`` line last.

Imports nothing of JAX and nothing of the JAX package. TF32 is disabled
for float32 matmuls and convolutions so the float32 references are full
float32.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
F32_FLOPS_PER_S = 67e12         # H100 SXM float32, CUDA cores (data sheet)
# (rtol, atol). Both sides compute in float32 from the same values, so bf16
# K/V are held to the float32 tolerance too.
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (2e-4, 2e-5)}


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


# ---------------------------------------------------------------- inputs
def verify_inputs(cfg, kv_dtype, seed, prefix=4096, S=8192):
    """Full-width verify-kernel inputs: D4/k2 tree (T=31), cache S, real
    routing + Top-n selection on random compressed scores."""
    from repro_torch.core.tree import build_topology
    from repro_torch.models import nsa as nsa_lib

    nsa = cfg.nsa
    g = torch.Generator(DEV)
    g.manual_seed(seed)
    topo = build_topology(4, 2, "bfs")
    T = topo.num_nodes
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def r(*shape, dtype=kv_dtype):
        return torch.randn(shape, generator=g, device=DEV).to(dtype)

    NCB = nsa_lib.init_cmp_cache(cfg, 1, S, kv_dtype, DEV)["k_cmp"].shape[1]
    positions = (torch.as_tensor(topo.depths, device=DEV) + prefix)[None].to(torch.int32)
    p_slc = torch.rand((1, T, Hkv, nsa_lib.num_sel_blocks(S, nsa)), generator=g, device=DEV)
    sel_idx, sel_valid = nsa_lib.select_topn(p_slc, positions, torch.tensor(prefix, device=DEV), nsa)
    return dict(
        q=r(1, T, Hq, Dh, dtype=torch.float32) / Dh ** 0.5,
        k_cache=r(1, S, Hkv, Dh), v_cache=r(1, S, Hkv, Dh),
        k_cmp=r(1, NCB, Hkv, Dh), v_cmp=r(1, NCB, Hkv, Dh),
        k_draft=r(1, T, Hkv, Dh), v_draft=r(1, T, Hkv, Dh),
        sel_idx=sel_idx, sel_valid=sel_valid, positions=positions,
        prefix_len=torch.tensor([prefix], dtype=torch.int32, device=DEV),
        ncb_valid=nsa_lib.dyn_num_cmp_blocks(torch.tensor([prefix], device=DEV), nsa),
        tree_mask=torch.as_tensor(topo.mask, device=DEV)[None],
        gates=torch.sigmoid(r(1, T, 3, Hq, dtype=torch.float32)),
        o_cmp_in=r(1, T, Hq, Dh, dtype=torch.float32))


VERIFY_CASES = [("exact C=2 full", 2, "exact", True),
                ("exact C=2 partial", 2, "exact", False),
                ("approx C=4 full", 4, "approx", True),
                ("approx C=4 partial", 4, "approx", False)]


def verify_layouts(cfg, inp, C, mode):
    """The kernel-boundary arguments of ``nsa_verify_fused``."""
    from repro_torch.kernels.nsa_verify import ops as vops
    from repro_torch.kernels.routing.ops import per_row
    nsa = cfg.nsa
    S = inp["k_cache"].shape[1]
    merged, mvalid, own, qmap = vops.group_layouts(
        inp["sel_idx"], inp["sel_valid"], inp["positions"], C, mode)
    W = min(nsa.window, S)
    plen = inp["prefix_len"]
    pos = inp["positions"]
    dist = pos[:, :, None] - pos[:, None, :]
    dmask = inp["tree_mask"] & (dist < nsa.window) & (dist >= 0)
    return dict(q=inp["q"], k_cache=inp["k_cache"], v_cache=inp["v_cache"],
                k_cmp=inp["k_cmp"], v_cmp=inp["v_cmp"], k_draft=inp["k_draft"],
                v_draft=inp["v_draft"], merged=merged.contiguous(),
                mvalid=mvalid.contiguous(), own=own.contiguous(), qmap=qmap,
                positions=pos, prefix_len=plen,
                ncb_valid=per_row(inp["ncb_valid"], 1, DEV),
                win_start=(plen - W).clamp(0, S - W).to(torch.int32),
                dmask=dmask.to(torch.int32), gates=inp["gates"])


def run_verify(cfg, args, include_cmp, o_cmp_in, plain: bool):
    from repro_torch.kernels.nsa_verify import ops as vops, ref as vref
    nsa = cfg.nsa
    if plain:
        return vref.verify_groups_plain(
            **args, o_cmp_in=o_cmp_in, sel_block=nsa.sel_block,
            cmp_block=nsa.cmp_block, cmp_stride=nsa.cmp_stride,
            window=nsa.window, include_cmp=include_cmp)
    return vops.verify_groups(**args, o_cmp_in=o_cmp_in, nsa=nsa, include_cmp=include_cmp)


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


def check_close(name, got, want, dtype_name):
    rtol, atol = TOL[dtype_name]
    err = (got - want).abs()
    max_err = float(err.max())
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(torch.isfinite(got).all())
    log(f"  {name} [{dtype_name}]: max_abs_err={max_err:.3e} "
        f"(rtol={rtol}, atol={atol}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} [{dtype_name}] disagrees with its plain version")
    return max_err


# ---------------------------------------------------------------- bounds
def verify_bound(cfg, inp, args, include_cmp):
    """Least time for one verify launch: bytes each input/output moves once
    (the union of selected blocks per head, the visible window, cmp and
    draft K/V) vs the f32 flops the visible (row, key) pairs need."""
    nsa = cfg.nsa
    es = inp["k_cache"].element_size()
    T, Hq, Dh = inp["q"].shape[1:]
    Hkv = inp["k_cache"].shape[2]
    Gq = Hq // Hkv
    prefix = int(inp["prefix_len"][0])
    pos = inp["positions"][0].long()
    merged, mvalid = args["merged"][0].long(), args["mvalid"][0]
    slc_blocks = 0                  # selected blocks summed over the kv heads
    for h in range(Hkv):
        blocks = merged[:, h][(mvalid[:, h] > 0) & (merged[:, h] >= 0)]
        blocks = blocks[blocks * nsa.sel_block < prefix]
        slc_blocks += int(torch.unique(blocks).numel())
    W = min(nsa.window, inp["k_cache"].shape[1])
    win_keys = max(0, prefix - int(args["win_start"][0]))
    ncbv = int(args["ncb_valid"][0])
    nvis = ((pos - nsa.cmp_block + 1).clamp_min(-1) // nsa.cmp_stride + 1).clamp(0, ncbv)
    keys_per_head = win_keys + T + (int(nvis.max()) if include_cmp else 0)
    nbytes = (slc_blocks * nsa.sel_block + keys_per_head * Hkv) * Dh * 2 * es
    nbytes += inp["q"].numel() * 4 * (2 if include_cmp else 3)    # q, out (+ o_cmp_in)
    nbytes += inp["gates"].numel() * 4
    nbytes += sum(args[k].numel() * 4 for k in ("merged", "mvalid", "own", "dmask", "positions"))
    # visible (query row, key) pairs: slc keys per query = its own selected
    # tokens below prefix and at/below its position
    tok = inp["sel_idx"][0].long()[..., None] * nsa.sel_block + \
        torch.arange(nsa.sel_block, device=DEV)
    slc = ((tok < prefix) & (tok <= pos[:, None, None, None]) &
           inp["sel_valid"][0][..., None]).sum()
    kp = torch.arange(W, device=DEV) + int(args["win_start"][0])
    win = ((kp[None] < prefix) & (kp[None] > pos[:, None] - nsa.window) &
           (kp[None] <= pos[:, None])).sum() * Hkv
    draft = args["dmask"][0].sum() * Hkv
    cmpk = nvis.sum() * Hkv if include_cmp else 0
    flops = int(slc + win + draft + cmpk) * Gq * 4 * Dh
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def routing_bound(cfg, inp):
    nsa = cfg.nsa
    es = inp["k_cmp"].element_size()
    B, T, Hq, Dh = inp["q"].shape
    Hkv = inp["k_cmp"].shape[2]
    pos = inp["positions"][0].long()
    ncbv = int(inp["ncb_valid"].reshape(-1)[0])
    nvis = ((pos - nsa.cmp_block + 1).clamp_min(-1) // nsa.cmp_stride + 1).clamp(0, ncbv)
    NSB = -(-inp["k_cache"].shape[1] // nsa.sel_block)
    nbytes = int(nvis.max()) * Hkv * Dh * 2 * es + inp["q"].numel() * 4 * 2 \
        + T * Hkv * NSB * 4 + T * 4
    flops = int(nvis.sum()) * Hq * 4 * Dh
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


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


def time_kernel(fn, kernel_name: str, iters: int = 50):
    """Time per launch: the kernel's device time from the profiler (CUDA
    events when the profiler shows none), and CUDA events around ``iters``
    back-to-back calls of the wrapper, which include the host's enqueue
    whenever that is slower than the kernel. Returns (ms, source, events_ms)."""
    from torch.profiler import ProfilerActivity, profile
    events_ms = time_events(fn, iters)
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
        return total_us / iters / 1e3, "profiler", events_ms
    return events_ms, "cuda-events", events_ms


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for chip_smoke.json (all numbers of the run)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import configs
        from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus
        from repro_torch.kernels import build
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
    log(f"[1 build] {len(reports)} kernels built in {time.time() - t0:.1f}s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "smem")):
                log(f"  {name}: {line.strip()}")
    log(f"[1 card] {card}")

    cfg = configs.get_config("ssv-nsa-1b")
    counters = [rops.LAUNCHES, vops.FULL_LAUNCHES, vops.PARTIAL_LAUNCHES]

    # ---- 2. kernels vs plain versions at full width
    max_err = {"routing": 0.0, "nsa_verify_full": 0.0, "nsa_verify_partial": 0.0}
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        inp = verify_inputs(cfg, dt, seed=1)
        o_k, p_k = run_routing(cfg, inp, plain=False)
        o_r, p_r = run_routing(cfg, inp, plain=True)
        torch.cuda.synchronize()
        e1 = check_close("routing o_cmp", o_k, o_r, dt_name)
        e2 = check_close("routing p_slc", p_k, p_r, dt_name)
        max_err["routing"] = max(max_err["routing"], e1, e2)
        for label, C, mode, full in VERIFY_CASES:
            args = verify_layouts(cfg, inp, C, mode)
            oc = None if full else inp["o_cmp_in"]
            got = run_verify(cfg, args, full, oc, plain=False)
            want = run_verify(cfg, args, full, oc, plain=True)
            torch.cuda.synchronize()
            e = check_close(f"nsa_verify {label}", got, want, dt_name)
            key = "nsa_verify_full" if full else "nsa_verify_partial"
            max_err[key] = max(max_err[key], e)
    log("[2 kernels] all cases agree with the plain versions")

    # ---- 3. end to end, full width bf16
    gen = torch.Generator(DEV)
    corpus = SyntheticCorpus(SyntheticConfig(vocab_size=cfg.vocab_size))
    launches, e2e = serve_e2e(cfg, corpus, gen, counters, kind, card)
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        fail(f"the main path never launched {idle}")

    # ---- 4. Strict == autoregressive, float32
    strict_equals_ar(cfg, corpus, gen)

    # ---- 5. serve CLI
    serve_cli()

    # ---- 6. kernel times at the slice's shapes (bf16)
    rows = kernel_times(cfg, launches, max_err, kind, card)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kind": kind, "e2e": e2e, "kernels": rows,
         "seconds": time.time() - t_start}, indent=1))

    # ---- 7. summary
    log(f"[7 done] {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def serve_e2e(cfg, corpus, gen, counters, kind, card):
    """Phase 3: both precision classes through SSVEngine; returns the
    launch counts of this main-path run and the end-to-end numbers."""
    from repro_torch.bridge import init_params
    from repro_torch.config import ServeConfig, SSVConfig
    from repro_torch.core import draft as draft_lib, engine as engine_lib
    from repro_torch.core import planner as planner_lib
    dcfg = draft_lib.draft_config(cfg)
    gen.manual_seed(0)
    tp = init_params(cfg, gen, DEV)
    dp = init_params(dcfg, gen, DEV)
    prompts = [corpus.batch(i, 1, 4097)[0] for i in range(2)]
    launches = {c.name: 0 for c in counters}
    e2e = {}
    for pc in ("Strict", "Approx+Reuse"):
        mode, reuse = planner_lib.class_constraints(pc)
        sched = planner_lib.default_schedule(cfg.num_layers) if reuse else ()
        ssv = SSVConfig(tree_depth=4, tree_width=2, group_size=4 if mode == "approx" else 2,
                        group_mode=mode, refresh_schedule=sched, precision_class=pc)
        serve_cfg = ServeConfig(max_new_tokens=16, temperature=0.0, max_context=8192,
                                ssv=ssv, use_planner=False)
        eng = engine_lib.SSVEngine(tp, cfg, dp, dcfg, serve_cfg, device=DEV)
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        n_tok = n_steps = 0
        step_s = 0.0
        accepted = []
        for prompt in prompts:
            res = eng.generate(prompt, max_new_tokens=16)
            if len(res.tokens) != 16 or not all(0 <= t < cfg.vocab_size for t in res.tokens):
                fail(f"{pc}: bad tokens {res.tokens}")
            n_tok += len(res.tokens)
            n_steps += len(res.steps)
            step_s += sum(s.latency_s for s in res.steps)
            accepted += [s.accepted for s in res.steps]
        torch.cuda.synchronize()
        counts = {c.name: c.count for c in counters}
        refresh = cfg.num_layers - len([i for i in sched if 0 < i < cfg.num_layers])
        want = {"routing": refresh * n_steps,
                "nsa_verify_partial": refresh * n_steps,
                "nsa_verify_full": (cfg.num_layers - refresh) * n_steps}
        if counts != want:
            fail(f"{pc}: launch counts {counts}, expected {want} "
                 f"({refresh} refresh layers x {n_steps} verify passes)")
        for k, v in counts.items():
            launches[k] += v
        prof = profile_steps(eng, prompts[0])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        e2e[pc] = dict(tokens_per_s=n_tok / step_s, mean_accepted=sum(accepted) / len(accepted),
                       verify_passes=n_steps, peak_gib=peak, launches=counts,
                       profile=prof)
        log(f"[3 e2e {pc}] {kind} ({card}): {n_tok} tokens in {n_steps} steps, "
            f"{n_tok / step_s:.2f} tok/s (decode steps only), mean accepted/step "
            f"{sum(accepted) / len(accepted):.3f}, peak memory {peak:.2f} GiB, "
            f"launches {counts}")
    del tp, dp
    torch.cuda.empty_cache()
    return launches, e2e



def profile_steps(eng, prompt, n: int = 3):
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
    top = [{"ms": ms, "launches": c, "name": name[:80]} for ms, c, name in kern[:8]]
    log(f"  profile: step {wall_ms:.2f} ms wall, device busy {busy:.2f} ms "
        f"(idle share {1 - busy / wall_ms:.3f}), {sum(k[1] for k in kern)} kernels/step")
    for t in top[:5]:
        log(f"    {t['ms']:.3f} ms x{t['launches']} {t['name']}")
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "kernels_per_step": sum(k[1] for k in kern), "top": top}


def strict_equals_ar(cfg, corpus, gen):
    from repro_torch.bridge import init_params
    from repro_torch.config import ServeConfig, SSVConfig
    from repro_torch.core import draft as draft_lib, engine as engine_lib
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    dcfg32 = draft_lib.draft_config(cfg32)
    gen.manual_seed(1)
    tp = init_params(cfg32, gen, DEV)
    dp = init_params(dcfg32, gen, DEV)
    prompt = corpus.batch(7, 1, 2049)[0]
    ssv = SSVConfig(tree_depth=4, tree_width=2, precision_class="Strict")
    eng = engine_lib.SSVEngine(tp, cfg32, dp, dcfg32, ServeConfig(
        max_new_tokens=24, temperature=0.0, max_context=8192, ssv=ssv,
        use_planner=False), device=DEV)
    ssv_toks = eng.generate(prompt, max_new_tokens=24).tokens
    ar_toks = engine_lib.autoregressive_decode(tp, cfg32, prompt, 24, 8192,
                                               device=DEV).tokens
    log(f"[4 strict==AR f32] ssv {ssv_toks.tolist()}")
    log(f"[4 strict==AR f32] ar  {ar_toks.tolist()}")
    if len(ssv_toks) != 24 or ssv_toks.tolist() != ar_toks.tolist():
        fail("Strict SSV tokens differ from autoregressive decoding in float32")


def serve_cli():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "ssv-nsa-1b", "--prompts", "1", "--tokens", "8"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    for line in (cli.stdout + cli.stderr).strip().splitlines()[-5:]:
        log(f"[5 serve] {line}")
    if cli.returncode != 0:
        fail(f"serve CLI exited {cli.returncode}")


def kernel_times(cfg, launches, max_err, kind, card):
    inp = verify_inputs(cfg, torch.bfloat16, seed=2)
    rows = []
    r_ms, r_src, r_ev = time_kernel(lambda: run_routing(cfg, inp, False), "routing_kernel")
    r_plain = time_events(lambda: run_routing(cfg, inp, True), 10)
    r_bound, r_by = routing_bound(cfg, inp)
    log(f"[6 time] routing: {r_ms:.4f} ms ({r_src}; {r_ev:.4f} ms by CUDA events), "
        f"plain {r_plain:.4f} ms, "
        f"bound {r_bound:.4f} ms ({r_by}), library call: none — {kind} ({card})")
    rows.append(dict(name="routing", route="cuda", source="src/repro_torch/csrc/routing.cu",
                     replaces="src/repro/kernels/routing/kernel.py:70",
                     launches=launches["routing"], max_abs_err=max_err["routing"],
                     ms=r_ms, plain_ms=r_plain, bound_ms=r_bound, bound_by=r_by,
                     library_ms=None))
    times = {}
    for label, C, mode, full in VERIFY_CASES:
        args = verify_layouts(cfg, inp, C, mode)
        oc = None if full else inp["o_cmp_in"]
        ms, src, ev = time_kernel(lambda: run_verify(cfg, args, full, oc, False),
                                  "nsa_verify_kernel")
        plain = time_events(lambda: run_verify(cfg, args, full, oc, True), 5)
        bound, by = verify_bound(cfg, inp, args, full)
        times[label] = (ms, plain, bound, by)
        log(f"[6 time] nsa_verify {label}: {ms:.4f} ms ({src}; {ev:.4f} ms by CUDA "
            f"events), plain {plain:.4f} ms, "
            f"bound {bound:.4f} ms ({by}), library call: none — {kind} ({card})")
    for key, label in (("nsa_verify_full", "exact C=2 full"),
                       ("nsa_verify_partial", "exact C=2 partial")):
        ms, plain, bound, by = times[label]
        rows.append(dict(name=key, route="cuda", source="src/repro_torch/csrc/nsa_verify.cu",
                         replaces="src/repro/kernels/nsa_verify/kernel.py:156",
                         launches=launches[key], max_abs_err=max_err[key], ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None))
    return rows


if __name__ == "__main__":
    sys.exit(main())
