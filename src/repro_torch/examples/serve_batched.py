"""Serve a stream of batched requests with SSV speculative decoding — the
serving-side end-to-end example.

Default mode runs the device-resident `BatchedSSVEngine`: one vectorized
draft→verify→accept→commit launch per step advances every request, with
per-request committed lengths and completion masks. `--sequential` falls back
to looping single-stream `SSVEngine.generate` calls (the old path) so the
aggregate-throughput win of true batching is directly measurable.

`--continuous` switches the batched engine to continuous batching: requests
arrive over a Poisson-ish replay (`--arrival-rate` requests per fused step,
seeded by `--arrival-seed`) and are admitted into `--slots` batch slots as
rows free up — a per-slot re-prefill lands the new KV prefix in the donated
batch cache mid-flight, instead of draining the whole batch between waves.
The run reports per-request queue delay (virtual-step units), mean slot
occupancy, and aggregate throughput.

`--kv-backend paged` swaps the dense per-slot KV buffers for the paged
store (`repro_torch.core.kvstore`): one physical page pool shared by every
request through per-row page tables, admission gated on free-page headroom,
pages freed on completion — KV memory scales with live tokens instead of
slots x max_context. `--kv-page-size` (default: the model's NSA sel_block,
making selected-block gather a page-table lookup) and `--kv-num-pages`
(pool capacity; 0 = worst case, no memory win) tune it. Token streams are
identical to the dense backend's.

`--bucketed` (continuous mode) serves a mixed-length demo workload through
bucket-local execution groups: a `BatchPlanner` partitions the live slots
by context-regime bucket and each group runs one fused step under the
profile's strategy for that bucket, instead of the whole batch sharing one
tree topology. The scheduler admits bucket-homogeneously into freed slots.
`--warmup` builds every reachable (strategy, group size) group step before
serving (on the card, captures its CUDA graph), so mid-serve strategy
switches never stall on a capture. Runs on the card unless `--device cpu`.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched --requests 4
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --requests 4 --sequential
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --requests 8 --continuous \\
      --slots 4 --arrival-rate 0.5
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --requests 8 --continuous \\
      --slots 4 --kv-backend paged --kv-num-pages 48
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --requests 8 --continuous \\
      --slots 4 --bucketed --warmup
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.bridge import init_params
from repro_torch.config import ModelConfig, NSAConfig, ServeConfig, SSVConfig
from repro_torch.core import draft as draft_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core import planner as P
from repro_torch.core import schedule as schedule_lib
from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus
from repro_torch.device import resolve_device


def build_models(device):
    cfg = ModelConfig(name="serve-nsa", num_layers=4, d_model=128, num_heads=4,
                      num_kv_heads=2, d_ff=256, vocab_size=512,
                      max_seq_len=2048, dtype="float32", attention="nsa",
                      nsa=NSAConfig(cmp_block=8, cmp_stride=4, sel_block=16,
                                    n_selected=4, window=64))
    dcfg = draft_lib.draft_config(cfg, num_layers=1)
    g = torch.Generator(device)
    g.manual_seed(0)
    return init_params(cfg, g, device), cfg, init_params(dcfg, g, device), dcfg


def build_profile(cfg, precision_class):
    """Tiny synthetic offline profile (normally produced by an offline
    calibration run); small trees."""
    mode, reuse = P.class_constraints(precision_class)
    sched = P.default_schedule(cfg.num_layers) if reuse else ()
    shapes = [(3, 2, "bfs"), (2, 2, "bfs"), (4, 2, "dfs"), (2, 4, "bfs")]
    entries = [P.ProfileEntry(
        SSVConfig(tree_depth=D, tree_width=k, traversal=t,
                  group_size=4 if mode == "approx" else 2, group_mode=mode,
                  refresh_schedule=sched, precision_class=precision_class),
        2.0 - 0.2 * i, 0.05) for i, (D, k, t) in enumerate(shapes)]
    return P.Profile(table={(b, pc): list(entries) for b in range(4)
                            for pc in P.PRECISION_CLASSES}), entries


def build_bucketed_profile(cfg, precision_class):
    """CPU-scale bucketed profile for the mixed-length demo: short-context
    requests get a shallow tree, long-context requests a deep one (per-
    bucket ranked lists, so the per-bucket runtime guards can refine)."""
    mode, reuse = P.class_constraints(precision_class)
    sched = P.default_schedule(cfg.num_layers) if reuse else ()
    C = 4 if mode == "approx" else 2
    mk = lambda D, k: SSVConfig(
        tree_depth=D, tree_width=k, traversal="bfs", group_size=C,
        group_mode=mode, refresh_schedule=sched,
        precision_class=precision_class)
    buckets = ((0, 64), (64, 256), (256, 1024), (1024, 4096))
    ranked = {0: [(1, 2), (2, 2)], 1: [(2, 2), (3, 2)],
              2: [(3, 2), (4, 2)], 3: [(4, 2), (4, 2)]}
    table = {(b, pc): [P.ProfileEntry(mk(D, k), 2.0 - 0.2 * i, 0.05)
                       for i, (D, k) in enumerate(ranked[b])]
             for b in range(len(buckets)) for pc in P.PRECISION_CLASSES}
    return P.Profile(table=table, buckets=buckets)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--precision-class", default="Reuse-only",
                    choices=list(P.PRECISION_CLASSES))
    ap.add_argument("--sequential", action="store_true",
                    help="loop single-stream SSVEngine instead of the batched engine")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: admit arrivals into freed "
                         "slots mid-flight instead of draining the batch")
    ap.add_argument("--slots", type=int, default=2,
                    help="batch slots for --continuous")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="Poisson arrival rate in requests per fused step "
                         "for --continuous (<=0: all arrive at t=0)")
    ap.add_argument("--arrival-seed", type=int, default=0,
                    help="seed for the Poisson arrival replay")
    ap.add_argument("--kv-backend", default="dense",
                    choices=("dense", "paged"),
                    help="KV store: dense per-slot buffers, or the paged "
                         "page-pool store (memory scales with live tokens)")
    ap.add_argument("--kv-page-size", type=int, default=0,
                    help="tokens per page (0 = model nsa.sel_block)")
    ap.add_argument("--kv-num-pages", type=int, default=0,
                    help="physical page-pool capacity (0 = worst case)")
    ap.add_argument("--bucketed", action="store_true",
                    help="continuous mode only: bucket-local execution "
                         "groups — each context-regime bucket of the batch "
                         "steps under its own profile strategy (serves a "
                         "mixed-length demo workload)")
    ap.add_argument("--warmup", action="store_true",
                    help="build every reachable (strategy, group size) "
                         "group step before serving (bucketed only)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.bucketed and not args.continuous:
        ap.error("--bucketed groups the continuous batch; add --continuous")
    if args.warmup and not args.bucketed:
        ap.error("--warmup builds the bucketed group-step cache; "
                 "add --bucketed")

    dev = resolve_device(args.device)
    tp, cfg, dp, dcfg = build_models(dev)
    profile, entries = build_profile(cfg, args.precision_class)
    corpus = SyntheticCorpus(SyntheticConfig(vocab_size=cfg.vocab_size))
    if args.bucketed:
        # mixed-length demo workload: alternate short- and long-context
        # prompts so the batch spans several profile buckets
        lengths = [24, 48, 96, 160]
        queue = [corpus.batch(i, 1, lengths[i % len(lengths)])[0]
                 for i in range(args.requests)]
    else:
        queue = [corpus.batch(i, 1, 48 + 16 * (i % 3))[0]
                 for i in range(args.requests)]
    serve_cfg = ServeConfig(max_new_tokens=args.tokens, temperature=0.0,
                            max_context=1024, ssv=entries[0].strategy,
                            use_planner=True,
                            kv_backend=args.kv_backend,
                            kv_page_size=args.kv_page_size,
                            kv_num_pages=args.kv_num_pages)

    t0 = time.time()
    if args.continuous:
        if args.bucketed:
            planner = P.BatchPlanner(build_bucketed_profile(
                cfg, args.precision_class), args.precision_class)
        else:
            planner = P.RuntimePlanner(profile, args.precision_class)
        eng = engine_lib.BatchedSSVEngine(tp, cfg, dp, dcfg, serve_cfg,
                                          planner=planner, device=dev)
        arrivals = schedule_lib.poisson_arrivals(
            args.requests, args.arrival_rate, seed=args.arrival_seed)
        reqs = [schedule_lib.Request(req_id=i, prompt=queue[i],
                                     arrival=float(arrivals[i]))
                for i in range(args.requests)]
        res = eng.serve_continuous(reqs, num_slots=args.slots,
                                   max_new_tokens=args.tokens,
                                   warmup=args.warmup)
        total_tokens = res.total_tokens
        for req, gen in zip(res.requests, res.results):
            delay = (f"{req.queue_delay:.1f}" if req.queue_delay is not None
                     else "n/a (never admitted)")
            print(f"req {req.req_id}: ctx {len(req.prompt)} -> "
                  f"{len(gen.tokens)} tokens, arrival {req.arrival:.1f}, "
                  f"queue delay {delay} steps")
        print(f"continuous: {res.steps} fused steps over {args.slots} slots, "
              f"mean occupancy {res.mean_occupancy:.2f}, "
              f"mean queue delay {res.mean_queue_delay_steps:.1f} steps")
        if args.bucketed:
            occ = ", ".join(f"bucket{b}={v:.2f}"
                            for b, v in sorted(res.bucket_occupancy.items()))
            cache = res.kernel_cache
            print(f"bucketed: {res.group_launches} group launches "
                  f"({occ}); step cache "
                  f"{cache['step_cache_hits']} hits / "
                  f"{cache['step_cache_misses']} misses; kernel load cache "
                  f"{cache.get('verify_call_hits', 0)} hits / "
                  f"{cache.get('verify_call_misses', 0)} misses")
        if args.kv_backend == "paged":
            print(f"paged KV store: {res.kv_bytes} raw-KV bytes, page "
                  f"occupancy mean {res.mean_page_occupancy:.2f} / peak "
                  f"{res.peak_page_occupancy:.2f}")
    elif args.sequential:
        total_tokens = 0
        for i, prompt in enumerate(queue):
            planner = P.RuntimePlanner(profile, args.precision_class)
            eng = engine_lib.SSVEngine(tp, cfg, dp, dcfg, serve_cfg,
                                       planner=planner, device=dev)
            res = eng.generate(prompt, max_new_tokens=args.tokens)
            total_tokens += len(res.tokens)
            strat = planner.current()
            print(f"req {i}: ctx {len(prompt)} -> {len(res.tokens)} tokens, "
                  f"{res.accepted_token_throughput:.1f} tok/s, "
                  f"strategy D{strat.tree_depth}k{strat.tree_width}/{strat.traversal}, "
                  f"refinements={planner.refinement_events}")
    else:
        # one planner for the whole batch: the strategy (hence tree topology)
        # is shared across rows so the step stays a single vectorized launch
        planner = P.RuntimePlanner(profile, args.precision_class)
        eng = engine_lib.BatchedSSVEngine(tp, cfg, dp, dcfg, serve_cfg,
                                          planner=planner, device=dev)
        batch = eng.generate_batch(queue, max_new_tokens=args.tokens)
        total_tokens = batch.total_tokens
        strat = planner.current()
        for i, res in enumerate(batch.results):
            print(f"req {i}: ctx {len(queue[i])} -> {len(res.tokens)} tokens, "
                  f"mean accepted/step {res.mean_accepted:.2f}")
        print(f"batched: {batch.steps} fused steps, strategy "
              f"D{strat.tree_depth}k{strat.tree_width}/{strat.traversal}, "
              f"refinements={planner.refinement_events}")
    dt = time.time() - t0
    print(f"served {args.requests} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens / dt:.1f} tok/s aggregate)")


if __name__ == "__main__":
    main()
