"""Serving CLI of the PyTorch port: single-stream, batched and continuous
SSV speculative serving of an architecture on the dense or the paged KV
store, optionally against the autoregressive baseline.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch ssv-nsa-1b \
      --prompts 1 --tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch ssv-nsa-8b \
      --prompts 1 --tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --prompts 1 --tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \
      --reduced --device cpu --tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
      --prompts 1 --tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --precision-class Approx+Reuse --baseline
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --prompts 3 --batch 2 --kv-backend paged
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --prompts 3 --batch 2 --continuous --arrival-rate 0.5
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --prompts 6 --batch 2 --continuous --bucketed --profile-json profile.json --warmup

The flags are the JAX CLI's (``repro.launch.serve``) plus ``--device``
(default ``cuda``). ``--arch`` takes every id of ``configs.ARCH_IDS``
(``--reduced`` for the CI-scale variant); one whose attention is not NSA
(qwen3-8b, granite-20b, mixtral-8x22b, qwen3-moe-235b-a22b,
musicgen-medium, smollm-360m, pixtral-12b, nemotron-4-340b and the
attention layers of recurrentgemma-9b) is served as its
``configs.nsa_variant``, as the JAX CLI serves it; the attention-free
xlstm-125m is served as it is, its mLSTM / sLSTM states replayed over the
draft tree. Weights are drawn from ``--seed`` with the JAX
``model.init`` distributions. ``--batch`` > 1 serves groups of prompts
through ``BatchedSSVEngine.generate_batch``; ``--continuous`` serves every
prompt over ``--batch`` slots with Poisson arrivals. ``--bucketed`` serves a
mixed-length workload (prompts of half, once and twice ``--prompt-len``)
through bucket-local execution groups, each under the strategy that the
offline profile (``--profile-json``, a ``planner.Profile`` written with
``Profile.to_json`` by either package) ranks first for its context bucket;
``--warmup`` builds every reachable (strategy, group size) group step —
on the card, captures its CUDA graph — before serving.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs as cfglib
from repro_torch.bridge import init_params
from repro_torch.config import ServeConfig, SSVConfig
from repro_torch.core import draft as draft_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core import planner as planner_lib
from repro_torch.core import schedule as schedule_lib
from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus
from repro_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ssv-nsa-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--prompts", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--arrival-rate", type=float, default=0.0)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--kv-backend", default="dense", choices=("dense", "paged"))
    ap.add_argument("--kv-page-size", type=int, default=0)
    ap.add_argument("--kv-num-pages", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--precision-class", default="Strict",
                    choices=list(planner_lib.PRECISION_CLASSES))
    ap.add_argument("--tree-depth", type=int, default=4)
    ap.add_argument("--tree-width", type=int, default=2)
    ap.add_argument("--bucketed", action="store_true",
                    help="continuous mode: step context-bucket execution groups, "
                         "each under its bucket's profile strategy (needs --profile-json)")
    ap.add_argument("--warmup", action="store_true",
                    help="build every reachable (strategy, group size) group step "
                         "before serving (bucketed only)")
    ap.add_argument("--profile-json", default=None,
                    help="offline profile (planner.Profile JSON) backing --bucketed")
    ap.add_argument("--baseline", action="store_true",
                    help="also run the autoregressive decode baseline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.bucketed:
        if not args.continuous:
            raise ValueError("--bucketed groups the continuous batch; add --continuous")
        if not args.profile_json:
            raise ValueError(
                "--bucketed needs an offline profile to rank strategies per "
                "context bucket: pass --profile-json <path> (a "
                "planner.Profile serialized with Profile.to_json)")
    if args.warmup and not args.bucketed:
        raise ValueError("--warmup builds the bucketed group-step cache; add --bucketed")
    dev = resolve_device(args.device)
    cfg = cfglib.reduced(args.arch) if args.reduced else cfglib.get_config(args.arch)
    if cfg.attention != "nsa":       # served through SSV: NSA in for attention
        cfg = cfglib.nsa_variant(cfg) if cfg.d_ff or cfg.block_pattern == ("attn",) else cfg
    dcfg = draft_lib.draft_config(cfg)
    gen = torch.Generator(dev)
    gen.manual_seed(args.seed)
    tp = init_params(cfg, gen, dev)
    dp = init_params(dcfg, gen, dev)

    mode, reuse = planner_lib.class_constraints(args.precision_class)
    sched = planner_lib.default_schedule(cfg.num_layers) if reuse else ()
    ssv = SSVConfig(tree_depth=args.tree_depth, tree_width=args.tree_width,
                    group_size=4 if mode == "approx" else 2, group_mode=mode,
                    refresh_schedule=sched, precision_class=args.precision_class)
    serve_cfg = ServeConfig(max_new_tokens=args.tokens, temperature=args.temperature,
                            max_context=min(cfg.max_seq_len, 2048), ssv=ssv,
                            use_planner=False, kv_backend=args.kv_backend,
                            kv_page_size=args.kv_page_size,
                            kv_num_pages=args.kv_num_pages)
    corpus = SyntheticCorpus(SyntheticConfig(vocab_size=cfg.vocab_size))
    if args.bucketed:
        # mixed-length workload: spread prompt lengths across the profile's
        # context buckets so the planner forms several groups
        lens = [max(8, args.prompt_len // 2), args.prompt_len, args.prompt_len * 2]
        prompts = [corpus.batch(i, 1, lens[i % len(lens)])[0] for i in range(args.prompts)]
    else:
        prompts = [corpus.batch(i, 1, args.prompt_len)[0] for i in range(args.prompts)]

    if args.continuous:     # --batch is the slot count
        planner = None
        if args.bucketed:
            with open(args.profile_json) as f:
                profile = planner_lib.Profile.from_json(f.read())
            planner = planner_lib.BatchPlanner(profile, args.precision_class)
        eng = engine_lib.BatchedSSVEngine(tp, cfg, dp, dcfg, serve_cfg, planner=planner,
                                          rng_seed=args.seed, device=dev)
        arrivals = schedule_lib.poisson_arrivals(len(prompts), args.arrival_rate,
                                                 seed=args.seed)
        reqs = [schedule_lib.Request(req_id=i, prompt=p, arrival=float(arrivals[i]))
                for i, p in enumerate(prompts)]
        res = eng.serve_continuous(reqs, num_slots=args.batch, max_new_tokens=args.tokens,
                                   warmup=args.warmup)
        for req, gen in zip(res.requests, res.results):
            print(f"prompt {req.req_id}: {len(gen.tokens)} tokens, "
                  f"arrival {req.arrival:.1f}, queue delay {req.queue_delay:.1f} steps")
        print(f"continuous over {args.batch} slots: {res.total_tokens} tokens "
              f"in {res.wall_s:.2f}s ({res.aggregate_throughput:.1f} tok/s "
              f"aggregate, {res.steps} steps, occupancy {res.mean_occupancy:.2f}, "
              f"queue delay {res.mean_queue_delay_steps:.1f} steps)")
        print(f"kv store {args.kv_backend}: {res.kv_bytes} bytes of raw KV"
              + (f", peak page occupancy {res.peak_page_occupancy:.2f}"
                 if args.kv_backend == "paged" else ""))
        if args.bucketed:
            occ = ", ".join(f"bucket{b}={v:.2f}" for b, v in sorted(res.bucket_occupancy.items()))
            print(f"bucketed: {res.group_launches} group launches ({occ}); "
                  f"step cache {res.kernel_cache['step_cache_hits']} hits / "
                  f"{res.kernel_cache['step_cache_misses']} misses")
        return

    if args.batch > 1:
        eng = engine_lib.BatchedSSVEngine(tp, cfg, dp, dcfg, serve_cfg,
                                          rng_seed=args.seed, device=dev)
        for lo in range(0, len(prompts), args.batch):
            group = prompts[lo:lo + args.batch]
            batch = eng.generate_batch(group, max_new_tokens=args.tokens)
            for i, res in enumerate(batch.results):
                print(f"prompt {lo + i}: {len(res.tokens)} tokens, "
                      f"mean accepted/step {res.mean_accepted:.2f}")
            print(f"batch[{lo}:{lo + len(group)}]: {batch.total_tokens} tokens in "
                  f"{batch.wall_s:.2f}s ({batch.aggregate_throughput:.1f} tok/s "
                  f"aggregate, {batch.steps} steps, kv store {args.kv_backend} "
                  f"{eng.kv_cache_bytes()} bytes)")
        return

    eng = engine_lib.SSVEngine(tp, cfg, dp, dcfg, serve_cfg, rng_seed=args.seed,
                               device=dev)
    for i, prompt in enumerate(prompts):
        res = eng.generate(prompt, max_new_tokens=args.tokens)
        print(f"prompt {i}: {len(res.tokens)} tokens, "
              f"mean accepted/step {res.mean_accepted:.2f}, "
              f"throughput {res.accepted_token_throughput:.1f} tok/s")
        if args.baseline:
            bl = engine_lib.autoregressive_decode(
                tp, cfg, prompt, len(res.tokens), serve_cfg.max_context,
                temperature=args.temperature, seed=args.seed, device=dev)
            print(f"  AR baseline: {bl.accepted_token_throughput:.1f} tok/s "
                  f"-> speedup {res.accepted_token_throughput / max(bl.accepted_token_throughput, 1e-9):.2f}x")


if __name__ == "__main__":
    main()
