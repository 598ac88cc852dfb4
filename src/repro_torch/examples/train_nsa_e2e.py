"""End-to-end example: train a ~100M-class NSA target model for a few hundred
steps on the synthetic corpus with checkpoint/restart, then train a draft and
serve with SSV — the full paper pipeline at a small scale.

Defaults are sized for CI (--full bumps to the 100M-class config):
  PYTHONPATH=src python -m repro_torch.examples.train_nsa_e2e --steps 200 [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from repro_torch.config import ModelConfig, NSAConfig, ServeConfig, SSVConfig, TrainConfig
from repro_torch.core import draft as draft_lib
from repro_torch.core import engine as engine_lib
from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus
from repro_torch.runtime.trainer import Trainer

CKPT = Path(__file__).resolve().parents[3] / "build" / "e2e"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--full", action="store_true",
                    help="~100M-param config (slower on the CPU)")
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=48, help="tokens to serve")
    args = ap.parse_args(argv)
    if args.fresh:
        shutil.rmtree(args.ckpt, ignore_errors=True)

    if args.full:
        cfg = ModelConfig(name="nsa-100m", num_layers=8, d_model=768,
                          num_heads=12, num_kv_heads=4, d_ff=2048,
                          vocab_size=4096, max_seq_len=8192, dtype="float32",
                          attention="nsa",
                          nsa=NSAConfig(cmp_block=16, cmp_stride=8,
                                        sel_block=32, n_selected=8, window=128))
    else:
        cfg = ModelConfig(name="nsa-mini", num_layers=4, d_model=192,
                          num_heads=6, num_kv_heads=2, d_ff=384,
                          vocab_size=512, max_seq_len=4096, dtype="float32",
                          attention="nsa",
                          nsa=NSAConfig(cmp_block=8, cmp_stride=4,
                                        sel_block=16, n_selected=4, window=64))
    print(f"target {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    data = SyntheticConfig(vocab_size=cfg.vocab_size, seed=5)

    # ---- train target (resumes from checkpoint if present)
    tcfg = TrainConfig(steps=args.steps, learning_rate=3e-3, warmup_steps=20,
                       checkpoint_every=50, checkpoint_dir=args.ckpt + "/t")
    tr = Trainer(cfg, tcfg, data_cfg=data, batch_size=args.batch, seq_len=args.seq,
                 device=args.device)
    tr.run()
    print(f"target trained to step {tr.state.step}: "
          f"loss {tr.metrics_log[-1]['loss']:.3f}" if tr.metrics_log else
          f"target resumed at final step {tr.state.step}")

    # ---- train draft
    dcfg = draft_lib.draft_config(cfg, num_layers=1)
    dtr = Trainer(dcfg, TrainConfig(steps=args.steps, learning_rate=3e-3,
                                    warmup_steps=20, checkpoint_every=50,
                                    checkpoint_dir=args.ckpt + "/d", seed=1),
                  data_cfg=data, batch_size=args.batch, seq_len=args.seq, device=args.device)
    dtr.run()

    # ---- serve with SSV, compare against autoregressive decode
    corpus = SyntheticCorpus(data)
    prompt = corpus.batch(999, 1, 64)[0]
    n = args.tokens
    ar = engine_lib.autoregressive_decode(tr.state.params, cfg, prompt, n, 1024,
                                          device=args.device)
    eng = engine_lib.SSVEngine(
        tr.state.params, cfg, dtr.state.params, dcfg,
        ServeConfig(max_new_tokens=n, temperature=0.0, max_context=1024,
                    ssv=SSVConfig(tree_depth=4, tree_width=2, group_size=2,
                                  group_mode="exact",
                                  refresh_schedule=tuple(range(1, cfg.num_layers, 2)),
                                  precision_class="Reuse-only"),
                    use_planner=False), device=args.device)
    res = eng.generate(prompt, max_new_tokens=n)
    m = min(len(ar.tokens), len(res.tokens))
    agree = float((np.asarray(ar.tokens[:m]) == np.asarray(res.tokens[:m])).mean())
    print(f"AR: {ar.accepted_token_throughput:.1f} tok/s | "
          f"SSV: {res.accepted_token_throughput:.1f} tok/s | "
          f"accepted/step {res.mean_accepted:.2f} | greedy agreement {agree:.0%}")


if __name__ == "__main__":
    main()
