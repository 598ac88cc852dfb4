"""Training driver CLI (the JAX ``repro.launch.train`` flags, plus
``--device``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch ssv-nsa-1b --reduced \\
      --steps 50 --batch 8 --seq 128 --ckpt build/ckpt

Runs on the card unless ``--device cpu``; resumes from the newest
checkpoint in ``--ckpt`` (written by either package).
"""
from __future__ import annotations

import argparse
import json

from repro_torch import configs as cfglib
from repro_torch.config import TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--ckpt", default=TrainConfig.checkpoint_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    cfg = cfglib.reduced(args.arch) if args.reduced else cfglib.get_config(args.arch)
    tcfg = TrainConfig(steps=args.steps, learning_rate=args.lr,
                       micro_batches=args.micro_batches,
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt, seed=args.seed,
                       grad_compression="int8_ef" if args.compress else "none")

    from repro_torch.runtime.trainer import Trainer  # import after arg parsing
    tr = Trainer(cfg, tcfg, batch_size=args.batch, seq_len=args.seq, device=args.device)
    print(f"training {cfg.name}: {cfg.param_count():,} params, "
          f"resume step {tr.state.step}")
    tr.run()
    for m in tr.metrics_log[-5:]:
        print(json.dumps(m))
    print(f"done at step {tr.state.step}; straggler events: "
          f"{len(tr.watchdog.events)}")


if __name__ == "__main__":
    main()
