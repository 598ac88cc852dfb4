"""Fault-tolerance demo: training survives injected failures via
checkpoint/restart; elastic re-mesh planning on device loss.

  PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_training [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.runtime.elastic import plan_mesh
from repro_torch.runtime.fault import FailureInjector, run_with_restarts
from repro_torch.runtime.trainer import Trainer

CKPT = Path(__file__).resolve().parents[3] / "build" / "fault_demo"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt", default=str(CKPT), help="checkpoint directory (emptied first)")
    ap.add_argument("--steps", type=int, default=24)
    args = ap.parse_args(argv)
    shutil.rmtree(args.ckpt, ignore_errors=True)
    cfg = ModelConfig(name="fault-demo", num_layers=2, d_model=96,
                      num_heads=4, num_kv_heads=2, d_ff=192, vocab_size=256,
                      dtype="float32")
    tcfg = TrainConfig(steps=args.steps, checkpoint_every=6, learning_rate=1e-3,
                       checkpoint_dir=args.ckpt)
    injector = FailureInjector(fail_at_steps=[7, 15])  # two "preemptions"
    trainers = []

    def run_once():
        tr = Trainer(cfg, tcfg, batch_size=4, seq_len=64, injector=injector,
                     device=args.device)
        trainers.append(tr)
        print(f"  (re)started at step {tr.state.step}")
        return tr.run()

    report = run_with_restarts(run_once)
    print(f"completed={report.completed} after {report.restarts} restarts, "
          f"final step {report.final_step}")
    final = trainers[-1]
    print(f"final loss {final.metrics_log[-1]['loss']:.3f}, "
          f"straggler events {len(final.watchdog.events)}")

    # elastic planning: what mesh would we rebuild on partial device loss?
    for n in (512, 384, 256, 128):
        mc = plan_mesh(n, prefer_model=16, multi_pod=(n > 256), pod_size=256)
        print(f"  {n} healthy chips -> mesh {mc.shape} axes {mc.axes}")


if __name__ == "__main__":
    main()
