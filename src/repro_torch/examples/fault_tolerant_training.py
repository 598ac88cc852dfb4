"""Fault-tolerance demo: training survives injected failures via
checkpoint/restart; elastic re-mesh planning on device loss, and the
elastic restart path (``elastic.resume``: plan the mesh of the ranks that
are left, build it, restore the checkpoint onto it) taking one sharded step
in a world of this one process.

  PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_training [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus
from repro_torch.launch import ranks
from repro_torch.runtime.elastic import plan_mesh, resume
from repro_torch.runtime.fault import FailureInjector, run_with_restarts
from repro_torch.runtime.trainer import Trainer, make_train_step

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

    # the elastic restart path on the world that is left: here one rank
    device_type = "cpu" if args.device == "cpu" else "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        ranks.init_rank(0, 1, "gloo" if device_type == "cpu" else "nccl", device_type,
                        str(Path(tmp) / "store"))
        try:
            mesh, step, st = resume(args.ckpt, cfg, tcfg, device_type=device_type)
            tokens = torch.from_numpy(SyntheticCorpus(SyntheticConfig(
                vocab_size=cfg.vocab_size, seed=tcfg.seed)).batch(step, 4, 64))
            *_, m = make_train_step(cfg, tcfg, mesh)(st["params"], st["opt"], st["residual"],
                                                     tokens.to(st["opt"].count.device))
            print(f"  resumed step {step} on mesh {tuple(mesh.mesh.shape)} "
                  f"{mesh.mesh_dim_names}: sharded step loss {float(m['loss']):.3f}")
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
