"""Quickstart: build a tiny NSA target + draft, run one SSV
draft-verify-accept round by hand, then generate with the engine.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.bridge import init_params
from repro_torch.config import ModelConfig, NSAConfig, ServeConfig, SSVConfig
from repro_torch.core import draft as draft_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core.tree import build_topology, positions_for
from repro_torch.device import resolve_device
from repro_torch.models import model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a small NSA target model and an even smaller draft
    cfg = ModelConfig(
        name="quickstart", num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512, max_seq_len=2048,
        dtype="float32", attention="nsa",
        nsa=NSAConfig(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4,
                      window=64))
    dcfg = draft_lib.draft_config(cfg, num_layers=1)
    g = torch.Generator(dev)
    g.manual_seed(0)
    target = init_params(cfg, g, dev)
    draft = init_params(dcfg, g, dev)
    print(f"target: {cfg.param_count():,} params | draft: {dcfg.param_count():,}")

    # 2. one verification round, manually
    prompt = np.arange(32) % 512
    toks = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    _, caches = model.prefill(target, cfg, toks[:, :-1], max_len=256)
    topo = build_topology(depth=3, width=2, order="bfs")
    print(f"draft tree: {topo.num_nodes} nodes (incl. pending root), "
          f"depths {topo.depths.tolist()}")
    positions = torch.as_tensor(positions_for(topo, 31), dtype=torch.int32, device=dev)[None]
    tree_mask = torch.as_tensor(topo.mask, device=dev)[None]
    node_tokens = torch.as_tensor(
        np.concatenate([[prompt[-1]], np.arange(topo.num_nodes - 1)]), device=dev)[None]
    logits, _ = model.verify_step(target, cfg, caches, node_tokens, positions, tree_mask,
                                  topo.parents, SSVConfig(group_mode="exact", group_size=2,
                                                          refresh_schedule=(1, 3)))
    print(f"verify logits: {tuple(logits.shape)} (refresh layers 0,2; reuse 1,3)")

    # 3. full generation through the engine
    eng = engine_lib.SSVEngine(target, cfg, draft, dcfg, ServeConfig(
        max_new_tokens=24, temperature=0.0, max_context=256,
        ssv=SSVConfig(tree_depth=3, tree_width=2, group_size=2,
                      group_mode="exact", refresh_schedule=(1, 3),
                      precision_class="Reuse-only"),
        use_planner=False), device=dev)
    res = eng.generate(prompt, max_new_tokens=24)
    print(f"generated {len(res.tokens)} tokens: {[int(t) for t in res.tokens[:12]]}...")
    print(f"mean accepted drafts/step: {res.mean_accepted:.2f}, "
          f"throughput {res.accepted_token_throughput:.1f} tok/s")


if __name__ == "__main__":
    main()
