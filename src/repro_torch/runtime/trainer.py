"""Trainer: the fault-tolerant training driver — the PyTorch counterpart
of ``repro.runtime.trainer`` on one device.

  * the train step: loss and gradients (autograd through ``model.loss_fn``,
    each layer recomputed in the backward pass under ``remat``), optional
    accumulation over micro-batches (summed in float32, then divided), the
    optional int8 error-feedback compression, global-norm clipping, AdamW;
  * deterministic (seed, step)-keyed data, prefetched in a background
    thread — restarts never replay or skip a batch;
  * an asynchronous checkpoint every ``checkpoint_every`` steps and at the
    last step (none when it is <= 0), resume from the newest on
    construction (a checkpoint of either package);
  * the straggler watchdog and the failure-injection hook in the loop.

It runs on the card unless ``device="cpu"`` and raises when no card is
there; nothing falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.bridge import init_params
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data.pipeline import PrefetchIterator
from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus, token_stream
from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm, compress,
                               tree_leaves, tree_map, tree_unflatten)
from repro_torch.runtime import sharded
from repro_torch.runtime.fault import FailureInjector
from repro_torch.runtime.straggler import StragglerWatchdog


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    residual: Any                 # error-feedback residual (compression) or a 0-d zero
    step: int = 0


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    row_groups: int = 1) -> Callable:
    """Returns step(params, opt, residual, tokens, frontend=None) ->
    (params, opt, residual, metrics) with metrics {"loss", "grad_norm"} as
    0-d device tensors. tokens (B, S) int64 on the params' device (an arch
    with a frontend: its frames (B, F, frontend_dim) in front, as
    ``model.loss_fn`` takes them); the inputs are left as they were.

    With ``mesh`` (a ``DeviceMesh`` over the initialised world) the step
    takes and returns this rank's blocks of the state and its rows of the
    batch, and equals this single-device step (``runtime.sharded``;
    ``row_groups``: its sLSTM relay's)."""
    if mesh is not None:
        return sharded.make_sharded_step(cfg, tcfg, mesh, row_groups)
    use_comp = tcfg.grad_compression == "int8_ef"

    def value_and_grad(params, leaves, batch, frontend):
        loss = model.loss_fn(params, cfg, batch, frontend=frontend, remat=tcfg.remat)
        # a leaf the loss never reads (the norm before an xLSTM block's
        # absent FFN) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), tree_unflatten(params, list(grads))

    def step_fn(params, opt, residual, tokens, frontend=None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if tcfg.micro_batches > 1:
                runs = lambda t: t.reshape((tcfg.micro_batches, t.shape[0] // tcfg.micro_batches)
                                           + t.shape[1:])
                mb = runs(tokens)
                fmb = [None] * tcfg.micro_batches if frontend is None else runs(frontend)
                loss = torch.zeros((), device=tokens.device)
                grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
                for batch, fr in zip(mb, fmb):
                    l, g = value_and_grad(params, leaves, batch, fr)
                    loss = loss + l
                    grads = tree_map(torch.add, grads, g)
                loss = loss / tcfg.micro_batches
                grads = tree_map(lambda g: g / tcfg.micro_batches, grads)
            else:
                loss, grads = value_and_grad(params, leaves, tokens, frontend)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        with torch.no_grad():
            if use_comp:
                quant, residual = compress.compress_pytree(grads, residual, int(opt.count))
                grads = compress.decompress_pytree(quant)
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
            params, opt = adamw_update(grads, opt, params, tcfg)
        return params, opt, residual, {"loss": loss, "grad_norm": gnorm}

    return step_fn


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 data_cfg: Optional[SyntheticConfig] = None,
                 batch_size: int = 8, seq_len: int = 128,
                 injector: Optional[FailureInjector] = None,
                 resume: bool = True, params=None, device=None):
        """``params`` (on ``device``) or, when None, ``init_params`` drawn
        from a generator seeded with ``tcfg.seed``."""
        model.check_supported(cfg)
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.batch_size, self.seq_len = batch_size, seq_len
        self.corpus = SyntheticCorpus(data_cfg or SyntheticConfig(
            vocab_size=cfg.vocab_size, seed=tcfg.seed))
        self.injector = injector
        self.watchdog = StragglerWatchdog()
        self.ckpt = AsyncCheckpointer(tcfg.checkpoint_dir, cfg)
        self.metrics_log: List[Dict[str, float]] = []

        if params is None:
            gen = torch.Generator(self.device)
            gen.manual_seed(tcfg.seed)
            params = init_params(cfg, gen, self.device)
        opt = adamw_init(params)
        residual = (compress.init_residual(params) if tcfg.grad_compression == "int8_ef"
                    else torch.zeros((), device=self.device))
        self.state = TrainState(params=params, opt=opt, residual=residual, step=0)
        if resume and latest_step(tcfg.checkpoint_dir) is not None:
            step, tree = restore(tcfg.checkpoint_dir, self._tree(), cfg)
            self.state = TrainState(params=tree["params"], opt=tree["opt"],
                                    residual=tree["residual"], step=step)
        self._step_fn = make_train_step(cfg, tcfg)

    def _tree(self):
        return {"params": self.state.params, "opt": self.state.opt,
                "residual": self.state.residual}

    def save(self):
        self.ckpt.save(self.state.step, self._tree(), metadata={"model": self.cfg.name})

    def run(self, steps: Optional[int] = None) -> int:
        end = self.tcfg.steps if steps is None else self.state.step + steps
        every = self.tcfg.checkpoint_every
        data = PrefetchIterator(token_stream(self.corpus, self.batch_size, self.seq_len,
                                             start_step=self.state.step), device=self.device)
        try:
            while self.state.step < end:
                step = self.state.step
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                data_step, batch = next(data)
                if data_step != step:
                    raise RuntimeError(f"data for step {data_step} at step {step}")
                t0 = time.perf_counter()
                params, opt, residual, metrics = self._step_fn(
                    self.state.params, self.state.opt, self.state.residual, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.watchdog.observe(step, dt)
                self.state = TrainState(params=params, opt=opt, residual=residual,
                                        step=step + 1)
                metrics["step"] = step
                metrics["time_s"] = dt
                self.metrics_log.append(metrics)
                if every > 0 and ((step + 1) % every == 0 or step + 1 == end):
                    self.save()
        finally:
            # also on a failure: the next Trainer must find the checkpoint
            # in flight written (the JAX trainer waits only on success)
            data.close()
            self.ckpt.wait()
        return self.state.step
