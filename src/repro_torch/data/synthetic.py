"""Deterministic synthetic LM corpus (a copy of ``repro.data.synthetic``
without the training stream; the port uses it for prompts).

An order-2 Markov chain over token classes with per-class emission tables,
seeded and position-reproducible: ``batch(step)`` is a pure function of
(seed, step, shard), so any worker can regenerate any step's data after a
restart — the property the fault-tolerance tests rely on (no data-state in
checkpoints beyond the step counter).

The structure (strong local statistics + long-range class recurrence) gives
small trained models non-trivial next-token predictability, which is what
makes draft acceptance rates meaningful in the SSV end-to-end experiments.
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int = 512
    num_classes: int = 8
    class_concentration: float = 0.25   # lower -> peakier emissions
    transition_concentration: float = 0.5
    seed: int = 1234


class SyntheticCorpus:
    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        C, V = cfg.num_classes, cfg.vocab_size
        # class-pair transition matrix (order 2)
        self.trans = rng.dirichlet(np.full(C, cfg.transition_concentration),
                                   size=(C, C)).astype(np.float64)
        # per-class emissions over disjoint-ish vocab ranges (peaky)
        emis = rng.dirichlet(np.full(V, cfg.class_concentration), size=C)
        boost = np.zeros((C, V))
        span = V // C
        for c in range(C):
            boost[c, c * span:(c + 1) * span] = 3.0 / span
        self.emis = (emis + boost)
        self.emis /= self.emis.sum(-1, keepdims=True)

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        C = self.cfg.num_classes
        c1, c2 = rng.integers(C), rng.integers(C)
        out = np.empty(length, np.int64)
        for t in range(length):
            c_next = rng.choice(C, p=self.trans[c1, c2])
            out[t] = rng.choice(self.cfg.vocab_size, p=self.emis[c_next])
            c1, c2 = c2, c_next
        return out

    def batch(self, step: int, batch_size: int, seq_len: int,
              shard: int = 0, num_shards: int = 1) -> np.ndarray:
        """Deterministic (step, shard)-keyed batch of token sequences."""
        assert batch_size % num_shards == 0
        local = batch_size // num_shards
        out = np.empty((local, seq_len), np.int64)
        for i in range(local):
            rng = np.random.default_rng(
                (self.cfg.seed, step, shard * local + i))
            out[i] = self.sample(rng, seq_len)
        return out

