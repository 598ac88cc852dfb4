"""Deterministic synthetic LM corpus (a copy of ``repro.data.synthetic``):
prompts for serving and the training stream.

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

import bisect
import dataclasses
from typing import Iterator, Tuple

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
        # the normalised CDFs ``Generator.choice(p=...)`` builds on every call
        trans_cdf = self.trans.cumsum(-1)
        trans_cdf /= trans_cdf[..., -1:]
        self._trans_cdf = trans_cdf.tolist()
        self._emis_cdf = self.emis.cumsum(-1)
        self._emis_cdf /= self._emis_cdf[..., -1:]

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        """The JAX corpus's draws, token for token: there every step calls
        ``rng.choice(C, p=trans[c1, c2])`` and then ``rng.choice(V,
        p=emis[c])``, and each call draws one double ``u`` and returns
        ``searchsorted(cdf, u, side="right")``. Here the 2 x length doubles
        are drawn at once (the same stream), the class chain walks them in
        Python and the emissions are looked up per class in bulk."""
        C = self.cfg.num_classes
        c1, c2 = rng.integers(C), rng.integers(C)
        u = rng.random(2 * length)
        classes = np.empty(length, np.int64)
        for t, ut in enumerate(u[0::2].tolist()):
            c = bisect.bisect_right(self._trans_cdf[c1][c2], ut)
            classes[t] = c
            c1, c2 = c2, c
        out = np.empty(length, np.int64)
        u_emit = u[1::2]
        for c in range(C):
            hit = classes == c
            out[hit] = np.searchsorted(self._emis_cdf[c], u_emit[hit], side="right")
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



def token_stream(corpus: SyntheticCorpus, batch_size: int, seq_len: int,
                 start_step: int = 0, shard: int = 0,
                 num_shards: int = 1) -> Iterator[Tuple[int, np.ndarray]]:
    step = start_step
    while True:
        yield step, corpus.batch(step, batch_size, seq_len, shard, num_shards)
        step += 1
