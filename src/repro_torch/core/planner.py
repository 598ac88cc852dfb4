"""Profile-guided prompt-adaptive orchestration (paper §6) — the PyTorch
port's copy of ``repro.core.planner`` (pure Python with numpy; the port
imports nothing of the JAX package, so it keeps its own copy, and a
``Profile`` JSON written by either package loads in the other).

Strategy space: θ_d = (tree depth D, width k, traversal T),
θ_s = (coarsening factor C, mode M, refresh/reuse schedule S), constrained by
a precision class P ∈ {Strict, Reuse-only, Approx-only, Approx+Reuse}:

    Strict       — exact coarsening, all-refresh schedule
    Reuse-only   — exact coarsening, refresh/reuse schedule
    Approx-only  — approximate coarsening, all-refresh
    Approx+Reuse — approximate coarsening + refresh/reuse schedule

The offline profiler runs the full engine on a calibration prompt set per
(context regime r, P), measures E[A] (accepted tokens/step) and E[T] (step
latency), and stores a ranked candidate list per bucket.

Runtime guard (Algorithm 1 + §6.3): EMA-smoothed accepted counts with
α = 0.40; after an m = 8 step warmup, if the smoothed value stays below
ρ = 0.85 × the profiled expectation for h = 5 consecutive steps, switch to
the next-ranked strategy; at most 2 transitions per request, falling back to
the best strategy explored so far if the mismatch persists.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config import SSVConfig

PRECISION_CLASSES = ("Strict", "Reuse-only", "Approx-only", "Approx+Reuse")
DEFAULT_BUCKETS = ((0, 4096), (4096, 8192), (8192, 12288), (12288, 16384))

# Paper §6.3 constants
ALPHA = 0.40      # EMA coefficient
RHO = 0.85        # acceptance-drop ratio
WARMUP_M = 8      # minimum observation count
HYSTERESIS_H = 5  # consecutive below-threshold steps before switching
MAX_TRANSITIONS = 2


def class_constraints(precision_class: str) -> Tuple[str, bool]:
    """-> (group_mode, reuse_allowed)."""
    return {
        "Strict": ("exact", False),
        "Reuse-only": ("exact", True),
        "Approx-only": ("approx", False),
        "Approx+Reuse": ("approx", True),
    }[precision_class]


def default_schedule(num_layers: int) -> Tuple[int, ...]:
    """Alternating refresh/reuse (paper §7.2 evaluation schedule): odd layers
    reuse. Layer 0 is always a refresh."""
    return tuple(i for i in range(1, num_layers, 2))


def candidate_strategies(precision_class: str, num_layers: int,
                         schedule: Optional[Tuple[int, ...]] = None) -> List[SSVConfig]:
    """Enumerate the valid strategy tuples for one precision class — the
    profiler ranks these. 12 candidates per class (the paper's table
    width)."""
    mode, reuse = class_constraints(precision_class)
    sched = (schedule if schedule is not None else default_schedule(num_layers)) if reuse else ()
    shapes = [  # (D, k, budget)
        (6, 4, 0), (6, 10, 128), (4, 2, 0), (4, 4, 0), (8, 2, 0), (3, 8, 0),
    ]
    cands = []
    for D, k, budget in shapes:
        for trav in ("bfs", "dfs"):
            C = 4 if mode == "approx" else 2
            cands.append(SSVConfig(
                tree_depth=D, tree_width=k, traversal=trav, tree_budget=budget,
                group_size=C, group_mode=mode, refresh_schedule=sched,
                precision_class=precision_class))
    return cands


def bucket_of(context_len: int, buckets=DEFAULT_BUCKETS) -> int:
    for i, (lo, hi) in enumerate(buckets):
        if lo <= context_len < hi:
            return i
    return len(buckets) - 1


@dataclasses.dataclass
class ProfileEntry:
    strategy: SSVConfig
    expected_accept: float    # E[A]
    expected_latency: float   # E[T]

    @property
    def throughput(self) -> float:
        return (self.expected_accept + 1.0) / max(self.expected_latency, 1e-9)


@dataclasses.dataclass
class Profile:
    """Lookup table: (bucket, precision class) -> ranked ProfileEntry list."""
    table: Dict[Tuple[int, str], List[ProfileEntry]]
    buckets: Tuple[Tuple[int, int], ...] = DEFAULT_BUCKETS

    def lookup(self, context_len: int, precision_class: str) -> List[ProfileEntry]:
        return self.table[(bucket_of(context_len, self.buckets), precision_class)]

    def to_json(self) -> str:
        enc = {}
        for (b, p), entries in self.table.items():
            enc[f"{b}|{p}"] = [
                {"strategy": dataclasses.asdict(e.strategy),
                 "expected_accept": e.expected_accept,
                 "expected_latency": e.expected_latency} for e in entries]
        return json.dumps({"buckets": self.buckets, "table": enc}, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Profile":
        raw = json.loads(s)
        table = {}
        for key, entries in raw["table"].items():
            b, p = key.split("|")
            table[(int(b), p)] = [
                ProfileEntry(strategy=SSVConfig(**{
                    **e["strategy"],
                    "refresh_schedule": tuple(e["strategy"]["refresh_schedule"])}),
                    expected_accept=e["expected_accept"],
                    expected_latency=e["expected_latency"]) for e in entries]
        return cls(table=table,
                   buckets=tuple(tuple(b) for b in raw["buckets"]))


def build_profile(run_fn, precision_classes=PRECISION_CLASSES,
                  buckets=DEFAULT_BUCKETS, num_layers: int = 8,
                  max_candidates: int = 12, schedule=None) -> Profile:
    """Offline profiling. ``run_fn(strategy, bucket_idx) -> (E[A], E[T])``
    runs the end-to-end engine on the calibration set for that regime."""
    table: Dict[Tuple[int, str], List[ProfileEntry]] = {}
    for b in range(len(buckets)):
        for pc in precision_classes:
            entries = []
            for strat in candidate_strategies(pc, num_layers, schedule)[:max_candidates]:
                ea, et = run_fn(strat, b)
                entries.append(ProfileEntry(strat, float(ea), float(et)))
            entries.sort(key=lambda e: -e.throughput)
            table[(b, pc)] = entries
    return Profile(table=table, buckets=buckets)


class RuntimePlanner:
    """Algorithm 1: preselect from the profile, refine during early steps."""

    def __init__(self, profile: Profile, precision_class: str = "Strict",
                 alpha: float = ALPHA, rho: float = RHO, warmup_m: int = WARMUP_M,
                 hysteresis_h: int = HYSTERESIS_H,
                 max_transitions: int = MAX_TRANSITIONS,
                 early_window: int = 64):
        self.profile = profile
        self.pc = precision_class
        self.alpha, self.rho = alpha, rho
        self.warmup_m, self.h = warmup_m, hysteresis_h
        self.max_transitions = max_transitions
        self.early_window = early_window
        self._reset()

    def _reset(self):
        self.rank = 0
        self.entries: List[ProfileEntry] = []
        self.ema: Optional[float] = None
        self.below = 0
        self.steps = 0
        self.transitions = 0
        self.explored: List[Tuple[int, float, float]] = []  # (rank, mean A, mean T)
        self._acc_hist: List[float] = []
        self._lat_hist: List[float] = []
        self.refinement_events = 0

    # ---------------------------------------------------------------- API
    def begin_request(self, context_len: int):
        self._reset()
        self.entries = self.profile.lookup(context_len, self.pc)

    def current(self) -> SSVConfig:
        return self.entries[min(self.rank, len(self.entries) - 1)].strategy

    def observe(self, accepted: int, latency_s: float):
        self.steps += 1
        self._acc_hist.append(accepted)
        self._lat_hist.append(latency_s)
        self.ema = accepted if self.ema is None else \
            self.alpha * accepted + (1 - self.alpha) * self.ema
        if self.steps > self.early_window:
            return
        expected = self.entries[min(self.rank, len(self.entries) - 1)].expected_accept
        if self.steps >= self.warmup_m and self.ema < self.rho * expected:
            self.below += 1
        else:
            self.below = 0
        if self.below >= self.h:
            self._refine()

    # ---------------------------------------------------------------- guard
    def _refine(self):
        self.explored.append((self.rank, float(np.mean(self._acc_hist[-self.h:])),
                              float(np.mean(self._lat_hist[-self.h:]))))
        if self.transitions < self.max_transitions and self.rank + 1 < len(self.entries):
            self.rank += 1
            self.transitions += 1
            self.refinement_events += 1
            self.below = 0
            self.ema = None
        else:
            # mismatch persists: pick the best configuration explored so far
            if self.explored:
                best = max(self.explored,
                           key=lambda e: (e[1] + 1.0) / max(e[2], 1e-9))
                self.rank = best[0]
            self.below = 0


class BatchPlanner:
    """Bucket-local batched planning: profile-guided execution groups for a
    mixed-length continuous batch.

    Where ``RuntimePlanner`` drives ONE strategy per request stream, the
    BatchPlanner partitions the live batch slots by context-regime bucket and
    assigns each group the profile's top-ranked strategy for its (bucket,
    precision class). Every bucket carries its own runtime guard — a full
    ``RuntimePlanner`` seeded at that bucket's profile entries — so the EMA /
    hysteresis refinement (Algorithm 1) runs per execution group: a
    long-context group refining to its next-ranked strategy never perturbs
    the short-context group's plan.

    The engine (``BatchedSSVEngine.serve_continuous`` in bucketed mode) asks
    ``plan`` for the execution groups each round, launches one group step
    per group under ``strategy_for(bucket)``, and feeds the group's mean
    acceptance back through ``observe(bucket, ...)``.
    """

    is_batch_planner = True

    def __init__(self, profile: Profile, precision_class: str = "Strict",
                 alpha: float = ALPHA, rho: float = RHO,
                 warmup_m: int = WARMUP_M, hysteresis_h: int = HYSTERESIS_H,
                 max_transitions: int = MAX_TRANSITIONS,
                 early_window: int = 64):
        missing = [b for b in range(len(profile.buckets))
                   if not profile.table.get((b, precision_class))]
        if missing:
            have = sorted({pc for (_, pc) in profile.table})
            raise ValueError(
                f"profile has no ranked strategies for precision class "
                f"{precision_class!r} in bucket(s) {missing} — a request "
                "landing there could not be planned; this profile covers "
                f"{have}")
        self.profile = profile
        self.pc = precision_class
        self._guard_kwargs = dict(alpha=alpha, rho=rho, warmup_m=warmup_m,
                                  hysteresis_h=hysteresis_h,
                                  max_transitions=max_transitions,
                                  early_window=early_window)
        self.max_transitions = max_transitions
        self.guards: Dict[int, RuntimePlanner] = {}

    # ---------------------------------------------------------------- buckets
    def bucket_of(self, context_len: int) -> int:
        return bucket_of(context_len, self.profile.buckets)

    def begin_serve(self):
        """Reset every bucket guard — call once per serving run."""
        self.guards = {}

    def _guard(self, bucket: int) -> RuntimePlanner:
        g = self.guards.get(bucket)
        if g is None:
            g = RuntimePlanner(self.profile, self.pc, **self._guard_kwargs)
            # seed the guard at the bucket's representative context length
            g.begin_request(context_len=self.profile.buckets[bucket][0])
            self.guards[bucket] = g
        return g

    # ---------------------------------------------------------------- plan
    def strategy_for(self, bucket: int) -> SSVConfig:
        """Current (guard-refined) strategy of one bucket's execution group."""
        return self._guard(bucket).current()

    def plan(self, slot_buckets: Dict[int, int]) -> List[Tuple[int, List[int]]]:
        """Partition live slots into bucket-homogeneous execution groups.

        ``slot_buckets``: slot index -> context bucket for every slot to
        advance this round. Returns ``[(bucket, [slots...]), ...]`` sorted by
        bucket then slot — a deterministic launch order, so serving replays
        are reproducible."""
        groups: Dict[int, List[int]] = {}
        for slot, b in slot_buckets.items():
            groups.setdefault(int(b), []).append(int(slot))
        return [(b, sorted(slots)) for b, slots in sorted(groups.items())]

    def observe(self, bucket: int, accepted: float, latency_s: float):
        """Feed one group step's mean acceptance into that bucket's guard."""
        self._guard(bucket).observe(accepted=accepted, latency_s=latency_s)

    # ---------------------------------------------------------------- warmup
    def reachable_strategies(self) -> List[SSVConfig]:
        """Every strategy a serving run can launch: per bucket, the ranks the
        guard can walk to (top rank + at most ``max_transitions`` refinement
        hops). This is the warmup set: building its group steps up front
        means a mid-serve strategy switch never stalls the batch."""
        out: List[SSVConfig] = []
        for b in range(len(self.profile.buckets)):
            entries = self.profile.table.get((b, self.pc), [])
            for e in entries[: self.max_transitions + 1]:
                if e.strategy not in out:
                    out.append(e.strategy)
        return out

    @property
    def refinement_events(self) -> int:
        return sum(g.refinement_events for g in self.guards.values())
