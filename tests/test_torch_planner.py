"""The port's planner and bucket admission against the JAX ones on the same
inputs (``repro_torch.core.planner`` / ``schedule`` are copies that must not
import the JAX package): the candidate strategies field by field, a
``Profile`` JSON written by either package read back by the other, the
``RuntimePlanner`` and per-bucket ``BatchPlanner`` guards' rank / EMA /
transition trajectories for seeded acceptance sequences (refinement, the
2-hop cap and the best-explored fallback included), the reachable
(warmup) strategy sets, ``Scheduler(policy="bucket")`` admissions and
``bucket_occupancy`` for seeded arrivals, and ``greedy_calibrate`` /
``kl_divergence`` for one numpy ``eval_fn``."""
import dataclasses

import numpy as np
import pytest

from repro.config import SSVConfig as JSSV
from repro.core import kvstore as JK, planner as JP, schedule as JS
from repro_torch.config import SSVConfig as TSSV
from repro_torch.core import kvstore as TK, planner as TP, schedule as TS

LIBS = {"jax": (JP, JSSV), "torch": (TP, TSSV)}
BUCKETS = ((0, 64), (64, 256), (256, 1024))


def _profile(lib, SSV, seed=0, n=5):
    """Per (bucket, class): n ranked entries with seeded expectations."""
    rng = np.random.default_rng(seed)
    table = {}
    for b in range(len(BUCKETS)):
        for pc in lib.PRECISION_CLASSES:
            cands = lib.candidate_strategies(pc, num_layers=6)
            table[(b, pc)] = [lib.ProfileEntry(cands[(b + 2 * i) % len(cands)],
                                               float(rng.uniform(2.5, 6.0)),
                                               float(rng.uniform(0.01, 0.05)))
                              for i in range(n)]
    return lib.Profile(table=table, buckets=BUCKETS)


def _asdict(s):
    return dataclasses.asdict(s)


@pytest.mark.parametrize("pc", JP.PRECISION_CLASSES)
@pytest.mark.parametrize("num_layers,schedule", [(8, None), (5, (2, 4)), (16, None)])
def test_candidate_strategies_equal(pc, num_layers, schedule):
    j = JP.candidate_strategies(pc, num_layers, schedule)
    t = TP.candidate_strategies(pc, num_layers, schedule)
    assert [_asdict(s) for s in t] == [_asdict(s) for s in j]
    assert [s.num_draft_tokens() for s in t] == [s.num_draft_tokens() for s in j]
    assert TP.class_constraints(pc) == JP.class_constraints(pc)
    assert TP.default_schedule(num_layers) == JP.default_schedule(num_layers)


def test_constants_and_buckets_equal():
    assert TP.DEFAULT_BUCKETS == JP.DEFAULT_BUCKETS
    assert (TP.ALPHA, TP.RHO, TP.WARMUP_M, TP.HYSTERESIS_H, TP.MAX_TRANSITIONS) == \
        (JP.ALPHA, JP.RHO, JP.WARMUP_M, JP.HYSTERESIS_H, JP.MAX_TRANSITIONS)
    for n in (0, 63, 64, 255, 256, 1023, 5000):
        assert TP.bucket_of(n, BUCKETS) == JP.bucket_of(n, BUCKETS)
        assert TP.bucket_of(n * 4) == JP.bucket_of(n * 4)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_profile_json_reads_back_in_the_other_package(writer, reader):
    wlib, wssv = LIBS[writer]
    rlib, _ = LIBS[reader]
    prof = _profile(wlib, wssv, seed=3)
    text = prof.to_json()
    back = rlib.Profile.from_json(text)
    assert back.buckets == prof.buckets
    assert set(back.table) == set(prof.table)
    for key, entries in prof.table.items():
        got = back.table[key]
        assert [_asdict(e.strategy) for e in got] == [_asdict(e.strategy) for e in entries]
        assert [(e.expected_accept, e.expected_latency) for e in got] == \
            [(e.expected_accept, e.expected_latency) for e in entries]
        assert [e.throughput for e in got] == [e.throughput for e in entries]
    assert back.to_json() == text
    assert [_asdict(e.strategy) for e in back.lookup(100, "Strict")] == \
        [_asdict(e.strategy) for e in prof.lookup(100, "Strict")]


def test_build_profile_ranks_alike():
    def run_fn(strat, b):
        return (strat.tree_depth * 0.5 + b * 0.1 + strat.tree_width * 0.01,
                0.01 * strat.num_draft_tokens() ** 0.5)

    j = JP.build_profile(run_fn, buckets=BUCKETS, num_layers=4)
    t = TP.build_profile(run_fn, buckets=BUCKETS, num_layers=4)
    assert t.to_json() == j.to_json()


def _runtime_trace(lib, SSV, seed, ctx, **kw):
    pl = lib.RuntimePlanner(_profile(lib, SSV, seed=seed), "Strict", **kw)
    pl.begin_request(context_len=ctx)
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(80):
        pl.observe(accepted=int(rng.integers(0, 3)), latency_s=float(rng.uniform(0.01, 0.03)))
        trace.append((pl.rank, pl.ema, pl.below, pl.transitions, pl.refinement_events,
                      _asdict(pl.current())))
    return trace, pl.explored


@pytest.mark.parametrize("seed,ctx,kw", [(0, 10, {}), (1, 100, {}), (2, 700, {}),
                                         (3, 100, dict(warmup_m=2, hysteresis_h=2)),
                                         (4, 10, dict(max_transitions=1, rho=0.99)),
                                         (5, 700, dict(early_window=16))])
def test_runtime_planner_trajectory_equal(seed, ctx, kw):
    """Rank, EMA, hysteresis count, transitions and strategy after every
    observation; the seeded low acceptances refine, hit the hop cap and
    fall back to the best explored rank."""
    (jt, je), (tt, te) = (_runtime_trace(*LIBS[k], seed, ctx, **kw) for k in ("jax", "torch"))
    assert tt == jt
    assert te == je
    if not kw:
        assert tt[-1][3] == TP.MAX_TRANSITIONS and len(te) > TP.MAX_TRANSITIONS


def _batch_trace(lib, SSV, seed):
    bp = lib.BatchPlanner(_profile(lib, SSV, seed=seed), "Strict")
    bp.begin_serve()
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(60):
        slots = {int(s): int(rng.integers(0, len(BUCKETS))) for s in range(int(rng.integers(1, 6)))}
        plan = bp.plan(slots)
        for b, rows in plan:
            bp.observe(b, accepted=float(rng.uniform(0, 3)), latency_s=float(rng.uniform(0.01, 0.02)))
        trace.append((plan, {b: (g.rank, g.ema, g.transitions) for b, g in sorted(bp.guards.items())},
                      [_asdict(bp.strategy_for(b)) for b in range(len(BUCKETS))],
                      bp.refinement_events))
    return trace, [_asdict(s) for s in bp.reachable_strategies()]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_planner_trajectory_and_reachable_set_equal(seed):
    (jt, jr), (tt, tr) = (_batch_trace(*LIBS[k], seed) for k in ("jax", "torch"))
    assert tt == jt
    assert tr == jr
    assert tt[-1][-1] > 0                     # the guards did refine


def test_batch_planner_rejects_uncovered_class():
    for lib, SSV in LIBS.values():
        prof = _profile(lib, SSV)
        prof.table = {k: v for k, v in prof.table.items() if k[1] != "Approx-only"}
        with pytest.raises(ValueError, match="Approx-only"):
            lib.BatchPlanner(prof, "Approx-only")


def _bucket_sched_trace(lib, klib, seed, slots, gated):
    """Replay one seeded trace through the bucket admission policy."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 14))
    arrivals = rng.integers(0, 8, n).astype(float)
    lens = rng.integers(8, 900, n)
    need = rng.integers(1, 4, n)
    alloc = klib.PageAllocator(8)
    held, kw = {}, {}
    if gated:
        kw = dict(pages_for=lambda r: int(need[r.req_id]),
                  free_pages=lambda: alloc.free_count, total_pages=8)
    sched = lib.Scheduler(slots, policy="bucket",
                          bucket_of=lambda r: JP.bucket_of(len(r.prompt), BUCKETS), **kw)
    for i in range(n):
        sched.submit(lib.Request(req_id=i, prompt=np.zeros(int(lens[i])), arrival=arrivals[i]))
    log, clock = [], 0.0
    while not sched.idle() and clock < 200:
        for slot, req in sched.admit(clock):
            if gated:
                held[slot] = alloc.alloc(int(need[req.req_id]))
            sched.mark_decoding(slot)
            log.append(("admit", clock, slot, req.req_id))
        log.append(("occ", clock, sorted(sched.bucket_occupancy().items()),
                    round(sched.page_occupancy(), 6)))
        for slot in np.nonzero(sched.decoding_mask())[0]:
            if rng.random() < 0.35:
                req = sched.finish(int(slot), now=clock + 1)
                if gated:
                    alloc.free(held.pop(int(slot)))
                sched.release(int(slot))
                log.append(("done", int(slot), req.req_id, req.queue_delay))
        clock += 1.0
    return log


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("slots,seed", [(1, 0), (2, 1), (3, 2), (4, 3)])
def test_bucket_admission_matches_jax(slots, seed, gated):
    j = _bucket_sched_trace(JS, JK, seed, slots, gated)
    t = _bucket_sched_trace(TS, TK, seed, slots, gated)
    assert t == j
    assert any(e[0] == "admit" for e in t)


def test_bucket_policy_arguments_are_checked():
    for lib in (JS, TS):
        with pytest.raises(ValueError, match="bucket_of"):
            lib.Scheduler(2, policy="bucket")
        with pytest.raises(ValueError, match="policy"):
            lib.Scheduler(2, policy="lifo")
        assert lib.Scheduler(2).bucket_occupancy() == {}


def _eval_fn(num_layers, seed):
    """Numpy verification 'logits' whose KL to the baseline grows with the
    reuse set, each layer by its own seeded amount."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(6, 32))
    noise = {i: rng.normal(size=(6, 32)) * rng.uniform(0.01, 0.4) for i in range(num_layers)}
    return lambda sched: base + sum((noise[i] for i in sched), np.zeros_like(base))


@pytest.mark.parametrize("num_layers,seed,budget,max_reuse", [
    (6, 0, 0.02, None), (8, 1, 0.05, None), (8, 2, 0.5, 3), (4, 3, 1e-4, None)])
def test_greedy_calibrate_picks_the_same_schedule(num_layers, seed, budget, max_reuse):
    fn = _eval_fn(num_layers, seed)
    j = JS.greedy_calibrate(fn, num_layers, kl_budget=budget, max_reuse=max_reuse)
    t = TS.greedy_calibrate(fn, num_layers, kl_budget=budget, max_reuse=max_reuse)
    assert t == j
    assert TS.kl_divergence(fn(()), fn((1,))) == JS.kl_divergence(fn(()), fn((1,)))
