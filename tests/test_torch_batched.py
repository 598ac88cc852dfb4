"""Batched and continuous serving of the port on the dense KV store, held
against the JAX ``BatchedSSVEngine`` on bridged weights (reduced
``ssv-nsa-1b``: 2 layers, 2 kv heads, 1-layer draft; prompts longer than
window + n * sel_block): ``generate_batch`` under Strict and Approx+Reuse,
``serve_continuous`` over 1-3 slots with staggered arrivals (tokens and
admission times), a stochastic batched run drawing the same uniforms, and
each row against the port's own single-stream ``SSVEngine``. Also: a
completion mask freezes a row (length and cache bytes), and the modes that
need a planner refuse without one. Tokens must be equal, not close."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import ServeConfig as JServe, SSVConfig as JSSV
from repro.core import draft as jdraft, engine as jengine, schedule as jsched
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.bridge import from_jax
from repro_torch.config import ServeConfig, SSVConfig
from repro_torch.core import draft, engine, planner, schedule

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

MAX_NEW = 8
MAX_CTX = 256
LENS = (110, 123, 97, 131, 104, 117)


@pytest.fixture(scope="module")
def pair():
    jc = dataclasses.replace(jconfigs.reduced("ssv-nsa-1b", layers=2), num_kv_heads=2)
    tc = dataclasses.replace(configs.reduced("ssv-nsa-1b", layers=2), num_kv_heads=2)
    jd, td = jdraft.draft_config(jc, num_layers=1), draft.draft_config(tc, num_layers=1)
    jtp, jdp = jmodel.init(jax.random.PRNGKey(0), jc), jmodel.init(jax.random.PRNGKey(1), jd)
    ttp = from_jax(jax.tree.map(np.asarray, jtp), tc, "cpu")
    tdp = from_jax(jax.tree.map(np.asarray, jdp), td, "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab_size, n) for n in LENS]
    return jc, tc, jd, td, jtp, jdp, ttp, tdp, prompts


def strategy(pc="Strict"):
    mode, reuse = planner.class_constraints(pc)
    return dict(tree_depth=2, tree_width=2, group_size=4 if mode == "approx" else 2,
                group_mode=mode, precision_class=pc,
                refresh_schedule=planner.default_schedule(2) if reuse else ())


def engines(pair, pc="Strict", temperature=0.0, **store):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, _ = pair
    kw = strategy(pc)
    je = jengine.BatchedSSVEngine(jtp, jc, jdp, jd, JServe(
        max_new_tokens=MAX_NEW, max_context=MAX_CTX, temperature=temperature,
        ssv=JSSV(**kw), use_planner=False, **store), rng_seed=3)
    te = engine.BatchedSSVEngine(ttp, tc, tdp, td, ServeConfig(
        max_new_tokens=MAX_NEW, max_context=MAX_CTX, temperature=temperature,
        ssv=SSVConfig(**kw), **store), rng_seed=3, device="cpu")
    return je, te


def requests(lib, prompts, seed):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(prompts))
    return [lib.Request(req_id=int(i), prompt=prompts[int(i)],
                        arrival=float(rng.integers(0, 6))) for i in order]


def assert_same(jres, tres):
    assert len(jres.results) == len(tres.results)
    for a, b in zip(jres.results, tres.results):
        assert len(b.tokens) == MAX_NEW
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert [s.accepted for s in a.steps] == [s.accepted for s in b.steps]
    assert jres.steps == tres.steps


@pytest.mark.parametrize("pc", ["Strict", "Approx+Reuse"])
def test_generate_batch_matches_jax(pair, pc):
    prompts = pair[-1][:3]
    je, te = engines(pair, pc)
    assert_same(je.generate_batch(prompts, MAX_NEW), te.generate_batch(prompts, MAX_NEW))


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_serve_continuous_matches_jax(pair, slots):
    prompts = pair[-1]
    je, te = engines(pair)
    jres = je.serve_continuous(requests(jsched, prompts, slots), num_slots=slots,
                               max_new_tokens=MAX_NEW)
    tres = te.serve_continuous(requests(schedule, prompts, slots), num_slots=slots,
                               max_new_tokens=MAX_NEW)
    assert_same(jres, tres)
    assert [r.admitted_at for r in tres.requests] == [r.admitted_at for r in jres.requests]
    assert [r.finished_at for r in tres.requests] == [r.finished_at for r in jres.requests]
    assert tres.occupancy == jres.occupancy
    if slots < len(prompts):
        assert max(r.admitted_at for r in tres.requests) > 0.0      # admitted mid-flight
    assert tres.kv_bytes == te.kv_cache_bytes() > 0


def test_rows_equal_single_stream(pair):
    """Each row of a 3-row batch emits what the port's single-stream engine
    emits for its prompt alone."""
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompts = pair
    _, te = engines(pair)
    res = te.generate_batch(prompts[3:], MAX_NEW)
    for p, r in zip(prompts[3:], res.results):
        single = engine.SSVEngine(ttp, tc, tdp, td, ServeConfig(
            max_new_tokens=MAX_NEW, max_context=MAX_CTX, ssv=SSVConfig(**strategy())),
            device="cpu")
        np.testing.assert_array_equal(single.generate(p, MAX_NEW).tokens, r.tokens)


def test_stochastic_batch_matches_jax(pair):
    """Temperature 0.7: both engines draw each row's uniforms from the same
    numpy seed in the same order, so the sampled tokens agree too."""
    prompts = pair[-1][:2]
    je, te = engines(pair, temperature=0.7)
    jres, tres = je.generate_batch(prompts, MAX_NEW), te.generate_batch(prompts, MAX_NEW)
    for a, b in zip(jres.results, tres.results):
        assert len(b.tokens) >= MAX_NEW
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_completion_mask_freezes_rows(pair):
    """An inactive row commits nothing: its length and its compressed cache
    stay as they were while the active row advances (dense: its K/V below
    the length are untouched too)."""
    prompts = pair[-1]
    _, te = engines(pair)
    te.start(prompts[:2])
    te.step(np.array([True, True]))
    lens = [c["length"].clone() for c in (te.t_caches, te.d_caches)]
    kv1 = te.t_caches["layers"][0]["kv"]["k"][1, :int(lens[0][1])].clone()
    cmp1 = te.t_caches["layers"][1]["cmp"]["k_cmp"][1].clone()
    committed = te.committed_len.copy()
    for _ in range(2):
        toks, n = te.step(np.array([True, False]))
    for before, c in zip(lens, (te.t_caches, te.d_caches)):
        assert int(c["length"][1]) == int(before[1])
        assert int(c["length"][0]) > int(before[0])
    assert te.committed_len[1] == committed[1] and te.committed_len[0] > committed[0]
    torch.testing.assert_close(te.t_caches["layers"][0]["kv"]["k"][1, :int(lens[0][1])], kv1,
                               rtol=0, atol=0)
    torch.testing.assert_close(te.t_caches["layers"][1]["cmp"]["k_cmp"][1], cmp1, rtol=0, atol=0)
    assert toks.shape == (2, 3) and n.shape == (2,)


def test_unported_modes_refuse(pair):
    """The planner's modes refuse without their planner, with the JAX
    engine's errors (bucketed serving and warmup need a BatchPlanner), and
    a prompt past the headroom is refused."""
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompts = pair
    serve = ServeConfig(max_new_tokens=MAX_NEW, max_context=MAX_CTX, ssv=SSVConfig(**strategy()))
    te = engine.BatchedSSVEngine(ttp, tc, tdp, td, serve, device="cpu")
    with pytest.raises(ValueError, match="BatchPlanner"):
        te.serve_continuous(prompts[:1], num_slots=1, bucketed=True)
    with pytest.raises(ValueError, match="warmup"):
        te.serve_continuous(prompts[:1], num_slots=1, warmup=True)
    with pytest.raises(ValueError, match="BatchPlanner"):
        te.warmup()
    with pytest.raises(ValueError, match="bucket_of"):
        schedule.Scheduler(2, policy="bucket")
    with pytest.raises(ValueError, match="headroom"):
        te.generate_batch([np.arange(MAX_CTX - 4)], MAX_NEW)
