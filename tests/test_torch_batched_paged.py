"""Serving on the paged KV store, held against the JAX engines on bridged
weights (the reduced ``ssv-nsa-1b`` of ``test_torch_batched.py``): the
single stream, ``generate_batch`` and ``serve_continuous`` over 1-3 slots
are token-equal to the JAX paged engines and to the port's dense store; a
released slot's writes cannot corrupt the new tenant of its pages; a pool
too small for every slot makes admission wait and stays token-equal; a
request larger than the pool is refused; a stochastic paged run equals the
JAX one; every page returns to the pool."""
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
from repro_torch.core import draft, engine, schedule

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

MAX_NEW = 8
MAX_CTX = 256
LENS = (110, 123, 97, 131, 104, 117)
SSV = dict(tree_depth=2, tree_width=2, group_size=2)


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


def tserve(backend="paged", temperature=0.0, **kw):
    return ServeConfig(max_new_tokens=MAX_NEW, max_context=MAX_CTX, temperature=temperature,
                       ssv=SSVConfig(**SSV), kv_backend=backend, **kw)


def jserve(backend="paged", temperature=0.0, **kw):
    return JServe(max_new_tokens=MAX_NEW, max_context=MAX_CTX, temperature=temperature,
                  ssv=JSSV(**SSV), use_planner=False, kv_backend=backend, **kw)


def teng(pair, serve, cls=engine.BatchedSSVEngine):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, _ = pair
    return cls(ttp, tc, tdp, td, serve, rng_seed=3, device="cpu")


def jeng(pair, serve, cls=jengine.BatchedSSVEngine):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, _ = pair
    return cls(jtp, jc, jdp, jd, serve, rng_seed=3)


@pytest.fixture(scope="module")
def dense_reference(pair):
    """The port's dense single-stream tokens per prompt."""
    return [teng(pair, tserve("dense"), engine.SSVEngine).generate(p, MAX_NEW).tokens
            for p in pair[-1]]


def requests(lib, prompts, seed):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(prompts))
    return [lib.Request(req_id=int(i), prompt=prompts[int(i)],
                        arrival=float(rng.integers(0, 6))) for i in order]


def assert_tokens(results, reqs, reference):
    for req, gen in zip(reqs, results):
        np.testing.assert_array_equal(reference[req.req_id], gen.tokens,
                                      err_msg=f"request {req.req_id}")


def assert_pool_empty(eng):
    assert eng.allocator.free_count == eng.allocator.num_pages
    assert (eng.pages == -1).all()


def test_single_stream_paged_matches_jax_and_dense(pair, dense_reference):
    for p, ref in list(zip(pair[-1], dense_reference))[:2]:
        te = teng(pair, tserve(), engine.SSVEngine)
        je = jeng(pair, jserve(), jengine.SSVEngine)
        got, want = te.generate(p, MAX_NEW), je.generate(p, MAX_NEW)
        np.testing.assert_array_equal(want.tokens, got.tokens)
        np.testing.assert_array_equal(ref, got.tokens)
        assert te.allocator.used_count == je.allocator.used_count
        assert te.kv_cache_bytes() == je.kv_cache_bytes()
    # a reservation sized for the request, not max_context
    assert 0 < te.allocator.used_count < te.allocator.num_pages
    assert te.t_caches["pages"] is te.d_caches["pages"]


def test_generate_batch_paged_matches_jax(pair, dense_reference):
    prompts = pair[-1][:3]
    tres = teng(pair, tserve()).generate_batch(prompts, MAX_NEW)
    jres = jeng(pair, jserve()).generate_batch(prompts, MAX_NEW)
    for i, (a, b) in enumerate(zip(jres.results, tres.results)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(dense_reference[i], b.tokens)
    assert tres.steps == jres.steps


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_serve_continuous_paged_matches_jax_and_dense(pair, dense_reference, slots):
    prompts = pair[-1]
    te, je = teng(pair, tserve()), jeng(pair, jserve())
    tres = te.serve_continuous(requests(schedule, prompts, slots), num_slots=slots,
                               max_new_tokens=MAX_NEW)
    jres = je.serve_continuous(requests(jsched, prompts, slots), num_slots=slots,
                               max_new_tokens=MAX_NEW)
    for a, b in zip(jres.results, tres.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert_tokens(tres.results, tres.requests, dense_reference)
    assert [r.admitted_at for r in tres.requests] == [r.admitted_at for r in jres.requests]
    assert tres.page_occupancy == pytest.approx(jres.page_occupancy)
    assert 0.0 < tres.peak_page_occupancy <= 1.0
    assert tres.kv_bytes == jres.kv_bytes
    assert_pool_empty(te)


def test_released_slot_writes_cannot_corrupt_new_tenant(pair, dense_reference):
    """A pool that forces immediate page reuse: a finished row keeps
    stepping (inactive) after its pages went to a new request, and its
    writes must be dropped (``row_mask``), so the late requests' tokens
    still equal the dense single stream's."""
    prompts = pair[-1]
    te = teng(pair, tserve(kv_num_pages=18))          # one request needs 9 pages
    reqs = [schedule.Request(req_id=i, prompt=p, arrival=float(i // 2))
            for i, p in enumerate(prompts)]
    res = te.serve_continuous(reqs, num_slots=2, max_new_tokens=MAX_NEW)
    assert_tokens(res.results, res.requests, dense_reference)
    assert_pool_empty(te)


def test_constrained_pool_waits_and_stays_token_equal(pair, dense_reference):
    prompts = pair[-1]
    te = teng(pair, tserve(kv_num_pages=20))          # < 3 slots x 9 pages
    reqs = [schedule.Request(req_id=i, prompt=p) for i, p in enumerate(prompts)]
    res = te.serve_continuous(reqs, num_slots=3, max_new_tokens=MAX_NEW)
    assert_tokens(res.results, res.requests, dense_reference)
    assert max(res.occupancy) < 1.0                    # a slot waited for pages
    assert res.peak_page_occupancy <= 1.0
    assert_pool_empty(te)
    dense = teng(pair, tserve("dense"))
    dense.start_empty(3)
    assert te.kv_cache_bytes() < dense.kv_cache_bytes() / 2


def test_request_larger_than_pool_is_refused(pair):
    with pytest.raises(ValueError, match="pages"):
        teng(pair, tserve(kv_num_pages=2)).serve_continuous(pair[-1][:1], num_slots=1,
                                                            max_new_tokens=MAX_NEW)


def test_stochastic_paged_matches_jax(pair):
    prompts = pair[-1][:2]
    tres = teng(pair, tserve(temperature=0.7)).generate_batch(prompts, MAX_NEW)
    jres = jeng(pair, jserve(temperature=0.7)).generate_batch(prompts, MAX_NEW)
    for a, b in zip(jres.results, tres.results):
        assert len(b.tokens) >= MAX_NEW
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_inactive_row_leaves_its_pages_untouched(pair):
    """Under the paged store an inactive row's commit is dropped: its pages
    keep their bytes while the other row advances."""
    te = teng(pair, tserve())
    te.start(pair[-1][:2])
    te.step(np.array([True, True]))
    pool = te.t_caches["layers"][0]["kv"]["k"]
    mine = torch.as_tensor(te.pages[1][te.pages[1] >= 0]).long()
    before = pool[mine].clone()
    for _ in range(2):
        te.step(np.array([True, False]))
    torch.testing.assert_close(pool[mine], before, rtol=0, atol=0)
