"""Bucketed serving of the port on the CPU (reduced ``ssv-nsa-1b``: 2
layers, 2 kv heads, 1-layer draft; weights bridged from the JAX package),
held against the JAX package:

  * every request of the port's bucketed ``serve_continuous`` (mixed prompt
    lengths over two context buckets, mid-flight admission, 1 and 3 slots,
    the dense and the paged store) equals the JAX single-stream
    ``SSVEngine.generate`` under its bucket's strategy (computed once per
    module);
  * the warmup contract of ``tests/test_engine_bucketed.py``: 2 strategies
    x group sizes {1, 2} = 4 entries, no miss mid-serve, re-warming free;
  * ``step_group`` leaves rows outside the group byte-identical (a
    gathered group and a direct one), and pads are never written back;
  * the JAX validation errors;
  * ``SSVEngine`` with a ``RuntimePlanner`` whose guard refines twice
    gives the JAX engine's tokens and strategy sequence;
  * with a planner attached, ``request_pages`` / ``step_headroom`` match
    JAX; the bucketed serve CLI on the CPU.
Tokens must be equal, not close."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import ServeConfig as JServe, SSVConfig as JSSV
from repro.core import draft as jdraft, engine as jengine, planner as JP
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.bridge import from_jax
from repro_torch.config import ServeConfig, SSVConfig
from repro_torch.core import draft, engine, planner as TP, schedule
from repro_torch.launch import serve as serve_cli

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

MAX_NEW = 8
MAX_CTX = 256
BUCKETS = ((0, 112), (112, 512))
SHAPES = {"short": dict(tree_depth=1, tree_width=2), "long": dict(tree_depth=2, tree_width=2)}
# 110 / 97 / 104 fall in bucket 0, 123 / 131 / 117 in bucket 1
LENS = (110, 123, 97, 131, 104, 117)


def _profile(lib, SSV, guard_quiet=True, buckets=BUCKETS):
    """Bucket 0 -> short tree, bucket 1 -> long tree. expected_accept 0
    keeps the guards quiet, so each bucket's strategy is fixed."""
    ea = 0.0 if guard_quiet else 9.0
    return lib.Profile(table={(0, "Strict"): [lib.ProfileEntry(SSV(**SHAPES["short"]), ea, 0.01)],
                              (1, "Strict"): [lib.ProfileEntry(SSV(**SHAPES["long"]), ea, 0.01)]},
                       buckets=buckets)


def _serve(lib_cfg, shape="long", backend="dense"):
    Serve, SSV = lib_cfg
    return Serve(max_new_tokens=MAX_NEW, max_context=MAX_CTX, temperature=0.0,
                 ssv=SSV(**SHAPES[shape]), use_planner=False, kv_backend=backend)


J, T = (JServe, JSSV), (ServeConfig, SSVConfig)


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


@pytest.fixture(scope="module")
def jax_reference(pair):
    """JAX single-stream tokens per prompt under its bucket's strategy."""
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompts = pair
    out = []
    for p in prompts:
        shape = ("short", "long")[JP.bucket_of(len(p), BUCKETS)]
        eng = jengine.SSVEngine(jtp, jc, jdp, jd, _serve(J, shape))
        out.append(eng.generate(p, max_new_tokens=MAX_NEW).tokens)
    return out


def _engine(pair, backend="dense", planner=True):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, _ = pair
    return engine.BatchedSSVEngine(ttp, tc, tdp, td, _serve(T, backend=backend),
                                   planner=TP.BatchPlanner(_profile(TP, SSVConfig))
                                   if planner else None, device="cpu")


def _requests(prompts, seed):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(prompts))
    return [schedule.Request(req_id=int(i), prompt=prompts[int(i)],
                             arrival=float(rng.integers(0, 6))) for i in order]


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("slots", [1, 3])
def test_bucketed_tokens_equal_jax_single_stream(pair, jax_reference, slots, backend):
    eng = _engine(pair, backend)
    res = eng.serve_continuous(_requests(pair[-1], seed=slots), num_slots=slots,
                               max_new_tokens=MAX_NEW, warmup=slots == 3)
    for req, gen in zip(res.requests, res.results):
        np.testing.assert_array_equal(jax_reference[req.req_id], gen.tokens,
                                      err_msg=f"request {req.req_id} (slots={slots}, {backend})")
    if slots < len(LENS):
        assert max(r.admitted_at for r in res.requests) > 0.0      # admitted mid-flight
    assert res.group_launches >= res.steps
    assert set(res.bucket_occupancy) == {0, 1}
    assert all(0.0 < v <= 1.0 for v in res.bucket_occupancy.values())
    for key in ("step_cache_hits", "step_cache_misses", "step_cache_cached",
                "verify_call_hits", "verify_call_misses", "group_layout_hits",
                "group_layout_misses"):
        assert key in res.kernel_cache


def test_warmup_builds_every_reachable_step(pair):
    """2 strategies x group sizes {1, 2}; the serve then builds nothing,
    and warming again is free."""
    eng = _engine(pair)
    n = eng.warmup(num_slots=2)
    assert n == 4 and eng.step_cache.misses == n and eng.step_cache.size == n
    res = eng.serve_continuous(_requests(pair[-1], seed=7), num_slots=2, max_new_tokens=MAX_NEW)
    assert eng.step_cache.misses == n, "a group step was built mid-serve"
    assert eng.step_cache.hits >= res.group_launches
    assert eng.warmup(num_slots=2) == 0
    assert eng.kernel_cache_stats()["step_cache_misses"] == n
    eng.start_empty(3)                       # another slot count drops the cache
    assert eng.step_cache.size == 0


def _row_bytes(eng, row):
    return [t[row].clone() for caches in (eng.t_caches, eng.d_caches)
            for t in engine._row_leaves(caches, eng.store.is_paged)]


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("slots,rows", [(3, [0, 1]), (4, [0, 1, 3])])
def test_step_group_leaves_other_rows_untouched(pair, slots, rows, backend):
    """(3, [0, 1]) is a gathered group of 2; (4, [0, 1, 3]) covers the
    slot count's group size and steps the caches directly with row 2
    inactive. Row 2 keeps every cache byte, its length, pending root and
    admission reset, and steps correctly afterwards."""
    prompts = pair[-1]
    eng = _engine(pair, backend, planner=False)
    eng.start_empty(slots)
    for s in range(slots):
        eng.admit(s, prompts[s])
    before = _row_bytes(eng, 2)
    pool = [t.clone() for t in (eng.t_caches["layers"][0]["kv"]["k"],)] if backend == "paged" else []
    len2, pend2 = int(eng.committed_len[2]), int(eng.pending[2])
    short = SSVConfig(**SHAPES["short"])
    toks, n_acc = eng.step_group(rows, short)
    assert toks.shape[0] == len(rows) and n_acc.shape == (len(rows),)
    for b, a in zip(before, _row_bytes(eng, 2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if pool:   # row 2's pages are untouched in the shared pool
        pg = torch.as_tensor(eng.pages[2][eng.pages[2] >= 0]).long()
        torch.testing.assert_close(eng.t_caches["layers"][0]["kv"]["k"][pg], pool[0][pg],
                                   rtol=0, atol=0)
    assert int(eng.committed_len[2]) == len2 and int(eng.pending[2]) == pend2
    assert bool(eng._admit_mask[2])
    assert not any(eng._admit_mask[r] for r in rows)
    for r in rows:
        assert int(eng.committed_len[r]) > len(prompts[r]) - 1
    eng.step_group([2], SSVConfig(**SHAPES["long"]))
    assert int(eng.committed_len[2]) > len2
    for caches in (eng.t_caches, eng.d_caches):
        np.testing.assert_array_equal(caches["length"].numpy(), eng.committed_len)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_pads_are_never_written_back(pair, backend):
    """Slots 5, group [0, 2, 4]: padded to 4 rows with an inactive copy of
    row 0. Row 0 ends exactly as when it is stepped alone (group [0])."""
    prompts = pair[-1]
    short = SSVConfig(**SHAPES["short"])
    engs = []
    for group in ([0, 2, 4], [0]):
        eng = _engine(pair, backend, planner=False)
        eng.start_empty(5)
        for s in range(5):
            eng.admit(s, prompts[s])
        toks, n_acc = eng.step_group(group, short)
        engs.append((eng, toks[0], n_acc[0]))
    (a, ta, na), (b, tb, nb) = engs
    assert (na, ta.tolist()) == (nb, tb.tolist())
    for x, y in zip(_row_bytes(a, 0), _row_bytes(b, 0)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.committed_len[0] == b.committed_len[0]
    if backend == "paged":
        pg = torch.as_tensor(a.pages[0][a.pages[0] >= 0]).long()
        for la, lb in zip(a.t_caches["layers"], b.t_caches["layers"]):
            torch.testing.assert_close(la["kv"]["v"][pg], lb["kv"]["v"][pg], rtol=0, atol=0)


def test_validation_errors_match_jax(pair):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompts = pair
    short = SSVConfig(**SHAPES["short"])
    eng = _engine(pair, planner=False)
    eng.start_empty(2)
    for rows, match in (([], "empty"), ([0, 0], "duplicate"), ([2], "range")):
        with pytest.raises(ValueError, match=match):
            eng.step_group(rows, short)
    with pytest.raises(ValueError, match="BatchPlanner"):
        eng.serve_continuous([prompts[0]], num_slots=2, bucketed=True)
    with pytest.raises(ValueError, match="warmup"):
        eng.serve_continuous([prompts[0]], num_slots=2, warmup=True)
    with pytest.raises(ValueError, match="BatchPlanner"):
        eng.warmup(num_slots=2)
    beng = _engine(pair)
    with pytest.raises(ValueError, match="bucketed"):
        beng.serve_continuous([prompts[0]], num_slots=2, bucketed=False)
    with pytest.raises(ValueError, match="BatchedSSVEngine"):
        engine.SSVEngine(ttp, tc, tdp, td, _serve(T), planner=beng.planner, device="cpu")
    # the drain-entry API stays usable under a BatchPlanner: step() demands
    # an explicit strategy (there is no single batch-wide plan)
    beng.start([prompts[0], prompts[2]])
    with pytest.raises(ValueError, match="strategy"):
        beng.step(active=np.array([True, True]))
    toks, n_acc = beng.step(active=np.array([True, True]), strategy=short)
    assert toks.shape[0] == 2 and n_acc.shape == (2,)


def _runtime_profile(lib, SSV):
    """One bucket, three ranked strategies with an expectation no step
    meets, so the guard (warmup 2, hysteresis 2) refines twice, after
    steps 3 and 5. Its early window ends at step 6, before the fallback to
    the best explored rank, which ranks by measured step latency (two
    engines' wall clocks differ; tests/test_torch_planner.py holds the
    fallback on seeded latencies)."""
    shapes = [dict(tree_depth=1, tree_width=2), dict(tree_depth=2, tree_width=2),
              dict(tree_depth=1, tree_width=3)]
    return lib.Profile(table={(0, "Strict"): [lib.ProfileEntry(SSV(**s), 9.0, 0.01)
                                              for s in shapes]}, buckets=((0, 4096),))


def test_runtime_planner_refines_like_jax(pair):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompts = pair
    kw = dict(warmup_m=2, hysteresis_h=2, early_window=6)
    jpl = JP.RuntimePlanner(_runtime_profile(JP, JSSV), "Strict", **kw)
    tpl = TP.RuntimePlanner(_runtime_profile(TP, SSVConfig), "Strict", **kw)
    jres = jengine.SSVEngine(jtp, jc, jdp, jd, _serve(J), planner=jpl).generate(prompts[0], 12)
    tres = engine.SSVEngine(ttp, tc, tdp, td, _serve(T), planner=tpl,
                            device="cpu").generate(prompts[0], 12)
    np.testing.assert_array_equal(jres.tokens, tres.tokens)
    strat = lambda res: [dataclasses.asdict(s.strategy) for s in res.steps]
    assert strat(tres) == strat(jres)
    assert tpl.refinement_events == jpl.refinement_events == 2
    assert len({str(s) for s in strat(tres)}) == 3


@pytest.mark.parametrize("page_size,prompt_len,max_new", [(16, 100, 8), (32, 200, 0),
                                                         (16, 2000, 64)])
def test_request_pages_with_planner_match_jax(page_size, prompt_len, max_new):
    """The planner's largest tree sets the headroom of every reservation."""
    jp = JP.BatchPlanner(_profile(JP, JSSV, guard_quiet=False))
    tp = TP.BatchPlanner(_profile(TP, SSVConfig, guard_quiet=False))
    for jpl, tpl in ((None, None), (jp, tp)):
        js = JServe(max_new_tokens=32, max_context=2048, ssv=JSSV(tree_depth=1, tree_width=2))
        ts = ServeConfig(max_new_tokens=32, max_context=2048,
                         ssv=SSVConfig(tree_depth=1, tree_width=2))
        assert engine.max_draft_gamma(ts, tpl) == jengine.max_draft_gamma(js, jpl)
        assert engine.step_headroom(ts, tpl) == jengine.step_headroom(js, jpl)
        assert engine.request_pages(ts, tpl, page_size, 2048 // page_size, prompt_len, max_new) \
            == jengine.request_pages(js, jpl, page_size, 2048 // page_size, prompt_len, max_new)
    assert engine.step_headroom(ts, tp) > engine.step_headroom(ts, None)


def test_bucketed_serve_cli_on_cpu(tmp_path, capsys):
    path = tmp_path / "profile.json"
    # prompts of 20, 40 and 80 tokens: bucket 0 holds the first
    path.write_text(_profile(TP, SSVConfig, buckets=((0, 30), (30, 2048))).to_json())
    serve_cli.main(["--reduced", "--device", "cpu", "--prompts", "3", "--tokens", "4",
                    "--prompt-len", "40", "--batch", "2", "--continuous", "--bucketed",
                    "--profile-json", str(path), "--warmup"])
    out = capsys.readouterr().out
    assert "prompt 2: 4 tokens" in out and "continuous over 2 slots" in out
    line = next(l for l in out.splitlines() if l.startswith("bucketed:"))
    # 2 strategies x group sizes {1, 2}: built by warmup, none mid-serve
    assert "bucket0=" in line and "bucket1=" in line and "/ 4 misses" in line
