"""End-to-end parity of the port with the JAX package on bridged weights:
greedy ``SSVEngine.generate`` on reduced ``ssv-nsa-1b`` (3 layers, 2 kv
heads) is token-equal to the JAX engine under Strict and Approx+Reuse, with
prompts longer than window + n * sel_block; the verify step's logits agree
within rtol=1e-4, atol=1e-4 (float32; the JAX model path runs the jnp
oracle, the port its kernels' plain versions, so sums run in other
orders); prefill caches agree; Strict SSV equals autoregressive decoding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import ServeConfig as JServe, SSVConfig as JSSV
from repro.core import draft as jdraft, engine as jengine
from repro.core.tree import build_topology
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.bridge import from_jax
from repro_torch.config import ServeConfig, SSVConfig
from repro_torch.core import draft, engine, planner

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

PROMPT_LEN = 130          # > window (32) + n_selected (4) * sel_block (16)
MAX_CTX = 256


@pytest.fixture(scope="module")
def pair():
    jc = dataclasses.replace(jconfigs.reduced("ssv-nsa-1b", layers=3), num_kv_heads=2)
    tc = dataclasses.replace(configs.reduced("ssv-nsa-1b", layers=3), num_kv_heads=2)
    jd, td = jdraft.draft_config(jc, num_layers=1), draft.draft_config(tc, num_layers=1)
    jtp, jdp = jmodel.init(jax.random.PRNGKey(0), jc), jmodel.init(jax.random.PRNGKey(1), jd)
    ttp = from_jax(jax.tree.map(np.asarray, jtp), tc, "cpu")
    tdp = from_jax(jax.tree.map(np.asarray, jdp), td, "cpu")
    prompt = np.random.default_rng(0).integers(0, tc.vocab_size, PROMPT_LEN)
    return jc, tc, jd, td, jtp, jdp, ttp, tdp, prompt


def strategy(pc, layers=3):
    mode, reuse = planner.class_constraints(pc)
    return dict(tree_depth=3, tree_width=2, group_size=4 if mode == "approx" else 2,
                group_mode=mode, precision_class=pc,
                refresh_schedule=planner.default_schedule(layers) if reuse else ())


@pytest.mark.parametrize("pc", ["Strict", "Approx+Reuse"])
def test_generate_token_equal_to_jax(pair, pc):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompt = pair
    kw = strategy(pc)
    jeng = jengine.SSVEngine(jtp, jc, jdp, jd, JServe(
        max_new_tokens=16, max_context=MAX_CTX, ssv=JSSV(**kw), use_planner=False))
    teng = engine.SSVEngine(ttp, tc, tdp, td, ServeConfig(
        max_new_tokens=16, max_context=MAX_CTX, ssv=SSVConfig(**kw)), device="cpu")
    jr, tr = jeng.generate(prompt, 16), teng.generate(prompt, 16)
    assert len(tr.tokens) == 16
    np.testing.assert_array_equal(jr.tokens, tr.tokens)
    assert [s.accepted for s in jr.steps] == [s.accepted for s in tr.steps]
    assert all(s.host_elems <= engine.step_host_transfer_elems(SSVConfig(**kw))
               for s in tr.steps)


@pytest.fixture(scope="module")
def prefilled(pair):
    """The prompt (but its last token) prefilled by both packages, once for
    both strategies below (the verify steps do not write the caches)."""
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompt = pair
    toks = prompt[None, :-1]
    _, jcache = jmodel.prefill(jtp, jc, jnp.asarray(toks), MAX_CTX)
    from repro_torch.models import model as tmodel
    _, tcache = tmodel.prefill(ttp, tc, torch.from_numpy(np.array(toks)), MAX_CTX)
    return jcache, tcache


@pytest.mark.parametrize("pc", ["Strict", "Approx+Reuse"])
def test_verify_step_logits_match_jax(pair, prefilled, pc):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompt = pair
    kw = strategy(pc)
    jcache, tcache = prefilled
    from repro_torch.models import model as tmodel
    topo = build_topology(3, 2, "bfs")
    T = topo.num_nodes
    draft_toks = np.random.default_rng(1).integers(0, tc.vocab_size, (1, T))
    pos = (PROMPT_LEN - 1 + topo.depths)[None].astype(np.int32)
    jl, _ = jmodel.verify_step(jtp, jc, jcache, jnp.asarray(draft_toks), jnp.asarray(pos),
                               jnp.asarray(topo.mask)[None], jnp.asarray(topo.parents),
                               JSSV(**kw))
    tl, _ = tmodel.verify_step(ttp, tc, tcache, torch.from_numpy(draft_toks),
                               torch.from_numpy(pos), torch.from_numpy(topo.mask)[None],
                               None, SSVConfig(**kw))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    for li, tlayer in enumerate(tcache["layers"]):
        jl_ = jax.tree.map(lambda a: np.asarray(a[li]), jcache["segments"][0][0])
        np.testing.assert_allclose(tlayer["kv"]["k"].numpy(), jl_["kv"]["k"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tlayer["cmp"]["k_cmp"].numpy(), jl_["cmp"]["k_cmp"],
                                   rtol=2e-4, atol=2e-5)


def test_strict_equals_autoregressive(pair):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompt = pair
    ar = engine.autoregressive_decode(ttp, tc, prompt, 14, MAX_CTX, device="cpu")
    eng = engine.SSVEngine(ttp, tc, tdp, td, ServeConfig(
        max_new_tokens=14, max_context=MAX_CTX, ssv=SSVConfig(**strategy("Strict"))),
        device="cpu")
    np.testing.assert_array_equal(ar.tokens, eng.generate(prompt, 14).tokens)


def test_entry_points_refuse_to_drift_to_cpu(pair, monkeypatch):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompt = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.SSVEngine(ttp, tc, tdp, td, ServeConfig(max_context=MAX_CTX))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.autoregressive_decode(ttp, tc, prompt, 2, MAX_CTX)


def test_stochastic_dfs_generate_matches_jax(pair):
    """Sampling at temperature 0.7 over a DFS tree: both engines draw the
    same uniforms from the same numpy seed, so the tokens agree too."""
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompt = pair
    kw = dict(strategy("Strict"), traversal="dfs")
    jeng = jengine.SSVEngine(jtp, jc, jdp, jd, JServe(
        max_new_tokens=10, temperature=0.7, max_context=MAX_CTX, ssv=JSSV(**kw),
        use_planner=False), rng_seed=4)
    teng = engine.SSVEngine(ttp, tc, tdp, td, ServeConfig(
        max_new_tokens=10, temperature=0.7, max_context=MAX_CTX, ssv=SSVConfig(**kw)),
        rng_seed=4, device="cpu")
    jr, tr = jeng.generate(prompt, 10), teng.generate(prompt, 10)
    np.testing.assert_array_equal(jr.tokens, tr.tokens)
    assert [s.accepted for s in jr.steps] == [s.accepted for s in tr.steps]
