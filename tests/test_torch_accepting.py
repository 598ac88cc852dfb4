"""The multi-token commit against the JAX package, on a pair that accepts
draft tokens without training: both models share a bigram map (the
embedding of token t, rms-normalised, hits the ``lm_head`` column of
perm[t]), and the target's attention and FFN outputs are scaled up so that
its greedy choice leaves the map now and then. Greedy serving then accepts
0 to 3 tokens per step along varying tree paths, and the port's
``SSVEngine`` (plain versions, float32) must give the JAX engine's tokens,
its accepted counts, and its committed caches (K/V rows, compressed blocks,
lengths) within rtol 2e-4 / atol 2e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import ServeConfig as JServe, SSVConfig as JSSV
from repro.core import draft as jdraft, engine as jengine
from repro_torch import configs
from repro_torch.bridge import init_params, to_jax
from repro_torch.config import ServeConfig, SSVConfig
from repro_torch.core import draft, engine, planner

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

PROMPT_LEN = 130          # > window (32) + n_selected (4) * sel_block (16)
MAX_CTX = 256
DEPTH = 3
TARGET_SCALE, DRAFT_SCALE = 3.5, 1.0


def bigram_params(cfg, perm, scale, seed):
    """Random ``init_params`` of ``cfg`` with the bigram embedding / head
    and each layer's output projections times ``scale``."""
    p = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    E = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(np.float32)
    W = np.zeros((cfg.d_model, cfg.vocab_size), np.float32)
    W[:, perm] = (E / np.linalg.norm(E, axis=1, keepdims=True)).T
    p["embed"]["table"], p["lm_head"]["w"] = torch.from_numpy(E), torch.from_numpy(W)
    for lp in p["layers"]:
        lp["mix"]["wo"] = lp["mix"]["wo"] * scale
        lp["ffn"]["w_down"] = lp["ffn"]["w_down"] * scale
    return p


@pytest.fixture(scope="module")
def pair():
    jc = dataclasses.replace(jconfigs.reduced("ssv-nsa-1b", layers=3), num_kv_heads=2)
    tc = dataclasses.replace(configs.reduced("ssv-nsa-1b", layers=3), num_kv_heads=2)
    jd, td = jdraft.draft_config(jc, num_layers=1), draft.draft_config(tc, num_layers=1)
    rng = np.random.default_rng(0)
    perm = rng.permutation(tc.vocab_size)
    prompt = rng.integers(0, tc.vocab_size, PROMPT_LEN)
    tp = bigram_params(tc, perm, TARGET_SCALE, 1)
    dp = bigram_params(td, perm, DRAFT_SCALE, 2)
    jtp = jax.tree.map(jnp.asarray, to_jax(tp, tc))
    jdp = jax.tree.map(jnp.asarray, to_jax(dp, td))
    return jc, tc, jd, td, jtp, jdp, tp, dp, prompt


def strategy(pc, layers=3):
    mode, reuse = planner.class_constraints(pc)
    return dict(tree_depth=DEPTH, tree_width=2, group_size=4 if mode == "approx" else 2,
                group_mode=mode, precision_class=pc,
                refresh_schedule=planner.default_schedule(layers) if reuse else ())


def assert_caches_close(tcache, jcache, length):
    assert int(tcache["length"][0]) == int(np.asarray(jcache["length"]).reshape(-1)[0]) == length
    for li, tl in enumerate(tcache["layers"]):
        jl = jax.tree.map(lambda a: np.asarray(a[li]), jcache["segments"][0][0])
        for k in ("k", "v"):
            np.testing.assert_allclose(tl["kv"][k][:, :length].numpy(),
                                       jl["kv"][k][:, :length], rtol=2e-4, atol=2e-5)
        for k in ("k_cmp", "v_cmp"):
            np.testing.assert_allclose(tl["cmp"][k].numpy(), jl["cmp"][k], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("pc", ["Strict", "Approx+Reuse"])
def test_accepting_pair_commits_as_jax(pair, pc):
    jc, tc, jd, td, jtp, jdp, tp, dp, prompt = pair
    kw = strategy(pc)
    jeng = jengine.SSVEngine(jtp, jc, jdp, jd, JServe(
        max_new_tokens=16, max_context=MAX_CTX, ssv=JSSV(**kw), use_planner=False))
    teng = engine.SSVEngine(tp, tc, dp, td, ServeConfig(
        max_new_tokens=16, max_context=MAX_CTX, ssv=SSVConfig(**kw)), device="cpu")
    jr, tr = jeng.generate(prompt, 16), teng.generate(prompt, 16)
    accepted = [s.accepted for s in tr.steps]
    # the pair does what the test is for: multi-token commits on varying paths
    assert sum(accepted) >= 4 and any(0 < a < DEPTH for a in accepted), accepted
    np.testing.assert_array_equal(jr.tokens, tr.tokens)
    assert [s.accepted for s in jr.steps] == accepted
    assert teng.committed_len == jeng.committed_len
    assert_caches_close(teng.t_caches, jeng.t_caches, teng.committed_len)


def test_strict_follows_the_verify_semantics_not_autoregressive(pair):
    """Strict is exact to the reference's tree-verify semantics, in which a
    tree node's cmp and slc branches see the committed prefix only (its
    accepted ancestors reach it through the window branch), not to
    autoregressive decoding, where they are prefix too. Once drafts are
    accepted the two can part: on this pair the JAX engine's Strict tokens
    leave the JAX autoregressive ones, the port's autoregressive tokens
    equal JAX's, and the port's Strict tokens equal the JAX engine's (the
    test above)."""
    jc, tc, jd, td, jtp, jdp, tp, dp, prompt = pair
    jeng = jengine.SSVEngine(jtp, jc, jdp, jd, JServe(
        max_new_tokens=16, max_context=MAX_CTX, ssv=JSSV(**strategy("Strict")),
        use_planner=False))
    jr = jeng.generate(prompt, 16)
    jar = jengine.autoregressive_decode(jtp, jc, prompt, 16, MAX_CTX)
    tar = engine.autoregressive_decode(tp, tc, prompt, 16, MAX_CTX, device="cpu")
    np.testing.assert_array_equal(tar.tokens, jar.tokens)
    assert sum(s.accepted for s in jr.steps) > 0
    assert not np.array_equal(jr.tokens, jar.tokens)
