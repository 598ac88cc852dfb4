"""Head dim 128 (the paper's ssv-nsa-8b) and the vanilla NSA baseline in
the port, against the JAX package on bridged weights: ``reduced`` gives
the JAX reduced 8B config (4 heads of dim 128); the kernel-backed NSA
layer (refresh and reuse) matches the JAX layer at head dim 128; the
branch-wise vanilla layer matches the JAX ``nsa_verify_vanilla_layer`` and
the port's ``nsa_verify_ref`` at head dims 64 and 128 (rtol=1e-4,
atol=1e-5, as the JAX package's own vanilla test); greedy generation on
reduced ssv-nsa-8b is token-equal to the JAX engine under Strict and
Approx+Reuse; the serve CLI takes ``--arch ssv-nsa-8b``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import ModelConfig as JModelConfig, NSAConfig as JNSAConfig
from repro.config import ServeConfig as JServe, SSVConfig as JSSV
from repro.core import draft as jdraft, engine as jengine
from repro.kernels.nsa_verify import ops as jops
from repro.models import model as jmodel, nsa as jnsa
from repro_torch import configs
from repro_torch.bridge import from_jax
from repro_torch.config import ModelConfig, NSAConfig, ServeConfig, SSVConfig
from repro_torch.core import draft, engine, planner
from repro_torch.kernels.nsa_verify import ops
from repro_torch.launch import serve
from repro_torch.models import nsa

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
NSA_KW = dict(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4, window=32)
init = jax.jit(jmodel.init, static_argnums=1)
# the JAX layers jitted (cfg and strategy static): one compile instead of
# an eager dispatch per op keeps the file well inside a minute
jax_vanilla = jax.jit(jops.nsa_verify_vanilla_layer, static_argnums=1)
jax_layer = jax.jit(jops.nsa_verify_kernel_layer, static_argnums=1,
                    static_argnames=("C", "mode", "reuse"))
jax_ref = jax.jit(jnsa.nsa_verify_ref, static_argnums=1)
jax_prefill = jax.jit(jmodel.prefill, static_argnums=(1, 3))


def t(a):
    return torch.from_numpy(np.array(a))


def test_reduced_8b_is_the_jax_reduced_config():
    for name in ("ssv-nsa-8b",):
        assert dataclasses.asdict(configs.get_config(name)) == \
            dataclasses.asdict(jconfigs.get_config(name))
    tc, jc = configs.reduced("ssv-nsa-8b", d_model=512), jconfigs.reduced("ssv-nsa-8b", d_model=512)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.num_heads, tc.head_dim) == (4, 128)
    full = configs.get_config("ssv-nsa-8b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == (32, 4096, 32, 8, 128, 14336, 128256)
    assert draft.draft_config(full).head_dim == 128


def _layer(dh):
    """One NSA layer of head dim ``dh`` (4 query heads, 2 kv heads) with its
    caches after a 100-token JAX prefill, and a 5-node tree at 100."""
    kw = dict(name="t", num_layers=1, d_model=4 * dh, num_heads=4,
              num_kv_heads=2, d_ff=128, vocab_size=97, dtype="float32", attention="nsa")
    jcfg, cfg = JModelConfig(**kw, nsa=JNSAConfig(**NSA_KW)), ModelConfig(**kw, nsa=NSAConfig(**NSA_KW))
    assert cfg.head_dim == dh
    key = jax.random.PRNGKey(dh)
    p = init(key, jcfg)
    bp = jax.tree.map(lambda a: a[0], p["segments"][0][0])
    tbp = from_jax(jax.tree.map(np.asarray, p), cfg, "cpu")["layers"][0]
    toks = jax.random.randint(key, (1, 100), 0, 97)
    _, caches = jax_prefill(p, jcfg, toks, 160)
    cache = jax.tree.map(lambda a: a[0], caches["segments"][0][0])
    tcache = {g: {k: t(v) for k, v in cache[g].items()} for g in ("kv", "cmp")}
    rng = np.random.default_rng(dh)
    x = rng.normal(size=(1, 5, cfg.d_model)).astype(np.float32)
    parents, depths = [-1, 0, 0, 1, 2], [0, 1, 1, 2, 2]
    tm = np.zeros((5, 5), bool)
    for i in range(5):
        j = i
        while j >= 0:
            tm[i, j], j = True, parents[j]
    pos = (100 + np.asarray(depths, np.int32))[None]
    return jcfg, cfg, bp, tbp, cache, tcache, x, pos, tm[None]


@pytest.fixture(scope="module")
def layer64():
    return _layer(64)


@pytest.fixture(scope="module")
def layer128():
    return _layer(128)


@pytest.mark.parametrize("dh", [64, 128])
def test_vanilla_layer_matches_jax_and_nsa_verify_ref(request, dh):
    jcfg, cfg, bp, tbp, cache, tcache, x, pos, tm = request.getfixturevalue(f"layer{dh}")
    jout, _, (jsi, _) = jax_vanilla(
        bp["mix"], jcfg, jnp.asarray(x), cache["kv"], cache["cmp"], 100,
        jnp.asarray(pos), jnp.asarray(tm))
    out, (k_new, _), (si, _) = ops.nsa_verify_vanilla_layer(
        tbp["mix"], cfg, t(x), tcache["kv"], tcache["cmp"], torch.tensor(100), t(pos), t(tm))
    ref, (k_ref, _), (si_ref, _) = nsa.nsa_verify_ref(
        tbp["mix"], cfg, t(x), tcache["kv"], tcache["cmp"], torch.tensor(100), t(pos), t(tm))
    np.testing.assert_array_equal(si.numpy(), np.asarray(jsi))
    np.testing.assert_array_equal(si.numpy(), si_ref.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **LAYER_TOL)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **LAYER_TOL)
    assert torch.equal(k_new, k_ref)


@pytest.mark.parametrize("C,mode", [(2, "exact"), (4, "approx")])
def test_kernel_layer_matches_jax_at_head_dim_128(layer128, C, mode):
    """Refresh layer (routing, Top-n, partial fusion) and reuse layer (full
    fusion on the carried indices) against the JAX kernel layer."""
    jcfg, cfg, bp, tbp, cache, tcache, x, pos, tm = layer128
    jx, jpos, jtm = jnp.asarray(x), jnp.asarray(pos), jnp.asarray(tm)
    ref_out, _, (si, sv) = jax_ref(bp["mix"], jcfg, jx, cache["kv"], cache["cmp"], 100,
                                   jpos, jtm)
    if mode == "approx":
        from repro.core.overlap import shared_index
        si, sv = shared_index(si, sv, jpos, C)
        ref_out = jax_ref(bp["mix"], jcfg, jx, cache["kv"], cache["cmp"], 100,
                          jpos, jtm, sel_idx=si, sel_valid=sv)[0]
    out, _, (tsi, tsv) = ops.nsa_verify_kernel_layer(
        tbp["mix"], cfg, t(x), tcache["kv"], tcache["cmp"], torch.tensor(100), t(pos), t(tm),
        C=C, mode=mode, reuse=False)
    np.testing.assert_array_equal(np.asarray(si), tsi.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **LAYER_TOL)
    out_r, _, _ = ops.nsa_verify_kernel_layer(
        tbp["mix"], cfg, t(x), tcache["kv"], tcache["cmp"], torch.tensor(100), t(pos), t(tm),
        sel_idx=tsi, sel_valid=tsv, C=C, mode=mode, reuse=True)
    jk, _, _ = jax_layer(bp["mix"], jcfg, jx, cache["kv"], cache["cmp"], 100, jpos, jtm,
                         sel_idx=si, sel_valid=sv, C=C, mode=mode, reuse=True)
    np.testing.assert_allclose(out_r.numpy(), np.asarray(jk), **LAYER_TOL)


@pytest.fixture(scope="module")
def pair_8b():
    jc, tc = jconfigs.reduced("ssv-nsa-8b", d_model=512), configs.reduced("ssv-nsa-8b", d_model=512)
    jd, td = jdraft.draft_config(jc, num_layers=1), draft.draft_config(tc, num_layers=1)
    jtp, jdp = init(jax.random.PRNGKey(0), jc), init(jax.random.PRNGKey(1), jd)
    ttp = from_jax(jax.tree.map(np.asarray, jtp), tc, "cpu")
    tdp = from_jax(jax.tree.map(np.asarray, jdp), td, "cpu")
    prompt = np.random.default_rng(0).integers(0, tc.vocab_size, 130)
    return jc, tc, jd, td, jtp, jdp, ttp, tdp, prompt


@pytest.mark.parametrize("pc", ["Strict", "Approx+Reuse"])
def test_generate_8b_token_equal_to_jax(pair_8b, pc):
    jc, tc, jd, td, jtp, jdp, ttp, tdp, prompt = pair_8b
    mode, reuse = planner.class_constraints(pc)
    kw = dict(tree_depth=3, tree_width=2, group_size=4 if mode == "approx" else 2,
              group_mode=mode, precision_class=pc,
              refresh_schedule=planner.default_schedule(tc.num_layers) if reuse else ())
    jeng = jengine.SSVEngine(jtp, jc, jdp, jd, JServe(
        max_new_tokens=8, max_context=256, ssv=JSSV(**kw), use_planner=False))
    teng = engine.SSVEngine(ttp, tc, tdp, td, ServeConfig(
        max_new_tokens=8, max_context=256, ssv=SSVConfig(**kw)), device="cpu")
    jr, tr = jeng.generate(prompt, 8), teng.generate(prompt, 8)
    assert len(tr.tokens) == 8
    np.testing.assert_array_equal(jr.tokens, tr.tokens)
    assert [s.accepted for s in jr.steps] == [s.accepted for s in tr.steps]


def test_serve_cli_8b_on_cpu(capsys):
    serve.main(["--arch", "ssv-nsa-8b", "--reduced", "--device", "cpu", "--prompts", "1",
                "--tokens", "3", "--prompt-len", "40"])
    assert "prompt 0: 3 tokens" in capsys.readouterr().out
