"""Parity of the PyTorch port's layers, dense attention, KV views and NSA
pieces with the JAX package: the same numpy inputs go through both, and
float32 results agree within rtol=2e-4, atol=2e-5. Selected block indices
must be exactly equal, including on constructed ties."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig, NSAConfig as JNSAConfig
from repro.core import kvstore as jkv
from repro.models import attention as jattn, layers as jlayers, model as jmodel
from repro.models import nsa as jnsa
from repro_torch.bridge import from_jax
from repro_torch.config import ModelConfig, NSAConfig
from repro_torch.core import kvstore
from repro_torch.models import attention, layers, nsa

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
NSA_KW = dict(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4, window=32)
CFG_KW = dict(name="t", num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
              d_ff=256, vocab_size=97, dtype="float32", attention="nsa",
              max_seq_len=512)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def model_pair():
    jcfg = JModelConfig(**CFG_KW, nsa=JNSAConfig(**NSA_KW))
    cfg = ModelConfig(**CFG_KW, nsa=NSAConfig(**NSA_KW))
    jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tp = from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jbp = jax.tree.map(lambda a: a[0], jp["segments"][0][0])
    return jcfg, cfg, jp, tp, jbp, tp["layers"][0]


def test_rmsnorm_rope_ffn(model_pair):
    jcfg, cfg, jp, tp, jbp, bp = model_pair
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    close(jlayers.rmsnorm(jbp["norm1"], jnp.asarray(x)), layers.rmsnorm(bp["norm1"], t(x)))
    close(jlayers.ffn(jbp["ffn"], jnp.asarray(x), "swiglu"), layers.ffn(bp["ffn"], t(x), "swiglu"))
    qh = rng.normal(size=(2, 5, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    close(jlayers.apply_rope(jnp.asarray(qh), jnp.asarray(pos)),
          layers.apply_rope(t(qh), t(pos)))
    toks = rng.integers(0, cfg.vocab_size, (2, 5))
    close(jlayers.embed(jp["embed"], jnp.asarray(toks)), layers.embed(tp["embed"], t(toks)))


def test_bridge_unstacks_layers(model_pair):
    jcfg, cfg, jp, tp, jbp, bp = model_pair
    assert len(tp["layers"]) == cfg.num_layers
    for li in range(cfg.num_layers):
        for k in ("wq", "wo", "w_gate", "phi_k"):
            close(jp["segments"][0][0]["mix"][k][li], tp["layers"][li]["mix"][k])


def test_qkv_attend_train_and_verify(model_pair):
    jcfg, cfg, jp, tp, jbp, bp = model_pair
    dcfg = dataclasses.replace(cfg, attention="dense")
    jdcfg = dataclasses.replace(jcfg, attention="dense")
    rng = np.random.default_rng(1)
    S, T = 64, 5
    x = rng.normal(size=(1, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    for a, b in zip(jattn.qkv(jbp["mix"], jcfg, jnp.asarray(x), jnp.asarray(pos)),
                    attention.qkv(bp["mix"], cfg, t(x), t(pos))):
        close(a, b)
    jo, (jk, jv) = jattn.attend_train(jbp["mix"], jdcfg, jnp.asarray(x), jnp.asarray(pos),
                                      chunk=32)
    to, (tk, tv) = attention.attend_train(bp["mix"], dcfg, t(x), t(pos), chunk=32)
    close(jo, to)
    cache_np = {"k": np.zeros((1, 96, 2, 64), np.float32), "v": np.zeros((1, 96, 2, 64), np.float32)}
    cache_np["k"][:, :S], cache_np["v"][:, :S] = np.asarray(jk), np.asarray(jv)
    xd = rng.normal(size=(1, T, cfg.d_model)).astype(np.float32)
    dpos = (S + np.array([0, 1, 1, 2, 2], np.int32))[None]
    tm = np.tril(np.ones((T, T), bool))[None]
    jout, _ = jattn.attend_verify(jbp["mix"], jdcfg, jnp.asarray(xd),
                                  jax.tree.map(jnp.asarray, cache_np), jnp.int32(S),
                                  jnp.asarray(dpos), jnp.asarray(tm))
    tout, _ = attention.attend_verify(bp["mix"], dcfg, t(xd),
                                      {k: t(v) for k, v in cache_np.items()},
                                      torch.tensor(S), t(dpos), t(tm))
    close(jout, tout)


def test_kv_view_reads_and_zero_fill():
    rng = np.random.default_rng(2)
    k = rng.normal(size=(2, 64, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 8)).astype(np.float32)
    jv_, tv_ = jkv.KVView(jnp.asarray(k), jnp.asarray(v)), kvstore.KVView(t(k), t(v))
    idx = np.array([[[[0, 3], [-1, 9]]], [[[2, 1], [4, 100]]]], np.int32)   # (2,1,2,2)
    for a, b in zip(jv_.gather_blocks(jnp.asarray(idx), 16), tv_.gather_blocks(t(idx), 16)):
        close(a, b)
    tok = np.array([[-3, 0, 63, 64], [5, 70, 1, 2]], np.int32)
    for a, b in zip(jv_.gather_tokens(jnp.asarray(tok)), tv_.gather_tokens(t(tok))):
        close(a, b)
    for a, b in zip(jv_.window(jnp.int32(20), 32), tv_.window(torch.tensor(20), 32)):
        close(a, b)
    kn = rng.normal(size=(2, 3, 2, 8)).astype(np.float32)
    ja = jv_.write(jnp.asarray(kn), jnp.asarray(kn), jnp.int32(10))
    tb = tv_.write(t(kn), t(kn), torch.tensor(10))
    close(ja[0], tb[0])


def test_compression_and_cmp_update(model_pair):
    jcfg, cfg, jp, tp, jbp, bp = model_pair
    rng = np.random.default_rng(3)
    k = rng.normal(size=(1, 96, 2, 64)).astype(np.float32)
    v = rng.normal(size=(1, 96, 2, 64)).astype(np.float32)
    for a, b in zip(jnsa.compress_kv(jbp["mix"], jnp.asarray(k), jnp.asarray(v), jcfg.nsa),
                    nsa.compress_kv(bp["mix"], t(k), t(v), cfg.nsa)):
        close(a, b)
    jc = jnsa.init_cmp_cache(jcfg, 1, 96)
    tc = nsa.init_cmp_cache(cfg, 1, 96, torch.float32, "cpu")
    assert tuple(jc["k_cmp"].shape) == tuple(tc["k_cmp"].shape)
    assert nsa.init_cmp_cache(cfg, 1, 8192, torch.float32, "cpu")["k_cmp"].shape[1] == \
        jnsa.init_cmp_cache(jcfg, 1, 8192)["k_cmp"].shape[1]          # pad to 512
    ju = jnsa.update_cmp_cache_dyn(jbp["mix"], {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                   jc, jnp.int32(40), jnp.int32(47), 3, jcfg.nsa)
    tu = nsa.update_cmp_cache_dyn(bp["mix"], {"k": t(k), "v": t(v)}, tc,
                                  torch.tensor(40), torch.tensor(47), 3, cfg.nsa)
    close(ju["k_cmp"], tu["k_cmp"])
    close(ju["v_cmp"], tu["v_cmp"])
    assert int(nsa.dyn_num_cmp_blocks(torch.tensor(47), cfg.nsa)) == \
        int(jnsa.dyn_num_cmp_blocks(jnp.int32(47), jcfg.nsa)) == nsa.num_cmp_blocks(47, cfg.nsa)


@pytest.mark.parametrize("prefix", [40, 100, 150])
def test_routing_select_topn_gates(model_pair, prefix):
    jcfg, cfg, jp, tp, jbp, bp = model_pair
    rng = np.random.default_rng(prefix)
    T, S = 6, 160
    ncb = nsa.num_cmp_blocks(S, cfg.nsa)
    q = rng.normal(size=(1, T, 4, 64)).astype(np.float32)
    kc = rng.normal(size=(1, ncb, 2, 64)).astype(np.float32)
    vc = rng.normal(size=(1, ncb, 2, 64)).astype(np.float32)
    pos = (prefix + np.array([0, 1, 1, 2, 2, 3], np.int32))[None]
    nv = nsa.num_cmp_blocks(prefix, cfg.nsa)
    jo, jps = jnsa.routing(jbp["mix"], jcfg, jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                           jnp.asarray(pos), S, ncb_valid=nv)
    to, tps = nsa.routing(bp["mix"], cfg, t(q), t(kc), t(vc), t(pos), S,
                          ncb_valid=torch.tensor(nv))
    close(jo, to)
    close(jps, tps)
    # select on the JAX scores so the comparison is of selection alone
    ji, jvld = jnsa.select_topn(jps, jnp.asarray(pos), prefix, jcfg.nsa)
    ti, tvld = nsa.select_topn(t(np.asarray(jps)), t(pos), torch.tensor(prefix), cfg.nsa)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jvld), tvld.numpy())
    x = rng.normal(size=(1, T, cfg.d_model)).astype(np.float32)
    close(jnsa.gates(jbp["mix"], jnp.asarray(x), 4), nsa.gates(bp["mix"], t(x), 4))


@pytest.mark.parametrize("kind", ["zeros", "plateau", "mandatory"])
def test_select_topn_ties_match_jax(kind):
    """Ties pick the lower block index first, exactly as jax.lax.top_k."""
    cfg = NSAConfig(**NSA_KW)
    jcfg = JNSAConfig(**NSA_KW)
    B, T, H, NSB = 1, 3, 2, 12
    rng = np.random.default_rng(5)
    if kind == "zeros":          # uncovered causal blocks all score 0
        p = np.zeros((B, T, H, NSB), np.float32)
    elif kind == "plateau":      # equal scores among many blocks
        p = np.repeat(rng.integers(0, 3, (B, T, H, NSB)).astype(np.float32) / 4, 1, axis=-1)
    else:                        # +1e6 bump rounds small gaps away in f32
        p = (rng.random((B, T, H, NSB)) * 1e-3).astype(np.float32)
    pos = np.array([[150, 151, 152]], np.int32)
    ji, jv = jnsa.select_topn(jnp.asarray(p), jnp.asarray(pos), 150, jcfg)
    ti, tv = nsa.select_topn(t(p), t(pos), torch.tensor(150), cfg)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_prefill_nsa_and_verify_ref(model_pair):
    jcfg, cfg, jp, tp, jbp, bp = model_pair
    rng = np.random.default_rng(6)
    S, T = 100, 5
    x = rng.normal(size=(1, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    jo, (jk, jv) = jnsa.attend_train_nsa(jbp["mix"], jcfg, jnp.asarray(x), jnp.asarray(pos))
    to, (tk, tv) = nsa.attend_train_nsa(bp["mix"], cfg, t(x), t(pos))
    close(jo, to)
    toks = rng.integers(0, cfg.vocab_size, (1, S))
    _, jc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), 160)
    jcache = jax.tree.map(lambda a: a[0], jc["segments"][0][0])
    tcache = {"kv": {k: t(np.asarray(v)) for k, v in jcache["kv"].items()},
              "cmp": {k: t(np.asarray(v)) for k, v in jcache["cmp"].items()}}
    xd = rng.normal(size=(1, T, cfg.d_model)).astype(np.float32)
    dpos = (S + np.array([0, 1, 1, 2, 2], np.int32))[None]
    tm = np.array([[1, 0, 0, 0, 0], [1, 1, 0, 0, 0], [1, 0, 1, 0, 0],
                   [1, 1, 0, 1, 0], [1, 0, 1, 0, 1]], bool)[None]
    jout, _, (jsi, jsv) = jnsa.nsa_verify_ref(jbp["mix"], jcfg, jnp.asarray(xd), jcache["kv"],
                                              jcache["cmp"], S, jnp.asarray(dpos), jnp.asarray(tm))
    tout, _, (tsi, tsv) = nsa.nsa_verify_ref(bp["mix"], cfg, t(xd), tcache["kv"], tcache["cmp"],
                                             torch.tensor(S), t(dpos), t(tm))
    close(jout, tout)
    np.testing.assert_array_equal(np.asarray(jsi), tsi.numpy())
    np.testing.assert_array_equal(np.asarray(jsv), tsv.numpy())
