"""The port's kernel-backed NSA layer (plain versions on the CPU) against
the JAX package: refresh layers give exactly the JAX model path's selected
indices (after the shared index in approx mode) and its output; reuse
layers on the carried indices match the JAX kernel layer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig, NSAConfig as JNSAConfig
from repro.kernels.nsa_verify import ops as jops
from repro.models import model as jmodel, nsa as jnsa
from repro_torch.bridge import from_jax
from repro_torch.config import ModelConfig, NSAConfig
from repro_torch.kernels.nsa_verify import ops

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

NSA_KW = dict(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4, window=32)
NSA, JNSA = NSAConfig(**NSA_KW), JNSAConfig(**NSA_KW)


@pytest.fixture(scope="module")
def nsa_layer():
    kw = dict(name="t", num_layers=1, d_model=256, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=97, dtype="float32", attention="nsa")
    jcfg, cfg = JModelConfig(**kw, nsa=JNSA), ModelConfig(**kw, nsa=NSA)
    key = jax.random.PRNGKey(0)
    p = jmodel.init(key, jcfg)
    bp = jax.tree.map(lambda a: a[0], p["segments"][0][0])
    tbp = from_jax(jax.tree.map(np.asarray, p), cfg, "cpu")["layers"][0]
    toks = jax.random.randint(key, (1, 100), 0, 97)
    _, caches = jmodel.prefill(p, jcfg, toks, max_len=160)
    cache = jax.tree.map(lambda a: a[0], caches["segments"][0][0])
    tcache = {g: {k: torch.from_numpy(np.array(v)) for k, v in cache[g].items()}
              for g in ("kv", "cmp")}
    return jcfg, cfg, bp, tbp, cache, tcache


def _tree(prefix, T=5):
    parents, depths = [-1, 0, 0, 1, 2], [0, 1, 1, 2, 2]
    tm = np.zeros((T, T), bool)
    for i in range(T):
        j = i
        while j >= 0:
            tm[i, j] = True
            j = parents[j]
    return (prefix + np.asarray(depths, np.int32))[None], tm[None]


@pytest.mark.parametrize("C,mode", [(2, "exact"), (2, "approx"), (4, "approx")])
def test_kernel_layer_matches_jax(nsa_layer, C, mode):
    jcfg, cfg, bp, tbp, cache, tcache = nsa_layer
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(C), (1, 5, 256)))
    pos, tm = _tree(100)
    jx, jpos, jtm = jnp.asarray(x), jnp.asarray(pos), jnp.asarray(tm)
    tx, tpos, ttm = (torch.from_numpy(np.array(a)) for a in (x, pos, tm))
    # refresh layer: JAX model path (shared index in approx mode) and kernel layer
    ref_out, _, (si, sv) = jnsa.nsa_verify_ref(bp["mix"], jcfg, jx, cache["kv"], cache["cmp"],
                                               100, jpos, jtm)
    if mode == "approx":
        from repro.core.overlap import shared_index
        si, sv = shared_index(si, sv, jpos, C)
        ref_out = jnsa.nsa_verify_ref(bp["mix"], jcfg, jx, cache["kv"], cache["cmp"], 100,
                                      jpos, jtm, sel_idx=si, sel_valid=sv)[0]
    out, _, (tsi, tsv) = ops.nsa_verify_kernel_layer(
        tbp["mix"], cfg, tx, tcache["kv"], tcache["cmp"], torch.tensor(100), tpos, ttm,
        C=C, mode=mode, reuse=False)
    np.testing.assert_array_equal(np.asarray(si), tsi.numpy())
    np.testing.assert_array_equal(np.asarray(sv), tsv.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-4, atol=1e-5)
    # reuse layer on the carried indices
    out_r, _, _ = ops.nsa_verify_kernel_layer(
        tbp["mix"], cfg, tx, tcache["kv"], tcache["cmp"], torch.tensor(100), tpos, ttm,
        sel_idx=tsi, sel_valid=tsv, C=C, mode=mode, reuse=True)
    jk, _, _ = jops.nsa_verify_kernel_layer(bp["mix"], jcfg, jx, cache["kv"], cache["cmp"],
                                            100, jpos, jtm, sel_idx=si, sel_valid=sv, C=C,
                                            mode=mode, reuse=True)
    np.testing.assert_allclose(out_r.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-5)
