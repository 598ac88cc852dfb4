"""The port's flash tree-verify path against the JAX package: the plain
version (what ``kernels.flash.ops.flash_verify`` runs for CPU tensors) is
held against the JAX oracle ``ref_flash_verify`` and the JAX kernel in
interpret mode on the sweep of ``tests/test_kernels_flash.py`` plus a head
dim 128 case, with per-row prefix lengths against JAX row by row (float32:
rtol=2e-4, atol=2e-5; bfloat16 inputs: 3e-2, as the JAX package's own bf16
flash test). ``attend_verify`` (now flash on ``q / sqrt(Dh)``) matches the
JAX ``attend_verify`` on engine-shaped trees, and greedy generation with a
dense-verification target (``attention="dense"``) is token-equal to the
JAX engine on bridged weights. The kernel's merge tickets are kept per
stream."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import ServeConfig as JServe, SSVConfig as JSSV
from repro.core import draft as jdraft, engine as jengine
from repro.core.tree import build_topology as jbuild_topology
from repro.kernels.flash import ops as jfops, ref as jfref
from repro.models import attention as jattn, model as jmodel
from repro_torch import configs
from repro_torch.bridge import from_jax
from repro_torch.config import ServeConfig, SSVConfig
from repro_torch.core import draft, engine
from repro_torch.core.tree import build_topology
from repro_torch.kernels.flash import ops as fops
from repro_torch.models import attention

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
jax_ref = jax.jit(jfref.ref_flash_verify, static_argnames=("window",))


def inputs(B, T, Hq, Hkv, Dh, S, prefix, seed=0):
    """numpy inputs as tests/test_kernels_flash.py draws them; ``prefix`` is
    an int or one length per row."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.normal(size=shape).astype(np.float32)
    q = r(B, T, Hq, Dh) / np.sqrt(Dh)
    kc, vc, kd, vd = r(B, S, Hkv, Dh), r(B, S, Hkv, Dh), r(B, T, Hkv, Dh), r(B, T, Hkv, Dh)
    plen = np.broadcast_to(np.asarray(prefix, np.int32), (B,)).copy()
    depths = np.minimum(np.arange(T), 3)
    positions = (plen[:, None] + depths[None]).astype(np.int32)
    tm = np.broadcast_to(np.tril(np.ones((T, T), bool)), (B, T, T)).copy()
    return q, kc, vc, kd, vd, positions, plen, tm


def port(q, kc, vc, kd, vd, positions, prefix, tm, window, dtype=torch.float32):
    t = lambda a, dt=None: torch.from_numpy(np.array(a)).to(dt) if dt else torch.from_numpy(np.array(a))
    return fops.flash_verify(t(q), t(kc, dtype), t(vc, dtype), t(kd, dtype), t(vd, dtype),
                             t(positions), prefix, t(tm), window).numpy()


SWEEP = [(1, 4, 2, 1, 16, 64, 48, 0),
         (2, 6, 4, 2, 32, 96, 80, 0),
         (1, 5, 6, 3, 16, 64, 50, 24),
         (2, 8, 8, 8, 64, 160, 130, 0),
         (1, 7, 4, 4, 32, 144, 10, 16),     # tiny prefix
         (1, 6, 8, 2, 128, 96, 70, 16)]     # head dim 128


@pytest.mark.parametrize("B,T,Hq,Hkv,Dh,S,prefix,window", SWEEP)
def test_plain_flash_matches_jax_ref_and_interpret_kernel(B, T, Hq, Hkv, Dh, S, prefix, window):
    q, kc, vc, kd, vd, pos, _, tm = inputs(B, T, Hq, Hkv, Dh, S, prefix)
    got = port(q, kc, vc, kd, vd, pos, prefix, tm, window)
    j = [jnp.asarray(a) for a in (q, kc, vc, kd, vd, pos)]
    want_ref = jax_ref(*j, prefix, jnp.asarray(tm), window=window)
    want_kernel = jfops.flash_verify(*j, prefix, jnp.asarray(tm), window)
    np.testing.assert_allclose(got, np.asarray(want_ref), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **F32_TOL)


def test_plain_flash_bf16_inputs():
    q, kc, vc, kd, vd, pos, _, tm = inputs(1, 4, 4, 2, 32, 96, 80)
    got = port(q, kc, vc, kd, vd, pos, 80, tm, 0, dtype=torch.bfloat16)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = jfops.flash_verify(jnp.asarray(q), bf(kc), bf(vc), bf(kd), bf(vd),
                              jnp.asarray(pos), 80, jnp.asarray(tm), 0)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("Dh,window", [(64, 0), (128, 24)])
def test_per_row_prefix_lengths_match_jax_row_by_row(Dh, window):
    """One call with prefix lengths (90, 37): each row equals the JAX
    oracle run on that row alone with its scalar prefix_len."""
    prefix = np.array([90, 37], np.int32)
    q, kc, vc, kd, vd, pos, plen, tm = inputs(2, 7, 8, 4, Dh, 128, prefix, seed=3)
    got = port(q, kc, vc, kd, vd, pos, torch.from_numpy(plen), tm, window)
    for b in range(2):
        row = [jnp.asarray(a[b:b + 1]) for a in (q, kc, vc, kd, vd, pos)]
        want = jax_ref(*row, int(plen[b]), jnp.asarray(tm[b:b + 1]), window=window)
        np.testing.assert_allclose(got[b:b + 1], np.asarray(want), **F32_TOL)


def test_row_that_sees_nothing_is_zero():
    q, kc, vc, kd, vd, pos, _, tm = inputs(1, 3, 2, 1, 16, 32, 0)
    tm[:] = False
    got = port(q, kc, vc, kd, vd, pos, 0, tm, 0)
    assert np.all(got == 0.0)


def test_kernel_draft_mask_layout():
    """Row t*Gq + g of the kernel's draft mask is query t's mask (the JAX
    ``jnp.repeat`` layout), with pos_i >= pos_j and the window applied."""
    topo = build_topology(3, 2, "dfs")
    pos = torch.from_numpy((40 + topo.depths)[None].astype(np.int32))
    tm = torch.from_numpy(topo.mask)[None]
    dm = fops.draft_mask(tm, pos, Gq=3, window=2)
    assert dm.shape == (1, topo.num_nodes * 3, topo.num_nodes) and dm.dtype == torch.int32
    dist = pos[:, :, None] - pos[:, None, :]
    want = (tm & (dist >= 0) & (dist < 2)).repeat_interleave(3, dim=1)
    assert torch.equal(dm.bool(), want)


def test_merge_tickets_are_kept_per_stream():
    """Each stream gets its own ticket buffer (zeroed, at least the size
    asked for); a stream reuses its own, and a larger request grows it."""
    dev = torch.device("cpu")
    a = fops._ticket_buffer(8, dev, stream=1)
    assert a.dtype == torch.int32 and a.numel() >= 8 and not a.any()
    assert fops._ticket_buffer(8, dev, stream=1) is a
    b = fops._ticket_buffer(8, dev, stream=2)
    assert b is not a and b.data_ptr() != a.data_ptr()
    big = fops._ticket_buffer(a.numel() + 1, dev, stream=1)
    assert big.numel() > a.numel() and fops._ticket_buffer(8, dev, stream=2) is b


@pytest.fixture(scope="module")
def dense_block():
    jc = dataclasses.replace(jconfigs.reduced("ssv-nsa-1b", layers=1), attention="dense",
                             num_kv_heads=2)
    tc = dataclasses.replace(configs.reduced("ssv-nsa-1b", layers=1), attention="dense",
                             num_kv_heads=2)
    jp = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(5), jc)
    tp = from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    jbp = jax.tree.map(lambda a: a[0], jp["segments"][0][0])
    return jc, tc, jbp, tp["layers"][0]


@pytest.mark.parametrize("depth,order", [(2, "bfs"), (2, "dfs"), (3, "bfs"), (3, "dfs")])
def test_attend_verify_matches_jax_on_engine_trees(dense_block, depth, order):
    jc, tc, jbp, bp = dense_block
    topo = jbuild_topology(depth, 2, order)
    T, S, P = topo.num_nodes, 96, 70
    rng = np.random.default_rng(depth)
    shape = (1, S, tc.num_kv_heads, tc.head_dim)
    cache = {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32)}
    cache["k"][:, :P] = rng.normal(size=(1, P) + shape[2:])
    cache["v"][:, :P] = rng.normal(size=(1, P) + shape[2:])
    x = rng.normal(size=(1, T, tc.d_model)).astype(np.float32)
    pos = (P + topo.depths)[None].astype(np.int32)
    tm = topo.mask[None]
    jout, (jk, _) = jax.jit(jattn.attend_verify, static_argnums=1)(jbp["mix"], jc, jnp.asarray(x),
                                        jax.tree.map(jnp.asarray, cache), jnp.int32(P),
                                        jnp.asarray(pos), jnp.asarray(tm))
    t = lambda a: torch.from_numpy(np.array(a))
    tout, (tk, _) = attention.attend_verify(bp["mix"], tc, t(x), {k: t(v) for k, v in cache.items()},
                                            torch.tensor(P), t(pos), t(tm))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32_TOL)


def test_dense_target_generate_token_equal_to_jax():
    """The dense-verification baseline: the ``attention="dense"`` replacement
    of reduced ssv-nsa-1b as the target, every verify through flash."""
    jc = dataclasses.replace(jconfigs.reduced("ssv-nsa-1b"), attention="dense")
    tc = dataclasses.replace(configs.reduced("ssv-nsa-1b"), attention="dense")
    jd, td = jdraft.draft_config(jc, num_layers=1), draft.draft_config(tc, num_layers=1)
    init = jax.jit(jmodel.init, static_argnums=1)
    jtp, jdp = init(jax.random.PRNGKey(0), jc), init(jax.random.PRNGKey(1), jd)
    ttp = from_jax(jax.tree.map(np.asarray, jtp), tc, "cpu")
    tdp = from_jax(jax.tree.map(np.asarray, jdp), td, "cpu")
    prompt = np.random.default_rng(0).integers(0, tc.vocab_size, 60)
    kw = dict(tree_depth=3, tree_width=2, precision_class="Strict")
    jeng = jengine.SSVEngine(jtp, jc, jdp, jd, JServe(
        max_new_tokens=12, max_context=160, ssv=JSSV(**kw), use_planner=False))
    teng = engine.SSVEngine(ttp, tc, tdp, td, ServeConfig(
        max_new_tokens=12, max_context=160, ssv=SSVConfig(**kw)), device="cpu")
    jr, tr = jeng.generate(prompt, 12), teng.generate(prompt, 12)
    assert len(tr.tokens) == 12
    np.testing.assert_array_equal(jr.tokens, tr.tokens)
    assert [s.accepted for s in jr.steps] == [s.accepted for s in tr.steps]
