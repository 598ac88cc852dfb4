"""Parity of the port's routing kernel wrapper (its plain version on the
CPU) and grouping layouts with the JAX package: ``routing_fused`` against
the JAX ``routing_fused`` in interpret mode and ``ref_routing``; merged
schedules, ownership and shared indices exactly equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import NSAConfig as JNSAConfig
from repro.core import overlap as joverlap
from repro.kernels.nsa_verify import ops as jvops
from repro.kernels.routing import ops as jrops, ref as jrref
from repro.models.nsa import overlap_matrix
from repro_torch.config import NSAConfig
from repro_torch.core import overlap
from repro_torch.kernels.nsa_verify import ops as vops
from repro_torch.kernels.routing import ops as rops
from repro_torch.models.nsa import num_cmp_blocks, num_sel_blocks

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

NSA_KW = dict(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4, window=32)
NSA, JNSA = NSAConfig(**NSA_KW), JNSAConfig(**NSA_KW)


@pytest.mark.parametrize("B,T,Hq,Hkv,Dh,S,prefix", [
    (1, 4, 2, 1, 16, 96, 80),
    (2, 6, 4, 2, 32, 128, 100),
    (1, 8, 8, 2, 64, 160, 33),
])
def test_routing_matches_jax_kernel_and_ref(B, T, Hq, Hkv, Dh, S, prefix):
    rng = np.random.default_rng(B + T + Hq)
    NCB, NSB = num_cmp_blocks(S, NSA), num_sel_blocks(S, NSA)
    nv = num_cmp_blocks(prefix, NSA)
    q = (rng.normal(size=(B, T, Hq, Dh)) / np.sqrt(Dh)).astype(np.float32)
    kc = rng.normal(size=(B, NCB, Hkv, Dh)).astype(np.float32)
    vc = rng.normal(size=(B, NCB, Hkv, Dh)).astype(np.float32)
    pos = np.repeat((prefix + np.minimum(np.arange(T), 3))[None], B, 0).astype(np.int32)
    before = rops.LAUNCHES.count
    o_t, p_t = rops.routing_fused(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), torch.from_numpy(pos),
                                  torch.tensor(nv), NSA, kv_len=S)
    assert rops.LAUNCHES.count == before     # CPU tensors never launch the kernel
    o_k, p_k = jrops.routing_fused(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(pos), nv, JNSA, kv_len=S)
    M = jnp.asarray(overlap_matrix(NCB, NSB, 8, 4, 16))
    o_r, p_r = jrref.ref_routing(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), M,
                                 jnp.asarray(pos), nv, cmp_block=8, cmp_stride=4)
    for want_o, want_p in ((o_k, p_k), (o_r, p_r)):
        np.testing.assert_allclose(o_t.numpy(), np.asarray(want_o), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(want_p), rtol=2e-4, atol=2e-5)


def _sel(rng, B, T, H, n, nsb, p_invalid=0.1):
    idx = np.sort(np.stack([[[rng.choice(nsb, n, replace=False) for _ in range(H)]
                             for _ in range(T)] for _ in range(B)]), axis=-1)
    return idx.astype(np.int32), rng.random((B, T, H, n)) > p_invalid


@pytest.mark.parametrize("T,C", [(5, 1), (6, 2), (7, 2), (7, 4), (31, 4)])
def test_merged_schedule_and_shared_index_exact(T, C):
    rng = np.random.default_rng(T * 10 + C)
    idx, val = _sel(rng, 2, T, 3, 4, 12)
    pos = np.repeat((100 + np.minimum(np.arange(T), 4))[None], 2, 0).astype(np.int32)
    jm, jo, jv = joverlap.merged_schedule(jnp.asarray(idx), jnp.asarray(val), C)
    tm, to, tv = overlap.merged_schedule(torch.from_numpy(idx), torch.from_numpy(val), C)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    ji, jvv = joverlap.shared_index(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(pos), C)
    ti, tvv = overlap.shared_index(torch.from_numpy(idx), torch.from_numpy(val),
                                   torch.from_numpy(pos), C)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jvv), tvv.numpy())


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_prepare_groups_layouts_match_jax(mode):
    rng = np.random.default_rng(3)
    B, T, Hq, Hkv, Dh, C = 1, 7, 4, 2, 8, 2
    idx, val = _sel(rng, B, T, Hkv, 4, 10)
    q = rng.normal(size=(B, T, Hq, Dh)).astype(np.float32)
    gates = rng.random((B, T, 3, Hq)).astype(np.float32)
    pos = (50 + np.minimum(np.arange(T), 3))[None].astype(np.int32)
    j = jvops.prepare_groups(jnp.asarray(q), jnp.asarray(gates), jnp.asarray(idx),
                             jnp.asarray(val), jnp.asarray(pos), C, mode, 4)
    t = vops.prepare_groups(torch.from_numpy(q), torch.from_numpy(gates),
                            torch.from_numpy(idx), torch.from_numpy(val),
                            torch.from_numpy(pos), C, mode)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
