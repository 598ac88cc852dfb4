"""Parity of the port's fused NSA-verify wrapper (its plain version on the
CPU) with the JAX package: ``nsa_verify_fused`` against the JAX
``nsa_verify_fused`` in interpret mode (``ref_verify_batched`` is held in
test_torch_nsa_verify_ref.py), for C in {1, 2, 4}, exact and approx grouping, full fusion and partial
fusion with ``o_cmp_in``, at Gq > 1."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import NSAConfig as JNSAConfig
from repro.kernels.nsa_verify import ops as jops
from repro_torch.config import NSAConfig
from repro_torch.kernels.nsa_verify import ops

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

NSA_KW = dict(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4, window=32)
NSA, JNSA = NSAConfig(**NSA_KW), JNSAConfig(**NSA_KW)


def make_inputs(rng, B, T, Hq, Hkv, Dh, S, prefix):
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    ncb = (S - 8) // 4 + 1
    sel = np.sort(rng.integers(0, max(prefix // 16, 1), (B, T, Hkv, 4)), axis=-1)
    depths = np.minimum(np.arange(T), 3)
    return dict(q=r(B, T, Hq, Dh) / np.sqrt(Dh), k_cache=r(B, S, Hkv, Dh),
                v_cache=r(B, S, Hkv, Dh), k_cmp=r(B, ncb, Hkv, Dh),
                v_cmp=r(B, ncb, Hkv, Dh), k_draft=r(B, T, Hkv, Dh),
                v_draft=r(B, T, Hkv, Dh), sel_idx=sel.astype(np.int32),
                sel_valid=rng.random((B, T, Hkv, 4)) < 0.9,
                positions=np.repeat((prefix + depths)[None], B, 0).astype(np.int32),
                prefix_len=prefix, ncb_valid=max(0, (prefix - 8) // 4 + 1),
                tree_mask=np.repeat(np.tril(np.ones((T, T), bool))[None], B, 0),
                gates=(1 / (1 + np.exp(-r(B, T, 3, Hq)))).astype(np.float32))


ORDER = ("q", "k_cache", "v_cache", "k_cmp", "v_cmp", "k_draft", "v_draft", "sel_idx",
         "sel_valid", "positions", "prefix_len", "ncb_valid", "tree_mask", "gates")


# C in {1, 2, 4}, exact and approx, with and without o_cmp_in (partial vs
# full fusion); each JAX interpret-mode call compiles anew, so the sweep is a
# covering set rather than the full product
CASES = [(1, "exact", False), (1, "exact", True), (2, "exact", True),
         (4, "exact", False), (2, "approx", False), (4, "approx", True)]


def run_both(shape, C, mode, with_cmp_in, seed):
    B, T, Hq, Hkv, Dh, S, prefix = shape
    rng = np.random.default_rng(seed)
    inp = make_inputs(rng, B, T, Hq, Hkv, Dh, S, prefix)
    o_cmp = rng.normal(size=(B, T, Hq, Dh)).astype(np.float32) if with_cmp_in else None
    jargs = [jnp.asarray(inp[k]) if isinstance(inp[k], np.ndarray) else inp[k] for k in ORDER]
    targs = [torch.from_numpy(inp[k]) if isinstance(inp[k], np.ndarray) else inp[k]
             for k in ORDER]
    out_t = ops.nsa_verify_fused(*targs, NSA, C=C, mode=mode, include_cmp=not with_cmp_in,
                                 o_cmp_in=None if o_cmp is None else torch.from_numpy(o_cmp))
    return inp, jargs, o_cmp, out_t.numpy()


@pytest.mark.parametrize("C,mode,with_cmp_in", CASES)
def test_fused_matches_jax_interpret_kernel(C, mode, with_cmp_in):
    inp, jargs, o_cmp, out_t = run_both((1, 7, 4, 2, 32, 128, 100), C, mode, with_cmp_in,
                                        seed=C)
    out_k = jops.nsa_verify_fused(*jargs, JNSA, C=C, mode=mode, include_cmp=not with_cmp_in,
                                  o_cmp_in=None if o_cmp is None else jnp.asarray(o_cmp))
    np.testing.assert_allclose(out_t, np.asarray(out_k), rtol=2e-4, atol=2e-5)
