"""The port's paged NSA verify (the plain version of the paged kernel mode,
``kernels.nsa_verify.ops.nsa_verify_fused(page_table=...)`` on CPU
tensors) against the JAX ``nsa_verify_fused(page_table=...)`` Pallas
kernel in interpret mode, on the same numpy inputs: the dense cache
re-homed into a shuffled pool with spare pages (page size = 1 and 2 x
sel_block), exact C=1/2 and approx C=2/4, full and partial fusion, head
dims 64 and 128, a hole outside the window (a page whose selected blocks
are masked, never clamped) and a hole inside the window (its zeros pass the
position mask). Tolerance rtol 2e-5 / atol 2e-6, as the JAX paged test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import NSAConfig as JNSA
from repro.kernels.nsa_verify import ops as jops
from repro_torch.config import NSAConfig
from repro_torch.kernels.nsa_verify import ops

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

NSA = NSAConfig(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4, window=32)
JNSA_ = JNSA(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4, window=32)
B, T, Hq, Hkv, S, PREFIX = 2, 6, 4, 2, 128, 100


def _inputs(seed, Dh, page_mult, hole):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    ncb = (S - NSA.cmp_block) // NSA.cmp_stride + 1
    x = dict(q=r(B, T, Hq, Dh) / np.sqrt(Dh), kcmp=r(B, ncb, Hkv, Dh),
             vcmp=r(B, ncb, Hkv, Dh), kd=r(B, T, Hkv, Dh), vd=r(B, T, Hkv, Dh),
             gates=1 / (1 + np.exp(-r(B, T, 3, Hq))), ocmp=r(B, T, Hq, Dh))
    kc, vc = r(B, S, Hkv, Dh), r(B, S, Hkv, Dh)
    x["positions"] = (PREFIX + np.minimum(np.arange(T), 3))[None].repeat(B, 0).astype(np.int32)
    sel = np.sort(rng.integers(0, PREFIX // NSA.sel_block, (B, T, Hkv, NSA.n_selected)), -1)
    x["sel_valid"] = rng.random((B, T, Hkv, NSA.n_selected)) < 0.9
    x["tree"] = np.tril(np.ones((T, T), bool))[None].repeat(B, 0)
    ps = NSA.sel_block * page_mult
    mp = S // ps
    P = B * mp + 3
    pages = np.random.default_rng(5).permutation(P)[: B * mp].reshape(B, mp).astype(np.int32)
    pk = r(P, ps, Hkv, Dh)                     # stale bytes in the spare pages
    pv = r(P, ps, Hkv, Dh)
    for b in range(B):
        pk[pages[b]] = kc[b].reshape(mp, ps, Hkv, Dh)
        pv[pages[b]] = vc[b].reshape(mp, ps, Hkv, Dh)
    if hole == "outside":                      # logical page 0: in the prefix, not the window
        pages[:, 0] = -1
        sel = np.maximum(sel, page_mult)       # keep other slots off page 0 ...
        sel[..., 0] = 0                        # ... and one slot in the hole
    elif hole == "inside":                     # the page holding position 80 (window 68..99)
        pages[:, 80 // ps] = -1
    x.update(sel_idx=sel.astype(np.int32), pool_k=pk, pool_v=pv, pages=pages)
    return x


def _run_both(x, C, mode, include_cmp):
    ncb_valid = (PREFIX - NSA.cmp_block) // NSA.cmp_stride + 1
    j = lambda a: jnp.asarray(a)
    oc = x["ocmp"] if not include_cmp else None
    want = jops.nsa_verify_fused(
        j(x["q"]), j(x["pool_k"]), j(x["pool_v"]), j(x["kcmp"]), j(x["vcmp"]), j(x["kd"]),
        j(x["vd"]), j(x["sel_idx"]), j(x["sel_valid"]), j(x["positions"]), PREFIX, ncb_valid,
        j(x["tree"]), j(x["gates"]), JNSA_, C=C, mode=mode, include_cmp=include_cmp,
        o_cmp_in=None if oc is None else j(oc), page_table=j(x["pages"]))
    t = lambda a: torch.from_numpy(np.array(a))
    got = ops.nsa_verify_fused(
        t(x["q"]), t(x["pool_k"]), t(x["pool_v"]), t(x["kcmp"]), t(x["vcmp"]), t(x["kd"]),
        t(x["vd"]), t(x["sel_idx"]), t(x["sel_valid"]), t(x["positions"]),
        torch.tensor(PREFIX), torch.tensor(ncb_valid), t(x["tree"]), t(x["gates"]), NSA,
        C=C, mode=mode, include_cmp=include_cmp, o_cmp_in=None if oc is None else t(oc),
        page_table=t(x["pages"]))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("hole", ["none", "outside", "inside"])
@pytest.mark.parametrize("page_mult", [1, 2])
@pytest.mark.parametrize("C,mode,include_cmp", [(1, "exact", True), (2, "exact", False),
                                                (2, "approx", True), (4, "approx", False)])
def test_paged_plain_matches_jax_kernel(C, mode, include_cmp, page_mult, hole):
    x = _inputs(11 + page_mult, 64, page_mult, hole)
    got, want = _run_both(x, C, mode, include_cmp)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("hole", ["outside", "inside"])
def test_paged_plain_matches_jax_kernel_dh128(hole):
    x = _inputs(21, 128, 2, hole)
    got, want = _run_both(x, 2, "exact", False)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_hole_masks_like_invalid_selection():
    """A selected block on an unmapped page is masked exactly as if the
    slot were invalid on the dense layout (never clamped onto a neighbour)."""
    x = _inputs(12, 64, 1, "outside")
    got, _ = _run_both(x, 2, "exact", True)
    dense_k = np.zeros((B, S, Hkv, 64), np.float32)
    dense_v = np.zeros_like(dense_k)
    ps, mp = NSA.sel_block, S // NSA.sel_block
    for b in range(B):
        for lp in range(mp):
            if x["pages"][b, lp] >= 0:
                dense_k[b, lp * ps:(lp + 1) * ps] = x["pool_k"][x["pages"][b, lp]]
                dense_v[b, lp * ps:(lp + 1) * ps] = x["pool_v"][x["pages"][b, lp]]
    valid = x["sel_valid"].copy()
    valid[..., 0] = False
    t = lambda a: torch.from_numpy(np.array(a))
    masked = ops.nsa_verify_fused(
        t(x["q"]), t(dense_k), t(dense_v), t(x["kcmp"]), t(x["vcmp"]), t(x["kd"]), t(x["vd"]),
        t(x["sel_idx"]), t(valid), t(x["positions"]), torch.tensor(PREFIX),
        torch.tensor((PREFIX - 8) // 4 + 1), t(x["tree"]), t(x["gates"]), NSA, C=2,
        mode="exact", include_cmp=True)
    np.testing.assert_allclose(got, masked.numpy(), rtol=2e-5, atol=2e-6)
