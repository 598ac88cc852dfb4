"""The overlap statistics of paper Figs. 2 and 4 (``repro_torch.core.overlap``:
``overlap_ratio``, ``adjacent_overlap``, ``pairwise_overlap_by_distance``)
against ``repro.core.overlap`` on the same seeded indices: duplicate
indices inside a set, invalid entries (set semantics: each counts once or
not at all) and empty sets (ratio 1.0), at the shapes the profiling bench
uses (B, T, Hkv, n). float32 on both sides; the means agree to rtol
1e-6 (the sums are taken in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import overlap as jov
from repro_torch.core import overlap as ov

torch.set_num_threads(1)


def _sets(seed, B=2, T=9, H=3, n=6, hi=12):
    """Indices in [0, hi) (duplicates likely), about a fifth invalid, one
    query's set empty in every head."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, hi, size=(B, T, H, n)).astype(np.int32)
    valid = rng.random((B, T, H, n)) > 0.2
    valid[0, 3] = False                                   # an empty set
    return idx, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_ratio_equals_jax(seed):
    idx, valid = _sets(seed)
    a, va, b, vb = idx[:, :-1], valid[:, :-1], idx[:, 1:], valid[:, 1:]
    want = np.asarray(jov.overlap_ratio(jnp.asarray(a), jnp.asarray(va),
                                        jnp.asarray(b), jnp.asarray(vb)))
    got = ov.overlap_ratio(torch.as_tensor(a), torch.as_tensor(va),
                           torch.as_tensor(b), torch.as_tensor(vb))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_overlap_ratio_set_semantics():
    """Duplicates count once, invalid entries not at all, two empty sets
    give 1.0, one empty set 0.0."""
    i = torch.tensor([[1, 1, 2, 7], [5, 5, 5, 5], [3, 4, 0, 0], [9, 9, 9, 9]])
    v = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0], [0, 0, 0, 0]], dtype=torch.bool)
    j = torch.tensor([[2, 3, 1, 1], [5, 6, 6, 6], [1, 2, 3, 4], [0, 0, 0, 0]])
    w = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0], [0, 0, 0, 0]], dtype=torch.bool)
    got = ov.overlap_ratio(i, v, j, w)
    assert got.tolist() == [pytest.approx(1 / 3), 0.5, 0.0, 1.0]
    ds, dv = ov._dedupe(i, v)
    assert ds[0].tolist() == [1, 1, 2, ov.SENTINEL] and dv[0].tolist() == [True, False, True, False]


@pytest.mark.parametrize("seed", [0, 3])
def test_adjacent_overlap_equals_jax(seed):
    idx, valid = _sets(seed, B=3, T=12, H=2, n=8, hi=20)
    want = np.asarray(jov.adjacent_overlap(jnp.asarray(idx), jnp.asarray(valid)))
    got = ov.adjacent_overlap(torch.as_tensor(idx), torch.as_tensor(valid))
    assert got.shape == (11,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed,max_delta", [(0, 4), (5, 16)])
def test_pairwise_overlap_by_distance_equals_jax(seed, max_delta):
    """Positions of a D3/k2-like tree (depths repeat, so a distance has
    several pairs) and a chain; distances past the deepest pair give NaN."""
    idx, valid = _sets(seed, B=2, T=7, H=2, n=5, hi=10)
    pos = np.array([[100, 101, 101, 102, 102, 102, 102],
                    [50, 51, 52, 53, 54, 55, 56]], np.int32)
    d_want, want = jov.pairwise_overlap_by_distance(jnp.asarray(idx), jnp.asarray(valid),
                                                    jnp.asarray(pos), max_delta)
    d_got, got = ov.pairwise_overlap_by_distance(torch.as_tensor(idx), torch.as_tensor(valid),
                                                 torch.as_tensor(pos), max_delta)
    np.testing.assert_array_equal(d_got, np.asarray(d_want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0, equal_nan=True)
    assert np.isnan(got.numpy()[6:]).all() and not np.isnan(got.numpy()[:6]).any()
