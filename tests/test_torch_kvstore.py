"""The port's KV store against the JAX store on the same numpy contents:
paged and dense ``KVView`` reads (tokens, selected blocks, the window
sweep with W % page_size != 0 at every in-page offset, the materialized
view), writes with per-row starts and ``row_mask``, the adversarial-index
contract (negative / out-of-range / unmapped / out-of-pool pages read exact
zeros, writes there are dropped), ``PageAllocator`` invariants on the same
alloc/free sequences, ``admit_row_paged`` / ``admit_row_dense`` against the
JAX admissions on prefilled caches, and the store config. Exact equality
(float32 copies, no arithmetic)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import engine as jengine, kvstore as JK
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.bridge import from_jax
from repro_torch.core import kvstore as KS
from repro_torch.models import model

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)


def _twin(seed, B=2, S=64, H=2, D=8, ps=16, extra=3, holes=()):
    """The same shuffled page pool and page table as a JAX and a torch
    paged view, plus the dense (B, S, H, D) layout they hold; ``holes``
    lists (row, logical page) entries set to -1."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(B, S, H, D)).astype(np.float32)
    v = rng.normal(size=(B, S, H, D)).astype(np.float32)
    mp = S // ps
    P = B * mp + extra
    pages = np.random.default_rng(seed + 1).permutation(P)[: B * mp].reshape(B, mp)
    pages = pages.astype(np.int32)
    pk = rng.normal(size=(P, ps, H, D)).astype(np.float32)    # stale pool bytes
    pv = rng.normal(size=(P, ps, H, D)).astype(np.float32)
    for b in range(B):
        pk[pages[b]] = k[b].reshape(mp, ps, H, D)
        pv[pages[b]] = v[b].reshape(mp, ps, H, D)
    for b, lp in holes:
        pages[b, lp] = -1
    jv = JK.KVView(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pages))
    tv = KS.KVView(torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()),
                   torch.from_numpy(pages.copy()))
    return jv, tv, k, v


def _eq(t_pair, j_pair):
    for t, j in zip(t_pair, j_pair):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", range(4))
def test_paged_reads_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    jv, tv, k, _ = _twin(seed, holes=[(1, 2)])
    assert tv.is_paged and tv.max_len == jv.max_len == 64 and tv.batch == 2
    _eq(tv.full(), jv.full())
    tok = rng.integers(-5, 70, size=(2, 9)).astype(np.int32)
    _eq(tv.gather_tokens(torch.from_numpy(tok)), jv.gather_tokens(jnp.asarray(tok)))
    idx = rng.integers(-3, 7, size=(2, 4, 2, 3)).astype(np.int32)
    _eq(tv.gather_blocks(torch.from_numpy(idx), 16), jv.gather_blocks(jnp.asarray(idx), 16))
    # the window sweep: W a multiple of the page size and not (W % ps = 8),
    # at offsets spanning a page, as one scalar start and as per-row starts
    for W in (16, 24):
        for ws in (0, 3, 9, 15, 17, 31, 40):
            _eq(tv.window(ws, W), jv.window(jnp.int32(ws), W))
            per_row = tv.window(torch.tensor([ws, max(0, ws - 5)]), W)
            for b, start in enumerate((ws, max(0, ws - 5))):
                want = jv.window(jnp.int32(start), W)
                np.testing.assert_array_equal(per_row[0][b].numpy(), np.asarray(want[0][b]))


def test_paged_window_reads_zeros_in_a_hole():
    """An unmapped page inside the window reads exact zeros (the JAX paged
    window does the same); the mapped rest of the window is untouched."""
    jv, tv, k, _ = _twin(3, holes=[(0, 1)])
    kw, _ = tv.window(8, 32)                       # positions 8..39: page 1 = 16..31
    _eq((kw,), (jv.window(jnp.int32(8), 32)[0],))
    np.testing.assert_array_equal(kw[0, 8:24].numpy(), 0.0)
    np.testing.assert_array_equal(kw[0, :8].numpy(), k[0, 8:16])
    np.testing.assert_array_equal(kw[1].numpy(), k[1, 8:40])


def test_adversarial_pages_read_zeros_and_drop_writes():
    """Negative / out-of-range positions, unmapped pages and page ids past
    the pool read zeros; writes there are dropped, never clamped onto a
    neighbour. (A page id past the pool is not a JAX case: the JAX view
    clamps it; the port treats it as unmapped.)"""
    _, tv, k, _ = _twin(5, holes=[(0, 3)])
    P = tv.k.shape[0]
    tv.pages[1, 0] = P + 2                          # out-of-pool page id
    tok = torch.tensor([[-1, 64, 99, 50], [0, 5, 15, 16]])
    kt, vt = tv.gather_tokens(tok)
    np.testing.assert_array_equal(kt[0, :3].numpy(), 0.0)
    np.testing.assert_array_equal(kt[0, 3].numpy(), 0.0)             # hole page 3
    np.testing.assert_array_equal(kt[1, :3].numpy(), 0.0)             # page id past pool
    np.testing.assert_array_equal(kt[1, 3].numpy(), k[1, 16])
    idx = torch.tensor([-1, -7, 4, 9, 3, 0]).reshape(1, 1, 1, 6).expand(2, 1, 2, 6)
    kb, _ = tv.gather_blocks(idx, 16)
    np.testing.assert_array_equal(kb[0, :, :, :5].numpy(), 0.0)
    np.testing.assert_array_equal(kb[1, :, :, 5].numpy(), 0.0)
    before_k, before_v = tv.k.clone(), tv.v.clone()
    new = torch.ones((2, 6, 2, 8))
    tv.write(new, new, torch.tensor([60, 0]))       # row 0: 60..63 hole, 64.. past end
    torch.testing.assert_close(tv.k, before_k, rtol=0, atol=0)
    torch.testing.assert_close(tv.v, before_v, rtol=0, atol=0)


@pytest.mark.parametrize("starts,mask", [((10, 10), (True, True)), ((10, 33), (True, False)),
                                         ((62, 7), (True, True)), ((5, 40), (False, False))])
def test_paged_writes_match_jax(starts, mask):
    """Per-row starts, ``row_mask`` and positions past the mapped pages: the
    torch in-place write leaves the pool the JAX write returns."""
    jv, tv, _, _ = _twin(7, holes=[(1, 3)])
    rng = np.random.default_rng(1)
    kn = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
    vn = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
    jk, jvv = jv.write(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(starts, jnp.int32),
                       row_mask=jnp.asarray(mask))
    tk, tvv = tv.write(torch.from_numpy(kn), torch.from_numpy(vn), torch.tensor(starts),
                       row_mask=torch.tensor(mask))
    _eq((tk, tvv), (jk, jvv))


def test_dense_view_per_row_paths_match_jax():
    """Dense reads and writes with one start per row equal the JAX dense
    view applied row by row (the JAX dense write takes one start)."""
    rng = np.random.default_rng(2)
    k = rng.normal(size=(3, 48, 2, 8)).astype(np.float32)
    v = rng.normal(size=(3, 48, 2, 8)).astype(np.float32)
    tv = KS.KVView(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    starts = (0, 17, 40)
    kw, vw = tv.window(torch.tensor(starts), 8)
    kn = rng.normal(size=(3, 4, 2, 8)).astype(np.float32)
    tv.write(torch.from_numpy(kn), torch.from_numpy(kn), torch.tensor([3, 20, 44]))
    for b, (ws, st) in enumerate(zip(starts, (3, 20, 44))):
        jrow = JK.KVView(jnp.asarray(k[b:b + 1]), jnp.asarray(v[b:b + 1]))
        jw = jrow.window(jnp.int32(ws), 8)
        np.testing.assert_array_equal(kw[b].numpy(), np.asarray(jw[0][0]))
        np.testing.assert_array_equal(vw[b].numpy(), np.asarray(jw[1][0]))
        jk, _ = jrow.write(jnp.asarray(kn[b:b + 1]), jnp.asarray(kn[b:b + 1]), st)
        np.testing.assert_array_equal(tv.k[b].numpy(), np.asarray(jk[0]))
    with pytest.raises(ValueError, match="row_mask"):
        tv.write(torch.from_numpy(kn), torch.from_numpy(kn), 0, row_mask=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="overruns"):
        tv.write(torch.from_numpy(kn), torch.from_numpy(kn), 46)


@pytest.mark.parametrize("seed", range(6))
def test_allocator_matches_jax_and_keeps_invariants(seed):
    """The same random alloc/free sequence on both allocators hands out the
    same pages; live allocations stay disjoint; exhaustion returns None and
    changes nothing; double and foreign frees raise."""
    rng = np.random.default_rng(seed)
    total = int(rng.integers(4, 40))
    ja, ta = JK.PageAllocator(total), KS.PageAllocator(total)
    live = []
    for _ in range(150):
        if rng.random() < 0.55 or not live:
            n = int(rng.integers(1, 6))
            jp, tp = ja.alloc(n), ta.alloc(n)
            if jp is None:
                assert tp is None and ta.free_count == ja.free_count < n
                continue
            np.testing.assert_array_equal(tp, jp)
            assert not set(tp.tolist()) & {p for ps in live for p in ps}
            live.append(tp.tolist())
        else:
            pg = live.pop(int(rng.integers(0, len(live))))
            ja.free(pg)
            ta.free(pg)
        assert (ta.free_count, ta.used_count) == (ja.free_count, ja.used_count)
        assert ta.occupancy == ja.occupancy and ta.can_alloc(1) == ja.can_alloc(1)
    if live:
        ta.free(live[0])
        with pytest.raises(ValueError, match="not allocated"):
            ta.free(live[0])
    with pytest.raises(ValueError):
        ta.alloc(0)
    with pytest.raises(ValueError):
        KS.PageAllocator(0)


def test_store_config_matches_jax():
    tc = configs.reduced("ssv-nsa-1b")
    jc = jconfigs.reduced("ssv-nsa-1b")
    with pytest.raises(ValueError, match="backend"):
        KS.KVStoreConfig(backend="ragged")
    with pytest.raises(ValueError, match="sel_block"):
        KS.KVStoreConfig("paged", page_size=24).resolved_page_size(tc)
    for ps in (0, 16, 32):
        st, jst = KS.KVStoreConfig("paged", page_size=ps), JK.KVStoreConfig("paged", page_size=ps)
        assert st.resolved_page_size(tc) == jst.resolved_page_size(jc)
        assert st.logical_pages(256, st.resolved_page_size(tc)) == \
            jst.logical_pages(256, jst.resolved_page_size(jc))
    with pytest.raises(ValueError, match="multiple"):
        KS.KVStoreConfig("paged").logical_pages(100, 16)
    assert [KS.pages_needed(n, 16) for n in (0, 1, 16, 17)] == \
        [JK.pages_needed(n, 16) for n in (0, 1, 16, 17)]


@pytest.mark.parametrize("backend,ps", [("paged", 16), ("paged", 32), ("dense", 0)])
def test_row_admission_matches_jax(backend, ps):
    """A prefilled single-request cache landed in row 1 of a 3-row batch
    (paged: into shuffled pages of a shared pool, the unmapped tail
    dropped) gives the JAX admission's pool / rows, compressed cache and KV
    bytes."""
    jc = dataclasses.replace(jconfigs.reduced("ssv-nsa-1b", layers=2), num_kv_heads=2)
    tc = dataclasses.replace(configs.reduced("ssv-nsa-1b", layers=2), num_kv_heads=2)
    jp = jmodel.init(jax.random.PRNGKey(0), jc)
    tp = from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    prompt = np.random.default_rng(3).integers(0, tc.vocab_size, 70)
    S = 128
    jst = JK.KVStoreConfig(backend, ps)
    tst = KS.KVStoreConfig(backend, ps)
    _, jrow = jmodel.prefill(jp, jc, jnp.asarray(prompt)[None], S)
    _, trow = model.prefill(tp, tc, torch.from_numpy(prompt)[None], S)
    jb = jmodel.init_caches(jc, 3, S, jst)["segments"]
    tb = model.init_caches(tc, 3, S, "cpu", tst)
    if backend == "paged":
        row = np.full((S // ps,), -1, np.int32)
        row[:3] = np.array([7, 2, 11]) % (3 * S // ps)
        jb = JK.admit_row_paged(jb, jrow["segments"], jnp.int32(1), jnp.asarray(row))
        KS.admit_row_paged(tb, trow, 1, row)
    else:
        jb = jengine.admit_row_segments(jb, jrow["segments"], 1)
        KS.admit_row_dense(tb, trow, 1)
    for li, layer in enumerate(tb["layers"]):
        jl = jax.tree.map(lambda a: np.asarray(a[li]), jb[0][0])
        for part in ("kv", "cmp"):
            for name, t in layer[part].items():
                np.testing.assert_allclose(t.numpy(), jl[part][name], rtol=2e-4, atol=2e-5)
    assert KS.kv_cache_bytes(tb) == JK.kv_cache_bytes(jb)
