"""The port's sharding rules, mesh planning and block placement against the
JAX package: ``launch.sharding.param_specs`` gives every leaf of all twelve
archs (reduced and full configs, on ``meta`` trees against
``jax.eval_shape`` trees) the entries of the JAX ``param_specs`` on the
(data, model) and (pod, data, model) axes, in the JAX ``segments`` layout
(``bridge.restack``) and in the port's per-layer one; ``cache_specs`` in
both modes, ``batch_spec`` and ``activation_spec`` likewise; ``plan_mesh``
and ``mesh_config`` equal the JAX ones over 1-512 devices; ``local_block``'s
blocks over every mesh coordinate tile a tensor exactly; and a shard count
that does not divide S or NCB raises. The JAX rules read only
``mesh.axis_names``, so a stand-in mesh carries the axes."""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshd
from repro.models import model as jmodel
from repro.runtime import elastic as jelastic
from repro_torch import configs
from repro_torch.analysis import roofline as rl
from repro_torch.bridge import restack
from repro_torch.config import MeshConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import model as model_lib
from repro_torch.models import nsa_sharded
from repro_torch.runtime import elastic

torch.set_num_threads(1)

AXES = [("data", "model"), ("pod", "data", "model")]


class _Axes:
    """What the JAX rules read of a mesh."""

    def __init__(self, names):
        self.axis_names = names


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jshd._path_key(p): tuple(s) for p, s in flat}


def _variants(arch):
    return [("full", configs.get_config(arch), jcfg.get_config(arch)),
            ("reduced", configs.reduced(arch), jcfg.reduced(arch))]


def _layer_to_segment(cfg):
    """Port layer index -> (segment path prefix, index along its stack)."""
    out, base = {}, 0
    for s, (kinds, n) in enumerate(model_lib.segments(cfg)):
        m = len(kinds)
        for i in range(n):
            for j in range(m):
                out[base + i * m + j] = (f"segments/{s}/{j}", i)
        base += n * m
    return out


@pytest.mark.parametrize("axes", AXES, ids=["2d", "3d"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_jax(arch, axes):
    for label, cfg, jc in _variants(arch):
        jtree = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jc))
        want = _jax_flat(jshd.param_specs(jc, jtree, _Axes(axes)))
        tree = rl.param_tree(cfg)
        got = sharding.flatten(sharding.param_specs(restack(tree, cfg), axes))
        assert got == want, label
        # the port's own layout: a layer's leaf takes its stacked leaf's spec
        # without the leading (layer) entry
        seg = _layer_to_segment(cfg)
        own = sharding.flatten(sharding.param_specs(tree, axes))
        for key, sp in own.items():
            if key.startswith("layers/"):
                _, li, rest = key.split("/", 2)
                jkey = f"{seg[int(li)][0]}/{rest}"
                assert (None,) + sp == want[jkey], (label, key)
            else:
                assert sp == want[key], (label, key)


@pytest.mark.parametrize("shard_sequence", [False, True])
@pytest.mark.parametrize("axes", AXES, ids=["2d", "3d"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_equal_jax(arch, axes, shard_sequence):
    for label, cfg, jc in _variants(arch):
        jtree = jax.eval_shape(lambda: jmodel.init_caches(jc, 2, 64))
        want = _jax_flat(jshd.cache_specs(jc, jtree, _Axes(axes),
                                          shard_sequence=shard_sequence))
        # the rule on the JAX tree's own keys and shapes
        for key, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            k = jshd._path_key(key)
            assert sharding.cache_spec(k, tuple(leaf.shape), axes,
                                       shard_sequence=shard_sequence) == want[k], (label, k)
        # the port's per-layer cache tree
        seg = _layer_to_segment(cfg)
        own = sharding.flatten(sharding.cache_specs(
            rl.cache_tree(cfg, 2, 64), axes, shard_sequence=shard_sequence))
        for key, sp in own.items():
            if key == "length":
                assert sp == want["length"] == ()
                continue
            _, li, rest = key.split("/", 2)
            jsp = want[f"{seg[int(li)][0]}/{rest}"]
            assert sp == (jsp[1:] if len(jsp) == len(sp) + 1 else jsp), (label, key)


@pytest.mark.parametrize("axes", AXES + [("model",), ("data",)], ids=["2d", "3d", "tp", "dp"])
def test_batch_and_activation_specs_equal_jax(axes):
    assert sharding.batch_spec(axes) == tuple(jshd.batch_spec(_Axes(axes)))
    for layout in ("sp", "dmodel"):
        f = jshd.activation_constraint(_Axes(axes), layout)
        cells = [c.cell_contents for c in f.__closure__]
        jspec = next(c for c in cells if isinstance(c, jax.sharding.PartitionSpec))
        assert sharding.activation_spec(axes, layout) == tuple(jspec)
    assert mesh_lib.dp_axes(axes) == jmesh.dp_axes(_Axes(axes))


@pytest.mark.parametrize("S,m", [(64, 2), (65, 2), (2049, 2), (10, 4), (4096, 4)])
def test_seq_chunk_tiles_the_stream_as_gspmd_pads_it(S, m):
    """The "sp" layout's positions per ``model`` rank: chunks of ceil(S /
    m) in rank order, tiling [0, S) once; only the last one is shorter."""
    c = -(-S // m)
    chunks = [sharding.seq_chunk(S, m, i) for i in range(m)]
    assert chunks[0][0] == 0 and chunks[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    sizes = [b - a for a, b in chunks]
    assert sizes[:-1] == [c] * (m - 1) and 0 < sizes[-1] <= c


def test_mesh_config_equals_jax():
    for multi in (False, True):
        got, want = mesh_lib.mesh_config(multi_pod=multi), jmesh.mesh_config(multi_pod=multi)
        assert (got.shape, got.axes, got.num_devices) == (want.shape, want.axes,
                                                          want.num_devices)


@pytest.mark.parametrize("prefer_model", [1, 2, 4, 8, 16])
def test_plan_mesh_equals_jax(prefer_model):
    for n in range(1, 513):
        for multi, pod in ((False, 0), (True, 256), (True, 128), (True, 0)):
            got = elastic.plan_mesh(n, prefer_model=prefer_model, multi_pod=multi, pod_size=pod)
            want = jelastic.plan_mesh(n, prefer_model=prefer_model, multi_pod=multi,
                                      pod_size=pod)
            assert (got.shape, got.axes) == (want.shape, want.axes), (n, multi, pod)


def test_plan_mesh_cases_of_the_distributed_tests():
    """``tests/test_distributed.py``'s elastic case and the fault demo's."""
    assert elastic.plan_mesh(8, prefer_model=2) == MeshConfig((4, 2), ("data", "model"))
    assert elastic.plan_mesh(4, prefer_model=2) == MeshConfig((2, 2), ("data", "model"))
    assert elastic.plan_mesh(6, prefer_model=4) == MeshConfig((3, 2), ("data", "model"))
    for n in (512, 384, 256, 128):
        got = elastic.plan_mesh(n, prefer_model=16, multi_pod=n > 256, pod_size=256)
        want = jelastic.plan_mesh(n, prefer_model=16, multi_pod=n > 256, pod_size=256)
        assert (got.shape, got.axes) == (want.shape, want.axes)


_TILINGS = [
    ({"data": 2, "model": 2}, [(None, ("data", "model"), None, None), ("data", "model"),
                               ("model", None, "data"), (), (None, None, None)]),
    ({"pod": 2, "data": 2, "model": 2}, [(("pod", "data"), "model"), ("model",),
                                         (None, ("pod", "data", "model")), ("data", None, "pod")]),
    ({"data": 4, "model": 1}, [(None, ("data", "model"), None, None)]),
]


@pytest.mark.parametrize("mesh_shape,specs", _TILINGS, ids=["2x2", "2x2x2", "4x1"])
def test_local_blocks_tile_the_tensor(mesh_shape, specs):
    """Over every coordinate, the blocks cover each element once per
    replica (the product of the axes the spec leaves out) and hold the
    tensor's values at their place; dimensions split over several axes are
    cut row-major."""
    g = torch.Generator()
    g.manual_seed(0)
    x = torch.randn((8, 16, 4, 2), generator=g)
    axes = list(mesh_shape)
    for sp in specs:
        used = {a for e in sp if e for a in ((e,) if isinstance(e, str) else e)}
        replicas = int(np.prod([mesh_shape[a] for a in axes if a not in used]))
        count = torch.zeros_like(x)
        rebuilt = torch.zeros_like(x)
        for idx in itertools.product(*[range(mesh_shape[a]) for a in axes]):
            coords = dict(zip(axes, idx))
            sl = sharding.local_slices(x.shape, sp, mesh_shape, coords)
            blk = sharding.local_block(x, sp, mesh_shape, coords)
            assert torch.equal(blk, x[sl])
            count[sl] += 1
            rebuilt[sl] = blk
        assert torch.equal(count, torch.full_like(x, replicas)), sp
        assert torch.equal(rebuilt, x)
        # row-major over a multi-axis entry: the first axis moves slowest
        for d, e in enumerate(sp):
            if isinstance(e, tuple):
                first = {a: 0 for a in axes}
                last_fast = dict(first, **{e[-1]: 1})
                s0 = sharding.local_slices(x.shape, sp, mesh_shape, first)[d]
                s1 = sharding.local_slices(x.shape, sp, mesh_shape, last_fast)[d]
                assert s1.start == s0.stop


def test_local_block_raises_when_a_dimension_does_not_divide():
    with pytest.raises(ValueError, match="dimension 1 of size 6 does not divide"):
        sharding.local_slices((2, 6), (None, ("data", "model")), {"data": 2, "model": 2},
                              {"data": 0, "model": 0})


@pytest.mark.parametrize("S,NCB,n,match", [
    (262, 72, 4, "S = 262 does not divide by 4 shards"),
    (264, 66, 4, "NCB = 66 does not divide by 4 shards"),
    (262, 66, 4, "S = 262 and NCB = 66 do not divide by 4 shards")])
def test_shard_counts_that_do_not_divide_raise(S, NCB, n, match):
    with pytest.raises(ValueError, match=match):
        nsa_sharded.check_shards(S, NCB, n)
    nsa_sharded.check_shards(264, 72, 4)


def test_overlap_band_equals_the_rows_of_the_full_matrix():
    """A rank's band of the overlap matrix holds the full matrix's values;
    the columns outside the band are zero in the full matrix."""
    from repro_torch.models import nsa as nsa_lib
    nsa = configs.reduced("ssv-nsa-1b").nsa
    ncb, nsb = 72, 17
    full = nsa_lib.overlap_matrix(ncb, nsb, nsa.cmp_block, nsa.cmp_stride, nsa.sel_block)
    for n in (1, 2, 4, 8):
        for r in range(n):
            rows = slice(r * ncb // n, (r + 1) * ncb // n)
            c0, band = nsa_sharded.overlap_band(rows.start, rows.stop - rows.start, nsb,
                                                nsa.cmp_block, nsa.cmp_stride, nsa.sel_block)
            np.testing.assert_array_equal(band, full[rows, c0:c0 + band.shape[1]])
            assert full[rows, :c0].sum() == 0 and full[rows, c0 + band.shape[1]:].sum() == 0
