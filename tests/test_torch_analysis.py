"""The port's analysis layer (``repro_torch.analysis.roofline``) and cell
shapes against the JAX package: ``SHAPES`` equals the JAX tuple;
``model_flops`` and ``active_param_count`` equal the JAX values, float for
float, on all 12 archs x 4 shapes (each cell's config as the dry run
builds it); ``Roofline`` keeps the JAX fields, properties and row keys with
the H100's constants; ``step_cost``'s weight bytes are the ``meta``
parameter tree's, which are ``jax.eval_shape(model.init)``'s; and the
kernel bounds moved out of ``chip_smoke.py`` reproduce the ``bound ms``
column of ``PERF.md`` section 6 at phase 8's shapes (bf16 K/V, B=1, T=31,
S=8192, prefix 4096; inputs drawn here on the CPU, so the nsa_verify rows,
whose bytes count the union of the selected blocks, agree within 1%; the
routing and flash rows, which do not depend on the draw, to the printed
digit)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.analysis import roofline as jrl
from repro.config import SHAPES as J_SHAPES
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.analysis import roofline as rl
from repro_torch.config import SHAPES, ShapeConfig
from repro_torch.core.tree import build_topology
from repro_torch.kernels import per_row
from repro_torch.kernels.nsa_verify import ops as vops
from repro_torch.launch import specs
from repro_torch.models import nsa as nsa_lib

torch.set_num_threads(1)


def _jax_cell_config(arch, shape):
    cfg = jcfg.get_config(arch)
    if jcfg.dryrun_overrides(arch).get(shape, {}).get("nsa"):
        cfg = jcfg.nsa_variant(cfg)
    return cfg


def test_shapes_equal_the_jax_tuple():
    assert [dataclasses.astuple(s) for s in SHAPES] == \
        [dataclasses.astuple(s) for s in J_SHAPES]
    assert [s.name for s in SHAPES] == ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_and_active_params_equal_jax(arch):
    for shape, jshape in zip(SHAPES, J_SHAPES):
        cfg, _ = specs.cell_config(arch, shape.name)
        jc = _jax_cell_config(arch, shape.name)
        assert cfg.name == jc.name
        assert cfg.active_param_count() == jc.active_param_count()
        assert cfg.param_count() == jc.param_count()
        assert rl.model_flops(cfg, shape) == jrl.model_flops(jc, jshape)


def test_roofline_keeps_the_jax_fields_and_row():
    assert [f.name for f in dataclasses.fields(rl.Roofline)][:12] == \
        [f.name for f in dataclasses.fields(jrl.Roofline)]
    kw = dict(arch="a", shape="s", mesh="m", num_devices=1, compute_s=2e-3, memory_s=5e-3,
              collective_s=0.0, model_flops=1e12, hlo_flops_per_dev=2e12,
              hbm_bytes_per_dev=1e10, wire_bytes_per_dev=0.0, bytes_per_dev_peak=2e10)
    ours, theirs = rl.Roofline(**kw), jrl.Roofline(**kw)
    assert ours.row().keys() == theirs.row().keys()
    for prop in ("bottleneck", "step_time_s", "useful_ratio"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    # the H100 constants: the fraction is against 989 TFLOP/s, the fit
    # against 80 GiB (or the card's own total_memory)
    assert ours.roofline_fraction == pytest.approx(1e12 / 5e-3 / 989e12, rel=1e-12)
    assert (rl.PEAK_FLOPS, rl.F32_FLOPS, rl.HBM_BW) == (989e12, 67e12, 3.35e12)
    assert ours.fits_hbm and not dataclasses.replace(ours, bytes_per_dev_peak=81 * 2 ** 30).fits_hbm
    assert not dataclasses.replace(ours, capacity_bytes=1e10).fits_hbm


@pytest.mark.parametrize("arch", ["ssv-nsa-1b", "qwen3-moe-235b-a22b", "recurrentgemma-9b"])
def test_step_cost_weight_bytes_are_the_meta_tree_bytes(arch):
    cfg = configs.get_config(arch)
    meta = rl.param_tree(cfg)
    assert all(t.device.type == "meta" for t in _leaves(meta))
    jtree = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jcfg.get_config(arch)))
    jbytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree.leaves(jtree))
    assert rl.tree_bytes(meta) == jbytes
    for shape in SHAPES:
        cost = rl.step_cost(cfg, shape, batch=1)
        assert cost.weight_bytes == jbytes
        assert cost.flops > 0 and cost.hbm_bytes > 0 and cost.wire_bytes == 0


def test_step_cost_of_a_decode_counts_weights_and_attention():
    """ssv-nsa-1b, one decode token over a 32,768-token cache: the weights
    once (the embedding table replaced by the row looked up), and per layer
    and kv head the visible compressed blocks, n x l' selected and w window
    keys, K and V, plus the new row written; flops 2 x (active params -
    table) + 4 x Dh per (query head, key)."""
    cfg = configs.get_config("ssv-nsa-1b")
    shape = ShapeConfig("decode_32k", 32768, 1, "decode")
    cost = rl.step_cost(cfg, shape)
    nsa = cfg.nsa
    ncb = (32768 - nsa.cmp_block) // nsa.cmp_stride + 1
    keys = ncb + nsa.n_selected * nsa.sel_block + nsa.window
    table = cfg.vocab_size * cfg.d_model
    w = specs.param_bytes(cfg)
    attn = 16 * 8 * 64 * 2 * 2 * (keys + 2)
    assert cost.hbm_bytes == w - 2 * table + 2 * cfg.d_model + attn
    assert cost.flops == 2 * (cfg.active_param_count() - table) + 16 * 32 * 4 * 64 * (keys + 1)
    roof = rl.build("ssv-nsa-1b", shape, "card", 1, cfg, cost, 3e9)
    assert roof.bottleneck == "memory" and roof.fits_hbm
    assert roof.step_time_s == pytest.approx(cost.hbm_bytes / 3.35e12)


def test_attention_flops_count_what_each_query_attends():
    """The train attention's forward FLOPs (phase 9's needed-FLOPs term):
    per query at position p, NSA's visible compressed blocks + min(n x l',
    p) selected + min(w, p + 1) window keys; dense p + 1 keys."""
    cfg = configs.get_config("ssv-nsa-1b")
    nsa, S = cfg.nsa, 700
    keys = sum(nsa_lib.num_cmp_blocks(p, nsa) + min(nsa.n_selected * nsa.sel_block, p) +
               min(nsa.window, p + 1) for p in range(S))
    assert rl.attention_flops(cfg, 2, S) == 4 * 64 * 32 * 2 * keys * 16
    dense = dataclasses.replace(cfg, attention="dense")
    assert rl.attention_flops(dense, 1, S) == 4 * 64 * 32 * (S * (S + 1) // 2) * 16
    n_matmul = 10 ** 9
    assert rl.train_flops_needed(cfg, n_matmul, 1, S) == \
        6 * n_matmul * S + 3 * rl.attention_flops(cfg, 1, S)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------- kernel bounds
def _tree(prefix):
    topo = build_topology(4, 2, "bfs")
    positions = (torch.as_tensor(topo.depths)[None] + prefix).to(torch.int32)
    return topo, positions, torch.as_tensor(topo.mask)[None]


def _verify_inputs(cfg, seed, prefix=4096, S=8192):
    """``chip_smoke.py``'s ``verify_inputs`` drawn on the CPU (bf16 K/V)."""
    nsa, dt = cfg.nsa, torch.bfloat16
    g = torch.Generator()
    g.manual_seed(seed)
    topo, pos, tree_mask = _tree(prefix)
    T, Hq, Hkv, Dh = topo.num_nodes, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    plen = torch.tensor([prefix], dtype=torch.int32)
    r = lambda *s: torch.randn(s, generator=g)
    NCB = nsa_lib.init_cmp_cache(cfg, 1, S, dt, "cpu")["k_cmp"].shape[1]
    p_slc = torch.rand((1, T, Hkv, nsa_lib.num_sel_blocks(S, nsa)), generator=g)
    sel_idx, sel_valid = nsa_lib.select_topn(p_slc, pos, plen, nsa)
    return dict(q=r(1, T, Hq, Dh) / Dh ** 0.5, k_cache=r(1, S, Hkv, Dh).to(dt),
                k_cmp=r(1, NCB, Hkv, Dh).to(dt), sel_idx=sel_idx, sel_valid=sel_valid,
                positions=pos, prefix_len=plen, ncb_valid=nsa_lib.dyn_num_cmp_blocks(plen, nsa),
                tree_mask=tree_mask, gates=torch.sigmoid(r(1, T, 3, Hq)))


def _layouts(cfg, inp, C, mode):
    """The layouts of ``chip_smoke.py``'s ``verify_layouts`` that the bound reads."""
    nsa, S = cfg.nsa, inp["k_cache"].shape[1]
    merged, mvalid, own, _ = vops.group_layouts(inp["sel_idx"], inp["sel_valid"],
                                                inp["positions"], C, mode)
    pos = inp["positions"]
    dist = pos[:, :, None] - pos[:, None, :]
    W = min(nsa.window, S)
    return dict(merged=merged, mvalid=mvalid, own=own, positions=pos,
                ncb_valid=per_row(inp["ncb_valid"], 1, "cpu"),
                win_start=(inp["prefix_len"] - W).clamp(0, S - W).to(torch.int32),
                dmask=(inp["tree_mask"] & (dist < nsa.window) & (dist >= 0)).to(torch.int32))


# PERF.md section 6, bound ms (routing; exact C=2 full; exact C=2 partial;
# the vanilla row, the mean of its two single-branch launches)
PERF_BOUNDS = {"ssv-nsa-1b": (0.00035, 0.00317, 0.00309, 0.00159),
               "ssv-nsa-8b": (0.00065, 0.00631, 0.00615, 0.00315)}


@pytest.mark.parametrize("arch", sorted(PERF_BOUNDS))
def test_kernel_bounds_reproduce_the_perf_table(arch):
    cfg = configs.get_config(arch)
    inp = _verify_inputs(cfg, seed=2)
    routing, full, partial, vanilla = PERF_BOUNDS[arch]
    got = rl.routing_bound(cfg, inp)
    assert got[0] == pytest.approx(routing, abs=5e-6) and got[1] == "bytes"
    b_full = rl.verify_bound(cfg, inp, _layouts(cfg, inp, 2, "exact"), True)
    b_part = rl.verify_bound(cfg, inp, _layouts(cfg, inp, 2, "exact"), False)
    lay1 = _layouts(cfg, inp, 1, "exact")
    b_van = [rl.verify_bound(cfg, inp, lay1, False, br)[0] for br in ("slc", "win")]
    assert b_full[0] == pytest.approx(full, rel=1e-2) and b_full[1] == "bytes"
    assert b_part[0] == pytest.approx(partial, rel=1e-2)
    assert sum(b_van) / 2 == pytest.approx(vanilla, rel=1e-2)
    # bytes alone are the bound of bf16 K/V; float32 K/V count operations at 67 TFLOP/s
    assert rl.bound(3.35e9, 1.0) == (1.0, "bytes", 1.0)
    assert rl.bound(1.0, 67e9)[:2] == (1.0, "operations")
    assert rl.dot_rate(torch.bfloat16) == 989e12 and rl.dot_rate(torch.float32) == 67e12


@pytest.mark.parametrize("Dh,perf", [(64, 0.00256), (128, 0.00512)])
def test_flash_bound_reproduces_the_perf_table(Dh, perf):
    """The 1B and 8B drafts' flash rows (8 heads, Gq 1): the visible prefix
    and the draft K/V of each head once, q, out, positions, the mask."""
    topo, pos, tree_mask = _tree(4096)
    T, H, S = topo.num_nodes, 8, 8192
    inp = dict(q=torch.zeros(1, T, H, Dh), k_cache=torch.zeros(1, S, H, Dh, dtype=torch.bfloat16),
               positions=pos, prefix_len=torch.tensor([4096], dtype=torch.int32),
               tree_mask=tree_mask)
    got = rl.flash_bound(inp)
    assert got[0] == pytest.approx(perf, abs=5e-6) and got[1] == "bytes"
    keys = (4096 + T) * H * Dh * 2 * 2
    assert got[2] == pytest.approx((keys + T * H * Dh * 8 + T * 4 + T * T * 4 + 4) / 3.35e9)
