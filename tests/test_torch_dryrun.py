"""The dry run's cell matrix on one card (``repro_torch.launch.specs`` /
``dryrun``): the ``meta`` parameter and cache trees hold the bytes of
``jax.eval_shape(model.init)`` / ``init_caches`` for every arch, reduced
variants too; the cell configs are the JAX dry run's; ``cell_bytes`` and
``fit_batch`` reckon the long-context cells as ``ROADMAP.md`` does;
``--list`` prints the 48 cells on the CPU; ``--run`` raises without a card
(no CPU fallback); ``fill_caches`` fills a cache to its length with the
compressed blocks of its rows; and a reduced cell built on the CPU gives
Strict verify root logits equal to ``decode_step``'s at the full cache."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.analysis import roofline as rl
from repro_torch.config import ShapeConfig
from repro_torch.launch import dryrun, specs
from repro_torch.models import nsa as nsa_lib

torch.set_num_threads(1)


def _jax_bytes(tree):
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree.leaves(tree))


def _variants(arch):
    return [("full", configs.get_config(arch), jcfg.get_config(arch)),
            ("reduced", configs.reduced(arch), jcfg.reduced(arch))]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_meta_bytes_equal_jax_eval_shape(arch):
    for label, cfg, jc in _variants(arch):
        jp = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jc))
        assert specs.param_bytes(cfg) == _jax_bytes(jp), label
        assert rl.tree_numel(rl.param_tree(cfg)) == sum(
            int(np.prod(x.shape)) for x in jax.tree.leaves(jp)), label
        for max_len in (8192 + specs.CACHE_SLACK, 33280):
            jcache = jax.eval_shape(lambda: jmodel.init_caches(jc, 1, max_len))
            assert specs.cache_bytes(cfg, 1, max_len) == _jax_bytes(jcache), (label, max_len)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cell_configs_are_the_jax_dry_runs(arch):
    for shape in specs.SHAPE_BY_NAME:
        cfg, over = specs.cell_config(arch, shape)
        jc = jcfg.get_config(arch)
        if jcfg.dryrun_overrides(arch).get(shape, {}).get("nsa"):
            jc = jcfg.nsa_variant(jc)
        assert cfg.name == jc.name and cfg.attention == jc.attention
        assert over == jcfg.dryrun_overrides(arch).get(shape, {})


def test_cell_bytes_of_the_long_context_cells():
    """ssv-nsa-1b at 524,288 + 512 tokens: 16 layers of K/V (8 heads x 64,
    bf16) and compressed blocks padded to 512, the draft's 2 layers, all
    at batch 1; it fits one card only at batch 1. ssv-nsa-8b at 524,288
    does not fit; at 32,768 it does, at 13 rows."""
    b = specs.cell_bytes("ssv-nsa-1b", "long_500k", 1)
    S = 524288 + 512
    ncb = -(-((S - 32) // 16 + 1) // 512) * 512
    assert b["target_cache"] == 16 * (S + ncb) * 8 * 64 * 2 * 2 + 4
    assert b["draft_cache"] == 2 * S * 8 * 64 * 2 * 2 + 4
    assert b["total"] == b["weights"] + b["target_cache"] + b["draft_weights"] + b["draft_cache"]
    assert round(b["target_cache"] / 1e9, 2) == 18.29 and round(b["draft_cache"] / 1e9, 2) == 2.15
    assert specs.fit_batch("ssv-nsa-1b", "long_500k") == 1
    assert specs.fit_batch("ssv-nsa-8b", "long_500k") == 0
    assert specs.fit_batch("ssv-nsa-8b", "decode_32k") == 13
    assert specs.fit_batch("ssv-nsa-1b", "train_4k") == 256        # activations not reckoned
    t = specs.cell_bytes("ssv-nsa-8b", "train_4k", 256)
    assert t["grads"] == t["weights"] and t["adam_moments"] == 8 * rl.tree_numel(
        rl.param_tree(configs.get_config("ssv-nsa-8b")))
    two = specs.cell_bytes("ssv-nsa-8b", "decode_32k", 2)
    one = specs.cell_bytes("ssv-nsa-8b", "decode_32k", 1)
    assert two["target_cache"] == 2 * one["target_cache"] and two["weights"] == one["weights"]


def test_list_prints_the_48_cells(capsys):
    assert dryrun.main(["--list"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [ln for ln in out if ln.split() and ln.split()[0] in configs.ARCH_IDS]
    assert len(rows) == 48
    assert {(r.split()[0], r.split()[1]) for r in rows} == \
        {(a, s) for a in configs.ARCH_IDS for s in specs.SHAPE_BY_NAME}
    assert out[-1].startswith("48 cells")


def test_static_records_are_written(tmp_path, capsys):
    assert dryrun.main(["--arch", "ssv-nsa-1b", "--shape", "long_500k,decode_32k",
                        "--out", str(tmp_path)]) == 0
    rec = dryrun.run_cell("ssv-nsa-1b", "long_500k", tmp_path)        # read back
    assert rec["fit_batch"] == 1 and rec["roofline"]["bottleneck"] == "memory"
    assert (tmp_path / "static" / "ssv-nsa-1b__decode_32k.json").exists()
    assert "[OK]" in capsys.readouterr().out


def test_run_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "ssv-nsa-1b", "--shape", "decode_32k", "--run",
                     "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.FullCell("ssv-nsa-1b", "decode_32k")
    with pytest.raises(RuntimeError, match="no CPU mode"):
        dryrun.FullCell("ssv-nsa-1b", "decode_32k", device="cpu")
    assert not (tmp_path / "run").exists()


def test_fill_caches_compresses_the_rows(monkeypatch):
    """Chunked ``compress_kv`` equals one call over all the rows; K/V rows
    past the length stay zero; the length is set."""
    monkeypatch.setattr(dryrun, "CMP_CHUNK", 7)
    cfg = configs.reduced("ssv-nsa-1b")
    g = torch.Generator()
    g.manual_seed(0)
    from repro_torch.bridge import init_params
    from repro_torch.models import model
    params = init_params(cfg, g, "cpu")
    caches = model.init_caches(cfg, 1, 300, "cpu")
    dryrun.fill_caches(params, cfg, caches, 250, seed=0)
    assert caches["length"].tolist() == [250]
    for lp, c in zip(params["layers"], caches["layers"]):
        k, v = c["kv"]["k"], c["kv"]["v"]
        assert k[:, 250:].abs().sum() == 0 and k[:, :250].abs().sum() > 0
        kc, vc = nsa_lib.compress_kv(lp["mix"], k[:, :250], v[:, :250], cfg.nsa)
        n = kc.shape[1]
        assert n == nsa_lib.num_cmp_blocks(250, cfg.nsa)
        torch.testing.assert_close(c["cmp"]["k_cmp"][:, :n], kc, rtol=0, atol=0)
        torch.testing.assert_close(c["cmp"]["v_cmp"][:, :n], vc, rtol=0, atol=0)
        assert c["cmp"]["k_cmp"][:, n:].abs().sum() == 0


@pytest.mark.parametrize("arch", ["ssv-nsa-1b", "ssv-nsa-8b"])
def test_strict_root_logits_equal_decode_on_a_full_cache(arch):
    """A reduced cell (f32, CPU, plain versions) built as ``--run`` builds
    it: the root of a Strict verify sees what a one-token decode sees, so
    their logits agree to the f32 tolerance; the Approx+Reuse verify and
    the draft's expansion give finite outputs; decode commits one token."""
    cfg = configs.reduced(arch)
    cell = dryrun.FullCell.__new__(dryrun.FullCell)
    cell._build(arch, cfg, ShapeConfig("decode_32k", 300, 1, "decode"), 0,
                torch.device("cpu"), rl.HBM_PER_CARD)
    strict, _ = cell.verify(dryrun.strict_ssv())
    approx, _ = cell.verify(dryrun.approx_reuse_ssv(cfg.num_layers))
    tokens, node_q, _ = cell.draft()
    assert tokens.shape == (1, 31) and tokens[0, 0] == cell.tokens[0, 0]
    assert torch.isfinite(approx).all() and torch.isfinite(node_q).all()
    dec = cell.decode()
    torch.testing.assert_close(strict[:, :1], dec, rtol=2e-4, atol=2e-5)
    assert cell.caches["length"].tolist() == [301]
    assert dataclasses.asdict(cell.shape)["seq_len"] == 300


@pytest.mark.parametrize("world", [2, 4, 8])
def test_list_world_splits_the_target_cache(world, capsys):
    """``--list --world N``: for every decode cell the per-rank split cache
    bytes x N plus the leaves each rank holds whole (the length, recurrent
    states) equal the single card's target cache, the weights stay whole,
    the batch-1 sharded decode takes the NSA stacks and the recurrent archs,
    and the cells that fit N cards but not one are printed (at N = 4:
    qwen3-8b, musicgen-medium, pixtral-12b and ssv-nsa-8b at long_500k)."""
    assert dryrun.main(["--list", "--world", str(world)]) == 0
    out = capsys.readouterr().out
    decode = [s for s, sh in specs.SHAPE_BY_NAME.items() if sh.kind == "decode"]
    for arch in configs.ARCH_IDS:
        for shape in decode:
            cfg = specs.cell_config(arch, shape)[0]
            r = dryrun.rank_bytes(arch, shape, world)
            single = specs.cell_bytes(arch, shape, 1)
            assert r["divides"], (arch, shape)
            assert r["cache_split"] * world + r["cache_replicated"] == single["target_cache"]
            assert r["weights"] == single["weights"]
            assert r["total"] == r["weights"] + r["target_cache"]
            recurrent = bool(set(cfg.layer_kinds()) & {"rglru", "mlstm", "slstm"})
            assert r["sharded_decode"] == (recurrent or (
                cfg.attention == "nsa" and set(cfg.layer_kinds()) <= {"attn", "moe"}))
            if r["sharded_decode"] and not cfg.moe and not recurrent:
                assert r["cache_replicated"] == 4                    # the (1,) length
    lines = out.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.rstrip().endswith("sharded decode"))
    summary = next(i for i, ln in enumerate(lines)
                   if ln.startswith(f"decode cells that do not fit one card but fit {world}"))
    rows = [ln for ln in lines[head + 1:summary] if ln.split()
            and ln.split()[0] in configs.ARCH_IDS and ln.split()[1] in decode]
    assert len(rows) == summary - head - 1 == len(configs.ARCH_IDS) * len(decode)
    last = lines[summary]
    if world == 4:
        assert last.endswith("qwen3-8b x long_500k, musicgen-medium x long_500k, "
                             "pixtral-12b x long_500k, ssv-nsa-8b x long_500k")
        r = dryrun.rank_bytes("ssv-nsa-8b", "long_500k", 4)
        assert round(r["total"] / 1e9, 2) == 34.37


@pytest.mark.parametrize("world,model", [(2, 1), (4, 2), (8, 2)])
def test_train_rank_bytes_split_the_state(world, model):
    """``train_rank_bytes``: on ``plan_mesh(world, prefer_model=model)`` the
    per-rank bytes of the leaves split over every rank x ``world``, plus the
    whole bytes of the leaves replicated along some axis, equal one card's
    weights, gradients and two float32 moments (``specs.cell_bytes``); the
    per-rank weights and moments are the local shapes'."""
    for arch in configs.ARCH_IDS:
        r = dryrun.train_rank_bytes(arch, "train_4k", world, model)
        one = specs.cell_bytes(arch, "train_4k", 1)
        assert r["split"] * world + r["partial_whole"] == \
            one["weights"] + one["grads"] + one["adam_moments"], arch
        assert r["total"] == r["split"] + r["partial"] == \
            r["weights"] + r["grads"] + r["adam_moments"]
        assert r["mesh"] == [world // model, model]


def test_list_world_model_2_gives_the_8b_train_cell_four_cards(capsys):
    """``--list --world 4 --model 2``: ssv-nsa-8b x train_4k (96.5 GB on one
    card) fits four cards on a (2, 2) mesh and not one; every leaf divides;
    per rank 27.33 GB (24.1 GB were the state split four ways: the
    embedding table and the head are split over ``model`` alone)."""
    assert dryrun.main(["--list", "--world", "4", "--model", "2", "--shape", "train_4k"]) == 0
    out = capsys.readouterr().out
    r = dryrun.train_rank_bytes("ssv-nsa-8b", "train_4k", 4, 2)
    one = specs.cell_bytes("ssv-nsa-8b", "train_4k", 1)
    assert r["divides"] and r["mesh"] == [2, 2]
    assert specs.fit_batch("ssv-nsa-8b", "train_4k") == 0
    assert round(one["total"] / 1e9, 1) == 96.5 and round(r["total"] / 1e9, 2) == 27.33
    assert r["total"] <= rl.HBM_PER_CARD
    row = next(ln for ln in out.splitlines() if ln.startswith("ssv-nsa-8b ") and "train_4k" in ln)
    assert row.split()[-2:] == ["no", "yes"]
    gained = next(ln for ln in out.splitlines() if ln.startswith("train cells that do not fit"))
    assert "ssv-nsa-8b x train_4k" in gained


def test_run_world_on_cpu_ranks_equals_decode_step(tmp_path):
    """``run_sharded`` (``--run --world``'s path) on two gloo ranks on the
    CPU, reduced ssv-nsa-1b at 32,768 tokens: each rank fills only its
    slice, yet the token's logits and written rows equal ``FullCell``'s
    ``decode_step`` on the whole fill; 5 all-reduces per layer."""
    cfg = dataclasses.replace(configs.reduced("ssv-nsa-1b"), dtype="float32")
    recs = dryrun.run_sharded("ssv-nsa-1b", "decode_32k", 2, "gloo", tmp_path, cfg=cfg,
                              device_type="cpu", timeout=240, timed=1, threads=1)
    assert [r["rows"] for r in recs] == [[0, 16640], [16640, 33280]]
    assert all(r["collectives_per_token"] == 5 * cfg.num_layers for r in recs)
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert got[0]["written"] is None and got[1]["written"] is not None
    cell = dryrun.FullCell.__new__(dryrun.FullCell)
    cell._build("ssv-nsa-1b", cfg, specs.SHAPE_BY_NAME["decode_32k"], 0, torch.device("cpu"),
                rl.HBM_PER_CARD)
    dec = cell.decode()
    for g in got:
        torch.testing.assert_close(g["logits"], dec, rtol=2e-4, atol=2e-5)
    for (k, v), c in zip(got[1]["written"], cell.caches["layers"]):
        torch.testing.assert_close(k, c["kv"]["k"][0, 32768], rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(v, c["kv"]["v"][0, 32768], rtol=2e-4, atol=2e-5)


def test_live_at_peak_replays_the_allocator_history():
    """``--trace``'s replay of a train step's allocator history: the peak
    counts the bytes allocated before the call, frees of those blocks come
    off them, "free_requested" is not a free, and each live block goes to
    the innermost frame of the package that allocated it."""
    pkg = "/src/repro_torch/"
    fr = lambda *fs: [{"filename": f, "name": n, "line": 1} for f, n in fs]
    torch_frame = ("/site-packages/torch/nn/functional.py", "linear")
    events = [
        {"action": "alloc", "addr": 1, "size": 100,
         "frames": fr(torch_frame, (pkg + "optim/adamw.py", "adamw_update"))},
        {"action": "alloc", "addr": 2, "size": 50, "frames": fr(torch_frame)},
        {"action": "free_requested", "addr": 2, "size": 50},
        {"action": "free_completed", "addr": 2, "size": 50},
        {"action": "free_completed", "addr": 9, "size": 30},      # allocated before the call
        {"action": "alloc", "addr": 3, "size": 200,
         "frames": fr(torch_frame, (pkg + "models/model.py", "logits_fn"),
                      (pkg + "models/model.py", "loss_fn"))},
        {"action": "alloc", "addr": 4, "size": 5, "frames": []},
        {"action": "free_requested", "addr": 1, "size": 100},
        {"action": "free_completed", "addr": 1, "size": 100},
        {"action": "alloc", "addr": 5, "size": 60, "frames": fr(torch_frame)},
    ]
    out = dryrun.live_at_peak(events, before=1000)
    assert out["peak_bytes"] == 1000 + 100 - 30 + 200 + 5
    assert out["before_bytes"] == 1000 and out["events"] == len(events)
    assert out["owners"] == [{"where": "before the call", "bytes": 970},
                             {"where": "model.py:logits_fn", "bytes": 200},
                             {"where": "adamw.py:adamw_update", "bytes": 100},
                             {"where": "elsewhere", "bytes": 5}]
    assert dryrun.live_at_peak([], before=7)["peak_bytes"] == 7
