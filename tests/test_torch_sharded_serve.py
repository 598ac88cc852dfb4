"""The dry run's serve cells across ranks (``models.prefill_sharded``, the
batched ``models.nsa_sharded.decode_step_sharded``, ``runtime.sharded.
ServeWeights``) on gloo ranks on the CPU, against the JAX package:

  * reduced ssv-nsa-1b and a head-dim-128 reduced ssv-nsa-8b (d_model
    512), float32, 2 rows x 32-token prompts, ``max_len`` 80, on the
    (data, model) meshes (2, 1), (1, 2) and (2, 2): the sharded prefill
    equals the JAX ``model.prefill`` (the last position's logits, a vocab
    slice per ``model`` rank; every rank's K/V and compressed slices ==
    ``local_block`` of the JAX caches under ``cache_specs(shard_sequence=
    False)``), and the prefill followed by 12 sharded decode tokens equals
    the JAX ``prefill`` followed by 12 ``decode_step``s (each token's logits
    and the caches after the last), rtol 2e-4 / atol 2e-5, argmax equal;
    the 12th token completes compressed block 9 (rows 36-43), whose rows
    straddle the ``model`` boundary at row 40, and model rank 0 writes it;
  * the collectives: 2 per layer and 2 more a prefill, 5 per layer and 1
    more a decode token (6 per layer on the token that completes block 9
    across the boundary), and the weights' gathers of every split leaf;
  * ``--list --world N --model M``: per-rank weights and cache bytes of the
    prefill and batched decode cells split x N plus the rest whole equal
    one card's; the 8B prefill at batch 32 and the 1B decode at batch 128
    fit four cards and not one; ``--run`` on a prefill cell raises without
    a card;
  * ``dryrun.run_serve_sharded`` on a batched decode cell (reduced 1B at
    32,768 tokens, batch 2, two CPU ranks on (1, 2)) equals ``decode_step``
    on the whole fill; ``fill_caches`` seeds each batch row, so a rank's
    rows equal the same rows of a whole fill and row 0 keeps its fill; on
    (1, 4) with a short fill, ranks whose slices hold no filled row still
    join each layer's gather of the compressed branch's weights;
  * ``nsa.attend_queries`` on slices of the queries gives the rows of
    ``attend_train_nsa``; ``compress.noise_for`` draws different noise for
    two leaves of one step and for one leaf at two steps.

Each world is one spawned run (``launch.ranks.spawn``, a ``FileStore`` in
``tmp_path``, one thread per rank, its own timeout; the two worlds side by
side) that runs every job of ``launch.serve_checks`` (the four-rank world
then fills a cache on (1, 4)); the JAX references are
jitted in this process while the ranks run, so the ranks import only torch
and the port."""
import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
BATCH, PROMPT, DECODE, MAX_LEN = 2, 32, 12, 80
ARCHS = {"1b": ("ssv-nsa-1b", {}), "8b": ("ssv-nsa-8b", {"d_model": 512})}
MESHES = [(2, 1), (1, 2), (2, 2)]
JOBS = [f"{a}-{d}x{m}" for a in ARCHS for d, m in MESHES]


def _jobs(world, tmp):
    out = []
    for a in ARCHS:
        for d, m in MESHES:
            if d * m == world:
                out.append(dict(name=f"{a}-{d}x{m}", cfg=torch.load(tmp / f"cfg_{a}.pt",
                                                                       weights_only=False),
                                mesh=((d, m), ("data", "model")), case=str(tmp / f"case_{a}.pt"),
                                max_len=MAX_LEN, ref=str(tmp / f"ref_{a}.pt"), tol=(RTOL, ATOL),
                                out=str(tmp / "logits")))
    return out


def _rank(rank, world, dev, tmp, out_dir):
    import torch.distributed as dist
    from repro_torch.launch import serve_checks
    res = serve_checks.run_jobs(_jobs(world, Path(tmp)), dev)
    dist.barrier()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    if world == 4:
        _fill(rank, dev, out_dir)


def _port_caches(jcaches, cfg):
    """The JAX caches' stacked segments as the port's per-layer list."""
    import jax
    from repro_torch.models.model import segments
    out = []
    for (kinds, n), seg in zip(segments(cfg), jcaches["segments"]):
        for g in range(n):
            for j in range(len(kinds)):
                out.append(jax.tree.map(lambda a: torch.from_numpy(np.array(a[g])), seg[j]))
    return {"layers": out}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references in this process; one spawned run per world."""
    import jax
    from repro import configs as jcfg
    from repro.models import model as jmodel
    from repro_torch import configs
    from repro_torch.bridge import from_jax
    from repro_torch.launch import ranks
    tmp = tmp_path_factory.mktemp("sharded_serve")
    prefill = jax.jit(jmodel.prefill, static_argnums=(1, 3))
    decode = jax.jit(jmodel.decode_step, static_argnums=1)
    t = lambda x: torch.from_numpy(np.array(x))
    cases = {}
    for i, (a, (arch, kw)) in enumerate(ARCHS.items()):
        jc, tc = jcfg.reduced(arch, **kw), configs.reduced(arch, **kw)
        p = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(10 + i), jc)
        toks = jax.random.randint(jax.random.PRNGKey(20 + i), (BATCH, PROMPT), 0, jc.vocab_size)
        dec = jax.random.randint(jax.random.PRNGKey(30 + i), (BATCH, DECODE), 0, jc.vocab_size)
        torch.save(tc, tmp / f"cfg_{a}.pt")
        torch.save({"params": from_jax(jax.tree.map(np.asarray, p), tc, "cpu"),
                    "tokens": t(toks).long(), "decode": t(dec).long()}, tmp / f"case_{a}.pt")
        cases[a] = (jc, tc, p, toks, dec)

    def world_run(world):
        d = tmp / f"world{world}"
        d.mkdir()
        ranks.spawn(_rank, world, "gloo", "cpu", args=(str(tmp), str(d)), timeout=240,
                    threads=1, store_dir=str(d))
        return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]

    # the two worlds side by side, started before the references: each rank
    # reads its reference once it exists
    with ThreadPoolExecutor(2) as pool:
        worlds = [pool.submit(world_run, w) for w in (2, 4)]
        refs = {}
        for a, (jc, tc, p, toks, dec) in cases.items():
            hidden, caches = prefill(p, jc, toks, MAX_LEN)
            ref = {"prefill_logits": t(jmodel.logits_fn(p, jc, hidden[:, -1:])),
                   "prefill_caches": _port_caches(caches, tc)}
            steps = []
            for s in range(DECODE):
                lg, caches = decode(p, jc, caches, dec[:, s:s + 1])
                steps.append(t(lg))
            ref.update(decode_logits=torch.stack(steps), caches=_port_caches(caches, tc))
            torch.save(ref, tmp / f"ref_{a}.part")
            (tmp / f"ref_{a}.part").rename(tmp / f"ref_{a}.pt")
            refs[a] = ref
        out = {}
        for w in worlds:
            for jobs in w.result():
                for job in jobs:
                    out.setdefault(job["name"], []).append(job)
    return {"refs": refs, "jobs": out, "tmp": tmp}


def _whole_logits(runs, name):
    from repro_torch.launch import serve_checks
    d, m = map(int, name.split("-")[1].split("x"))
    return serve_checks.assemble(runs["tmp"] / "logits", name, d * m)


# ---------------------------------------------------------------- equal to JAX
@pytest.mark.parametrize("name", JOBS)
def test_sharded_prefill_equals_jax_prefill(runs, name):
    """Every rank's vocab slice of the last position's logits within rtol
    2e-4 / atol 2e-5 of the JAX ``prefill_step``'s; the assembled logits'
    argmax equal."""
    jobs = runs["jobs"][name]
    assert all(j["held"]["prefill_logits"] for j in jobs), [j["max_abs_err"] for j in jobs]
    whole = _whole_logits(runs, name)["prefill"]
    want = runs["refs"][name.split("-")[0]]["prefill_logits"]
    torch.testing.assert_close(whole, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(whole.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", JOBS)
def test_cache_slices_are_local_blocks_of_the_jax_caches(runs, name):
    """After the prefill, every rank's K/V rows and compressed blocks equal
    ``local_block`` of the JAX caches under ``cache_specs(shard_sequence=
    False)`` (rows over data, sequence over model)."""
    for j in runs["jobs"][name]:
        assert j["held"]["prefill_caches"], j["max_abs_err"]
        d, m = j["mesh"]
        rows = BATCH // d
        assert j["rows"] == [j["coords"]["data"] * rows, (j["coords"]["data"] + 1) * rows]
        assert j["kv_rows"] == [j["coords"]["model"] * MAX_LEN // m,
                                (j["coords"]["model"] + 1) * MAX_LEN // m]


@pytest.mark.parametrize("name", JOBS)
def test_sharded_decode_equals_jax_decode_steps(runs, name):
    """The prefill and 12 sharded decode tokens: each token's logits and
    the caches after the last equal the JAX ``prefill`` + 12
    ``decode_step``s (the compressed blocks the tokens complete included);
    each token's argmax equal."""
    jobs = runs["jobs"][name]
    for j in jobs:
        assert j["held"]["decode_logits"] and j["held"]["caches"], j["max_abs_err"]
    whole = _whole_logits(runs, name)["decode"]
    want = runs["refs"][name.split("-")[0]]["decode_logits"]
    torch.testing.assert_close(whole, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(whole.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", [n for n in JOBS if not n.endswith("x1")])
def test_a_compressed_block_is_written_across_the_model_boundary(runs, name):
    """Blocks 7, 8 and 9 complete during the decode (rows 28-35, 32-39,
    36-43); the model rank 0 owns them (blocks 0-11 of the 24 padded ones)
    and writes them, block 9 with rows 40-43 from model rank 1; model rank
    1 writes none. The caches after the decode equal JAX's (the test
    above)."""
    for j in runs["jobs"][name]:
        if j["coords"]["model"] == 0:
            assert j["written_blocks"] == [7, 8, 9] and j["across_boundary"] == [9], j
            assert j["cmp_rows"] == [0, 12] and j["kv_rows"] == [0, 40]
        else:
            assert j["written_blocks"] == [] and j["across_boundary"] == []


@pytest.mark.parametrize("name", JOBS)
def test_collectives_of_the_serve_path(runs, name):
    """A prefill: 2 activation collectives per layer (the K/V and the
    compressed slices all-gathered over ``model``) and 2 more (the
    embedding's reduce-scatter, the last hidden state's all-reduce); a
    decode token: 5 all-reduces per layer (the attention's) and the
    embedding's, and one more a layer on the token that completes block 9,
    whose rows straddle the ``model`` boundary. Each layer's leaves that the
    mesh splits are gathered once a pass, their whole bytes counted; a rank
    holds only its blocks."""
    from repro_torch.bridge import init_params
    from repro_torch.launch import sharding
    from repro_torch.config import MeshConfig
    cfg = torch.load(runs["tmp"] / f"cfg_{name.split('-')[0]}.pt", weights_only=False)
    d, m = map(int, name.split("-")[1].split("x"))
    mc = MeshConfig((d, m), ("data", "model"))
    sizes = dict(zip(mc.axes, mc.shape))
    meta = init_params(cfg, torch.Generator(), "meta")
    specs = sharding.flatten(sharding.param_specs(meta, mc))
    gathers = nbytes = resident = 0
    for key, t in sharding.flatten(meta).items():
        resident += math.prod(sharding.local_shape(t.shape, specs[key], sizes)) * t.element_size()
        if key.startswith("layers/") and math.prod(
                sizes[a] for a in sharding.split_axes(specs[key], mc.axes)) > 1:
            gathers += 1
            nbytes += t.numel() * t.element_size()
    L = cfg.num_layers
    for j in runs["jobs"][name]:
        assert j["prefill"]["collectives"] == 2 * L + 2
        # blocks 7 and 8 lie on model rank 0 with their rows: no collective
        assert j["decode"]["collectives_per_token"] == ([5 * L + 1] if m == 1 else
                                                        [5 * L + 1, 6 * L + 1])
        assert (j["prefill"]["gathers"], j["prefill"]["gathered_bytes"]) == (gathers, nbytes)
        assert (j["decode"]["gathers_per_token"], j["decode"]["gathered_bytes_per_token"]) == \
            ([gathers], [nbytes])
        assert j["resident_weight_bytes"] == resident


# ---------------------------------------------------------------- the dry run
@pytest.mark.parametrize("world,model", [(4, 2), (2, 2)])
def test_serve_rank_bytes_split_the_cell(world, model):
    """Per rank, the split leaves' bytes x ``world`` plus the others' whole
    bytes are one card's (the target's weights and cache) for every arch's
    prefill and batched decode cell."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, specs
    for arch in configs.ARCH_IDS:
        for shape in ("prefill_32k", "decode_32k"):
            r = dryrun.serve_rank_bytes(arch, shape, world, model)
            cfg = specs.cell_config(arch, shape)[0]
            one = specs.config_bytes(cfg, specs.SHAPE_BY_NAME[shape],
                                     specs.SHAPE_BY_NAME[shape].global_batch)
            assert r["split"] * world + r["partial_whole"] == r["one_card"] == \
                one["weights"] + one["target_cache"], (arch, shape)
            assert r["total"] == r["split"] + r["partial"] == r["weights"] + r["cache"]
            assert r["mesh"] == [world // model, model]


def test_list_world_gives_the_serve_cells_four_cards(capsys):
    """``--list --world 4 --model 2``: ssv-nsa-8b x prefill_32k at batch 32
    (166.41 GB on one card) and ssv-nsa-1b x decode_32k at batch 128
    (152.14 GB) fit four cards on a (2, 2) mesh (42.14 and 38.10 GB a
    rank) and not one."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.launch import dryrun
    assert dryrun.main(["--list", "--world", "4", "--model", "2",
                        "--shape", "prefill_32k,decode_32k"]) == 0
    out = capsys.readouterr().out
    for arch, shape, one, rank in (("ssv-nsa-8b", "prefill_32k", 166.41, 42.14),
                                   ("ssv-nsa-1b", "decode_32k", 152.14, 38.10)):
        r = dryrun.serve_rank_bytes(arch, shape, 4, 2)
        assert r["divides"] and r["mesh"] == [2, 2] and r["sharded_serve"]
        assert round(r["one_card"] / 1e9, 2) == one and round(r["total"] / 1e9, 2) == rank
        assert r["one_card"] > rl.HBM_PER_CARD >= r["total"]
        row = [ln for ln in out.splitlines() if ln.startswith(arch + " ") and shape in ln][-1]
        assert row.split()[-3:] == ["no", "yes", "yes"], row
    gained = next(ln for ln in out.splitlines() if ln.startswith("prefill and batched decode"))
    assert "ssv-nsa-8b x prefill_32k (batch 32)" in gained
    assert "ssv-nsa-1b x decode_32k (batch 128)" in gained


def test_run_on_a_prefill_cell_raises_without_a_card(tmp_path, monkeypatch):
    from repro_torch.launch import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "ssv-nsa-1b", "--shape", "prefill_32k", "--run",
                     "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "ssv-nsa-8b", "--shape", "prefill_32k", "--run", "--world", "4",
                     "--model", "2", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CPU mode"):
        dryrun.measure_prefill("ssv-nsa-1b", "prefill_32k", 1, device="cpu")
    assert not (tmp_path / "run").exists()


def test_run_serve_sharded_decode_on_cpu_ranks_equals_decode_step(tmp_path):
    """``run_serve_sharded`` (``--run --world N --model M``'s path for a
    batched decode cell) on two gloo ranks on the CPU, (1, 2), reduced
    ssv-nsa-1b at 32,768 tokens and batch 2: each rank fills only its
    slice and gathers its weights, yet every rank's vocab slice of the
    token's logits equals ``decode_step`` on the whole fill of the whole
    weights drawn as ``ServeWeights.init`` draws them; 5 all-reduces per
    layer and 1 (the token completes no compressed block)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import model
    from repro_torch.runtime.sharded import _layer_init
    cfg = configs.reduced("ssv-nsa-1b")
    recs = dryrun.run_serve_sharded("ssv-nsa-1b", "decode_32k", 2, "gloo", tmp_path,
                                    model_axis=2, batch=2, cfg=cfg, device_type="cpu",
                                    timeout=240, threads=1)
    assert [r["kv_rows"] for r in recs] == [[0, 16640], [16640, 33280]]
    assert all(r["collectives_per_token"] == 5 * cfg.num_layers + 1 for r in recs)
    assert all(r["reduced"] == {"global_batch": 2, "of": 128, "why": "--batch"} for r in recs)
    # the whole weights the ranks cut their blocks from, one layer at a time
    top, first = _layer_init(cfg, 0, 0, "cpu")
    params = dict(top, layers=[first, _layer_init(cfg, 0, 1, "cpu")[1]])
    caches = model.init_caches(cfg, 2, 32768 + 512, "cpu")
    dryrun.fill_caches(params, cfg, caches, 32768, 0)
    token = torch.randint(0, cfg.vocab_size, (2, 1), generator=torch.Generator().manual_seed(1))
    want, _ = model.decode_step(params, cfg, caches, token)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        v0, v1 = got["vocab"]
        torch.testing.assert_close(got["logits"], want[:, :, v0:v1], rtol=RTOL, atol=ATOL)


def test_fill_caches_seeds_each_batch_row():
    """Rows 1-2 of a 3-row fill, filled alone (``global_rows["batch"]``),
    equal the same rows of the whole fill (K/V and compressed blocks); row
    0 of the whole fill equals a 1-row fill (its seed is the per-chunk
    seed of before)."""
    from repro_torch import configs
    from repro_torch.bridge import init_params
    from repro_torch.launch import dryrun
    from repro_torch.models import model
    cfg = configs.reduced("ssv-nsa-1b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fill = lambda B, rows=None: _filled(dryrun, model, cfg, params, B, rows)
    whole, one, part = fill(3), fill(1), fill(2, (1, 3))
    for w, o, p in zip(whole["layers"], one["layers"], part["layers"]):
        for part_name in w:
            for name, t in w[part_name].items():
                assert torch.equal(t[:1], o[part_name][name])
                assert torch.equal(t[1:], p[part_name][name])
        assert not torch.equal(w["kv"]["k"][0], w["kv"]["k"][1])


FILL_MAX_LEN, FILL_SEQ = 128, 60        # on (1, 4): model ranks 2 and 3 hold no filled row


def _fill(rank, dev, out_dir):
    """``fill_caches`` on this rank's ``ServeWeights`` and cache slices on
    (1, 4) (the fixture's four-rank world runs it after its jobs)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.models import nsa_sharded
    from repro_torch.runtime.sharded import ServeWeights
    cfg = configs.reduced("ssv-nsa-1b")
    mesh = mesh_lib.make_mesh((1, 4), ("data", "model"), "cpu")
    view = ServeWeights.init(cfg, 0, mesh, dev)
    caches = nsa_sharded.init_local_caches(cfg, 2, FILL_MAX_LEN, mesh, ("model",), dev,
                                           shard_sequence=False)
    view.layout.reset_counts()
    dryrun.fill_caches(view, cfg, caches, FILL_SEQ, 0)
    torch.save({"caches": caches, "gathers": view.layout.counts["gathers"]},
               Path(out_dir) / f"fill_rank{rank}.pt")


def test_fill_caches_gathers_on_ranks_whose_slice_is_empty(runs):
    """``fill_caches`` on ``ServeWeights`` across four gloo ranks on (1, 4),
    reduced ssv-nsa-1b filled to 60 of 128 tokens: model ranks 2 and 3
    hold no filled K/V row and no filled compressed block, yet they join
    every layer's gather of the compressed branch's weights (the ranks
    that fill would otherwise wait in it). Every rank's slices equal
    ``local_block`` of the whole fill of the whole weights."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import model
    from repro_torch.runtime.sharded import _layer_init
    cfg = configs.reduced("ssv-nsa-1b")
    got = [torch.load(runs["tmp"] / "world4" / f"fill_rank{r}.pt", weights_only=False)
           for r in range(4)]
    top, first = _layer_init(cfg, 0, 0, "cpu")
    params = dict(top, layers=[first] + [_layer_init(cfg, 0, i, "cpu")[1]
                                         for i in range(1, cfg.num_layers)])
    whole = model.init_caches(cfg, 2, FILL_MAX_LEN, "cpu")
    dryrun.fill_caches(params, cfg, whole, FILL_SEQ, 0)
    ncb = whole["layers"][0]["cmp"]["k_cmp"].shape[1]
    assert [g["caches"]["global_rows"]["cmp"][0] for g in got][2:] == [16, 24]
    assert 16 >= (FILL_SEQ - cfg.nsa.cmp_block) // cfg.nsa.cmp_stride + 1 and ncb == 32
    assert len({g["gathers"] for g in got}) == 1 and got[0]["gathers"] > 0
    for g in got:
        rows = g["caches"]["global_rows"]
        for w, c in zip(whole["layers"], g["caches"]["layers"]):
            for part, name, (a, b) in (("kv", "k", rows["kv"]), ("kv", "v", rows["kv"]),
                                       ("cmp", "k_cmp", rows["cmp"]),
                                       ("cmp", "v_cmp", rows["cmp"])):
                assert torch.equal(c[part][name], w[part][name][:, a:b]), (rows, part, name)


def _filled(dryrun, model, cfg, params, B, rows):
    caches = model.init_caches(cfg, B, 300, "cpu")
    if rows is not None:
        caches["global_rows"] = {"kv": (0, 300), "cmp": (0, caches["layers"][0]["cmp"]
                                                         ["k_cmp"].shape[1]), "batch": rows}
    dryrun.fill_caches(params, cfg, caches, 250, seed=0)
    return caches


# ---------------------------------------------------------------- the pieces
def test_plain_reference_decode_equals_the_kernel_route():
    """``serve_checks.reference(plain_decode=True)``: the decode run again
    from the same prefill with ``model``'s NSA layers on ``nsa.
    nsa_verify_ref`` (the plain oracle the card's phase 14(b) holds the
    sharded bf16 decode to) equals the decode through the kernels' route
    (here their plain versions), logits and caches, rtol 2e-4 / atol 2e-5;
    the kernels' route is back once the context ends."""
    from repro_torch import configs
    from repro_torch.bridge import init_params
    from repro_torch.launch import serve_checks
    from repro_torch.models import model
    cfg = dataclasses.replace(configs.reduced("ssv-nsa-1b"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g)
    decode = torch.randint(0, cfg.vocab_size, (BATCH, DECODE), generator=g)
    kernel = model.nsa_ops.nsa_verify_kernel_layer
    ref = serve_checks.reference(params, cfg, tokens, decode, MAX_LEN, plain_decode=True)
    assert model.nsa_ops.nsa_verify_kernel_layer is kernel
    torch.testing.assert_close(ref["plain_decode_logits"], ref["decode_logits"], rtol=RTOL,
                               atol=ATOL)
    for p, k in zip(ref["plain_caches"]["layers"], ref["caches"]["layers"]):
        for part in k:
            for name in k[part]:
                torch.testing.assert_close(p[part][name], k[part][name], rtol=RTOL, atol=ATOL)
    assert torch.equal(ref["plain_caches"]["length"], ref["caches"]["length"])


def test_attend_queries_slices_give_the_rows_of_attend_train_nsa():
    """``attend_queries`` over query slices that cut the 512-query chunks
    anywhere equals ``attend_train_nsa``'s gated heads on those rows, over
    the whole K/V and compressed blocks."""
    from repro_torch import configs
    from repro_torch.bridge import init_params
    from repro_torch.models import nsa
    from repro_torch.models.attention import qkv
    cfg = dataclasses.replace(configs.reduced("ssv-nsa-1b"), d_model=64, num_heads=4,
                              num_kv_heads=2, head_dim=16)
    mix = init_params(cfg, torch.Generator().manual_seed(0), "cpu")["layers"][0]["mix"]
    S = 1024
    x = torch.randn(1, S, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(S, dtype=torch.int32)[None]
    out, (k, v) = nsa.attend_train_nsa(mix, cfg, x, pos)
    q, _, _ = qkv(mix, cfg, x, pos)
    g = nsa.gates(mix, x, cfg.num_heads)
    kc, vc = nsa.compress_kv(mix, k, v, cfg.nsa)
    assert nsa.query_chunks(S, 300, 700) == [(300, 512), (512, 700)]
    parts = [nsa.attend_queries(cfg, q[:, a:b], g[:, a:b], pos[:, a:b], k, v, kc, vc, q0=a)
             for a, b in ((0, 300), (300, 700), (700, S))]
    torch.testing.assert_close(torch.cat(parts, 1) @ mix["wo"], out, rtol=RTOL, atol=ATOL)


def test_noise_for_differs_between_leaves_and_steps():
    """On the CPU (whose generator keeps a seed's low 32 bits) two leaves of
    one step draw different noise, one leaf at two steps too, and a draw
    repeats."""
    from repro_torch.optim.compress import noise_for, noise_seed
    x = torch.zeros(64)
    draws = {(i, s): noise_for(x, i, s) for i in range(4) for s in range(3)}
    keys = list(draws)
    for a in range(len(keys)):
        for b in range(a + 1, len(keys)):
            assert not torch.equal(draws[keys[a]], draws[keys[b]]), (keys[a], keys[b])
    assert torch.equal(noise_for(x, 2, 1), draws[(2, 1)])
    assert len({noise_seed(i, s) & 0xFFFFFFFF for i in range(64) for s in range(64)}) == 64 * 64
    assert all(0 <= noise_seed(i, s) < 2 ** 63 for i in range(8) for s in range(8))
