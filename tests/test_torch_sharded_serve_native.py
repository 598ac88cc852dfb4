"""The dry run's serve cells across ranks for the native-attention archs
(``models.prefill_sharded`` over dense and sliding-window attention, MoE
and frontends; ``nsa_sharded.decode_step_sharded`` with
``attention_sharded.attend_decode_sharded`` and the MoE decode's gathered
expert ids) on gloo ranks on the CPU, against the JAX package:

  * reduced qwen3-8b and mixtral-8x22b on the (data, model) meshes (2, 1),
    (1, 2) and (2, 2); reduced qwen3-moe-235b-a22b and musicgen-medium
    (16 frontend frames) on (2, 2); reduced granite-20b (one kv head),
    nemotron-4-340b and pixtral-12b (16 frames) on (1, 2); reduced
    smollm-360m on (2, 1); float32, 2 rows (4 for the MoE archs) of 128
    positions (frames included), ``max_len`` 160, 12 decode tokens: the
    sharded prefill equals the JAX ``model.prefill`` (the last position's
    logits, a vocab slice per ``model`` rank; every rank's K/V slices ==
    ``local_block`` of the JAX caches under ``cache_specs(shard_sequence=
    False)``) and the 12 sharded decode tokens the JAX ``decode_step``s
    (each token's logits and the caches after the last), rtol 2e-4 / atol
    2e-5, argmax equal;
  * the cases they guard: a windowed prefill query reaching into the
    previous rank's chunk and every decode token's window straddling the
    ``model`` boundary at row 80 (mixtral, window 64), and the whole
    batch's MoE group dropping assignments that groups cut from each data
    rank's rows would keep (mixtral and qwen3-moe, capacity factor 1.25);
  * the collectives: 1 per layer and 2 more a prefill; 2 per layer and 1
    more a decode token, and 1 more a MoE layer when the rows lie over two
    data ranks; the weights' gathers of every split leaf;
  * a MoE dispatch group that does not divide a rank's chunk raises;
    ``--list --world 4 --model 2`` says "across ranks" for every arch, and
    ``--run`` serves the recurrent ones too
    (``test_torch_sharded_serve_recurrent.py`` holds them to JAX);
  * the two repairs: ``dryrun.cell_frontend`` draws each row from its own
    seed; ``model.prefill`` chunks the queries of a 1,088-position prompt
    (2 x 512 + 64) and equals the JAX ``prefill``, unchunked there.

Each world is one spawned run (``launch.ranks.spawn``, a ``FileStore`` in
``tmp_path``, one thread per rank, its own timeout; the two worlds side by
side) that runs its jobs of ``launch.serve_checks``; the JAX references are
jitted in this process while the ranks run, so the ranks import only torch
and the port."""
import argparse
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
POSITIONS, DECODE, MAX_LEN, FRAMES = 128, 12, 160, 16
ARCHS = {"qwen3": "qwen3-8b", "mixtral": "mixtral-8x22b", "qmoe": "qwen3-moe-235b-a22b",
         "granite": "granite-20b", "nemotron": "nemotron-4-340b", "pixtral": "pixtral-12b",
         "musicgen": "musicgen-medium", "smollm": "smollm-360m"}
MESHES = {"qwen3": [(2, 1), (1, 2), (2, 2)], "mixtral": [(2, 1), (1, 2), (2, 2)],
          "qmoe": [(2, 2)], "granite": [(1, 2)], "nemotron": [(1, 2)], "pixtral": [(1, 2)],
          "musicgen": [(2, 2)], "smollm": [(2, 1)]}
JOBS = [f"{a}-{d}x{m}" for a, meshes in MESHES.items() for d, m in meshes]


def _mesh(name):
    return tuple(map(int, name.split("-")[1].split("x")))


def _jobs(world, tmp):
    out = []
    for name in JOBS:
        d, m = _mesh(name)
        a = name.split("-")[0]
        if d * m == world:
            out.append(dict(name=name, cfg=torch.load(tmp / f"cfg_{a}.pt", weights_only=False),
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
    tmp = tmp_path_factory.mktemp("sharded_serve_native")
    prefill = jax.jit(jmodel.prefill, static_argnums=(1, 3))
    decode = jax.jit(jmodel.decode_step, static_argnums=1)
    t = lambda x: torch.from_numpy(np.array(x))
    cases = {}
    for i, (a, arch) in enumerate(ARCHS.items()):
        jc, tc = jcfg.reduced(arch), configs.reduced(arch)
        B = 4 if tc.moe else 2
        F = FRAMES if tc.frontend_dim else 0
        p = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(10 + i), jc)
        toks = jax.random.randint(jax.random.PRNGKey(20 + i), (B, POSITIONS - F), 0,
                                  jc.vocab_size)
        dec = jax.random.randint(jax.random.PRNGKey(30 + i), (B, DECODE), 0, jc.vocab_size)
        fe = jax.random.normal(jax.random.PRNGKey(40 + i), (B, F, jc.frontend_dim)) if F \
            else None
        torch.save(tc, tmp / f"cfg_{a}.pt")
        torch.save({"params": from_jax(jax.tree.map(np.asarray, p), tc, "cpu"),
                    "tokens": t(toks).long(), "decode": t(dec).long(),
                    "frontend": None if fe is None else t(fe)}, tmp / f"case_{a}.pt")
        cases[a] = (jc, tc, p, toks, dec, fe)

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
        for a, (jc, tc, p, toks, dec, fe) in cases.items():
            hidden, caches = prefill(p, jc, toks, MAX_LEN, fe)
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


def _cfg(runs, name):
    return torch.load(runs["tmp"] / f"cfg_{name.split('-')[0]}.pt", weights_only=False)


# ---------------------------------------------------------------- equal to JAX
@pytest.mark.parametrize("name", JOBS)
def test_sharded_prefill_equals_jax_prefill(runs, name):
    """Every rank's vocab slice of the last position's logits and its K/V
    slices (``local_block`` of the JAX caches) within rtol 2e-4 / atol 2e-5
    of the JAX ``prefill_step``'s (frames in front of the tokens for
    pixtral and musicgen); the assembled logits' argmax equal."""
    from repro_torch.launch import serve_checks
    jobs = runs["jobs"][name]
    for j in jobs:
        assert j["held"]["prefill_logits"] and j["held"]["prefill_caches"], j["max_abs_err"]
        d, m = j["mesh"]
        rows = len(runs["refs"][name.split("-")[0]]["prefill_logits"]) // d
        assert j["rows"] == [j["coords"]["data"] * rows, (j["coords"]["data"] + 1) * rows]
        assert j["kv_rows"] == [j["coords"]["model"] * MAX_LEN // m,
                                (j["coords"]["model"] + 1) * MAX_LEN // m]
    d, m = _mesh(name)
    whole = serve_checks.assemble(runs["tmp"] / "logits", name, d * m)["prefill"]
    want = runs["refs"][name.split("-")[0]]["prefill_logits"]
    torch.testing.assert_close(whole, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(whole.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", JOBS)
def test_sharded_decode_equals_jax_decode_steps(runs, name):
    """The prefill and 12 sharded decode tokens: each token's logits and
    the caches after the last equal the JAX ``prefill`` + 12
    ``decode_step``s; each token's argmax equal."""
    from repro_torch.launch import serve_checks
    for j in runs["jobs"][name]:
        assert j["held"]["decode_logits"] and j["held"]["caches"], j["max_abs_err"]
    d, m = _mesh(name)
    whole = serve_checks.assemble(runs["tmp"] / "logits", name, d * m)["decode"]
    want = runs["refs"][name.split("-")[0]]["decode_logits"]
    torch.testing.assert_close(whole, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(whole.argmax(-1), want.argmax(-1))


def test_the_window_reaches_across_the_model_boundary(runs):
    """Reduced mixtral (window 64): on (1, 2) and (2, 2) model rank 1's
    first prefill query (position 64) sees keys 1-64, 63 of them in model
    rank 0's chunk; every decode token (positions 128-139) sees a window
    that starts below the cache's ``model`` boundary at row 80, so both
    ranks hold part of it; and the results equal JAX (the tests above)."""
    cfg = _cfg(runs, "mixtral")
    assert cfg.attention == "swa" and cfg.window == 64
    for name in ("mixtral-1x2", "mixtral-2x2"):
        for j in runs["jobs"][name]:
            assert j["ok"], j["max_abs_err"]
            if j["coords"]["model"] == 1:
                q0 = POSITIONS // 2
                assert q0 - cfg.window + 1 < q0 and j["kv_rows"] == [80, 160]
        for p in range(POSITIONS, POSITIONS + DECODE):
            assert p - cfg.window + 1 < MAX_LEN // 2 <= p


@pytest.mark.parametrize("name", ["mixtral-2x1", "mixtral-2x2", "qmoe-2x2"])
def test_moe_decode_counts_capacity_over_the_whole_batch(runs, name):
    """With the rows over two data ranks, the whole batch's dispatch group
    (4 tokens a decode step) drops assignments that groups cut from each
    data rank's 2 rows would keep; the sharded decode drops them too and
    equals JAX (the test above), every rank counting the same drops."""
    jobs = runs["jobs"][name]
    drops = [j["decode"]["moe_drops"] for j in jobs]
    print(name, drops)
    assert all(d == drops[0] for d in drops)
    assert drops[0]["whole_only"] > 0 and drops[0]["whole"] > drops[0]["per_rank"]
    assert all(j["ok"] for j in jobs)


@pytest.mark.parametrize("name", JOBS)
def test_collectives_of_the_native_serve_path(runs, name):
    """A prefill: 1 activation collective per layer (the K/V all-gathered
    over ``model``) and 2 more (the embedding's reduce-scatter, the last
    hidden state's all-reduce); a decode token: 2 all-reduces per layer
    (the split-KV merge's MAX and SUM), 1 for the embedding, and 1 more per
    MoE layer (the expert ids' all-gather) when the rows lie over two data
    ranks. Each layer's leaves that the mesh splits (the experts and the
    router too) are gathered once a pass; a rank holds only its blocks,
    the weights' bytes a rank that ``dryrun.serve_rank_bytes`` reckons
    (``frontend_proj`` whole)."""
    from repro_torch.bridge import init_params
    from repro_torch.config import MeshConfig
    from repro_torch.launch import dryrun, sharding
    cfg = _cfg(runs, name)
    d, m = _mesh(name)
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
    moe = L if (cfg.moe and d > 1) else 0
    for j in runs["jobs"][name]:
        assert j["prefill"]["collectives"] == L + 2
        assert j["decode"]["collectives_per_token"] == [2 * L + 1 + moe]
        assert (j["prefill"]["gathers"], j["prefill"]["gathered_bytes"]) == (gathers, nbytes)
        assert (j["decode"]["gathers_per_token"], j["decode"]["gathered_bytes_per_token"]) == \
            ([gathers], [nbytes])
        assert j["resident_weight_bytes"] == resident == \
            dryrun._split_bytes(cfg, mc, "weights", 0, 0)["bytes"]


# ---------------------------------------------------------------- the dry run
def test_a_moe_group_that_does_not_divide_a_chunk_raises():
    """Reduced mixtral (dispatch group 64): a 128-position prompt over 2
    model ranks gives 64 a rank, which the group divides; 96 positions give
    48, which it does not, and the sharded prefill's check raises, naming
    the arch, the prompt and the group."""
    from repro_torch import configs
    from repro_torch.models import prefill_sharded
    cfg = configs.reduced("mixtral-8x22b")
    assert prefill_sharded.moe_group(cfg, 4, 128, 2) == 64
    assert prefill_sharded.moe_group(configs.reduced("qwen3-8b"), 4, 96, 2) == 0
    with pytest.raises(ValueError, match=r"mixtral-8x22b-reduced: a 96-position prompt .* 48 "
                                         r"positions a rank, .* group of 64"):
        prefill_sharded.moe_group(cfg, 2, 96, 2)


def test_list_world_says_which_archs_run_across_ranks(capsys):
    """``--list --world 4 --model 2``: "across ranks" yes for the
    ``prefill_32k`` and ``decode_32k`` cells of every arch (the eight
    attention archs, the two NSA targets, recurrentgemma-9b and
    xlstm-125m); the five dense cells that fit four cards and not one are
    listed."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    assert dryrun.main(["--list", "--world", "4", "--model", "2",
                        "--shape", "prefill_32k,decode_32k"]) == 0
    out = capsys.readouterr().out
    for arch in configs.ARCH_IDS:
        for shape in ("prefill_32k", "decode_32k"):
            row = [ln for ln in out.splitlines() if ln.startswith(arch + " ") and shape in ln][-1]
            assert row.split()[-1] == "yes", row
    gained = next(ln for ln in out.splitlines() if ln.startswith("prefill and batched decode"))
    for cell in ("smollm-360m x decode_32k", "granite-20b x decode_32k",
                 "qwen3-8b x prefill_32k", "musicgen-medium x prefill_32k",
                 "pixtral-12b x prefill_32k"):
        assert cell in gained, gained


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_run_world_skips_the_recurrent_archs(arch, capsys, monkeypatch):
    """Since the recurrent archs' serve cells run across ranks, ``--run
    --world 4 --model 2`` no longer prints ``[SKIP]`` for them: it reckons
    their bytes and spawns the ranks (here a stand-in that records the
    call), and prints their ``[RUN]`` lines."""
    from repro_torch.launch import dryrun
    calls = []

    def fake(a, s, world, backend, out, model_axis, seed, batch, trace):
        calls.append((a, s, world, model_axis))
        kind = "prefill" if s == "prefill_32k" else "decode"
        rec = dict(rank=0, world=world, mesh=[2, 2], backend=backend, device="cuda:0",
                   rows=[0, 1], batch=1, kind=kind, wall_ms=[1.0], collectives=1, gathers=1,
                   gathered_bytes=1, logits_finite=True, collectives_per_token=1,
                   gathers_per_token=1, gathered_bytes_per_token=1, first_wall_ms=1.0)
        return [rec]

    monkeypatch.setattr(dryrun, "run_serve_sharded", fake)
    args = argparse.Namespace(world=4, model=2, batch=0, backend="nccl", out="build/x", seed=0,
                              trace=False)
    for shape in ("prefill_32k", "decode_32k"):
        dryrun._run_world_serve(arch, shape, args, 80 * 2 ** 30, 1)
        line = capsys.readouterr().out.strip()
        assert line.startswith(f"[RUN]  {arch}"), line
    assert calls == [(arch, "prefill_32k", 4, 2), (arch, "decode_32k", 4, 2)]


# ---------------------------------------------------------------- the repairs
def test_cell_frontend_draws_each_row_from_its_own_seed():
    """pixtral-12b's ``prefill_32k`` frames: (rows, 256, 1024) bf16; rows
    2-3 drawn alone equal rows 2-3 of the whole batch, and rows differ; an
    arch without a frontend gets None."""
    from repro_torch.launch import dryrun, specs
    cfg = specs.cell_config("pixtral-12b", "prefill_32k")[0]
    whole = dryrun.cell_frontend(cfg, "pixtral-12b", range(4), 0, "cpu")
    part = dryrun.cell_frontend(cfg, "pixtral-12b", range(2, 4), 0, "cpu")
    assert whole.shape == (4, 256, 1024) and whole.dtype == torch.bfloat16
    assert torch.equal(whole[2:], part) and not torch.equal(whole[0], whole[1])
    assert dryrun.cell_frontend(specs.cell_config("qwen3-8b", "prefill_32k")[0], "qwen3-8b",
                                range(2), 0, "cpu") is None
    assert specs.cell_bytes("pixtral-12b", "prefill_32k", 2)["frontend_input"] == \
        2 * 256 * 1024 * 2
    assert "frontend_input" not in specs.cell_bytes("qwen3-8b", "prefill_32k", 2)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x22b"])
def test_prefill_chunks_queries_on_any_length(arch):
    """``model.prefill`` at 1,088 positions (2 x 512 + 64, which 512 does
    not divide) runs its queries in 512, 512 and 64 (``attention.
    query_runs``): its hidden states equal the JAX ``prefill``'s, which
    builds the whole (S, S) scores there, and its caches the same prefill's
    in one run (``attn_chunk`` 0, the whole scores), within rtol 2e-4 /
    atol 2e-5 (dense, and mixtral's window of 64). The V cache also equals
    JAX's; the K cache passes RoPE at positions up to 1,087, where XLA's
    and PyTorch's float32 sin and cos differ in their last bits whatever
    the chunks (its largest difference from JAX's is printed)."""
    import jax
    from repro import configs as jcfg
    from repro.models import model as jmodel
    from repro_torch import configs
    from repro_torch.bridge import from_jax
    from repro_torch.models import attention, model
    S = 2 * 512 + 64
    assert attention.query_runs(0, S) == [(0, 512), (512, 1024), (1024, S)]
    assert attention.query_runs(300, 700) == [(300, 512), (512, 700)]
    jc, tc = jcfg.reduced(arch, layers=1), configs.reduced(arch, layers=1)
    p = jmodel.init(jax.random.PRNGKey(0), jc)
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, S), 0, jc.vocab_size)
    jh, jcache = jmodel.prefill(p, jc, toks, S + 16)
    params = from_jax(jax.tree.map(np.asarray, p), tc, "cpu")
    tokens = torch.from_numpy(np.array(toks)).long()
    h, caches = model.prefill(params, tc, tokens, S + 16)
    whole, whole_caches = model.prefill(params, tc, tokens, S + 16, attn_chunk=0)
    torch.testing.assert_close(h, torch.from_numpy(np.array(jh)), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(h, whole, rtol=RTOL, atol=ATOL)
    for got, one, want in zip(caches["layers"], whole_caches["layers"],
                              _port_caches(jcache, tc)["layers"]):
        for name in ("k", "v"):
            torch.testing.assert_close(got["kv"][name], one["kv"][name], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got["kv"]["v"], want["kv"]["v"], rtol=RTOL, atol=ATOL)
        print(arch, "K cache against JAX, max abs err",
              float((got["kv"]["k"] - want["kv"]["k"]).abs().max()))
