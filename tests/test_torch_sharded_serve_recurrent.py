"""The dry run's serve cells across ranks for the recurrent archs
(``models.prefill_sharded`` with ``models.recurrent_sharded`` passing the
RG-LRU, mLSTM and sLSTM states along the ``model`` ranks;
``nsa_sharded.decode_step_sharded`` stepping them on each rank's rows) on
gloo ranks on the CPU, against the JAX package:

  * reduced recurrentgemma-9b (two (rglru, rglru, attn) periods, window
    64) and reduced xlstm-125m (two (mlstm, slstm) periods) on the (data,
    model) meshes (2, 1), (1, 2) and (2, 2); float32, 2 rows of 128
    positions, ``max_len`` 160, 12 decode tokens: the sharded prefill
    equals the JAX ``model.prefill`` (the last position's logits, a vocab
    slice per ``model`` rank; every rank's states and K/V slices ==
    ``local_block`` of the JAX caches under ``cache_specs(shard_sequence=
    False)``) and the 12 sharded decode tokens the JAX ``decode_step``s
    (each token's logits and the caches after the last), rtol 2e-4 / atol
    2e-5, argmax equal; the RG-LRU's carry and conv window cross the
    ``model`` cut at position 64 and every decode token's window straddles
    the cache's cut at row 80;
  * the batch-1 ``long_500k``-style decode on (2, 2) with the sequence
    over every axis and the states whole on every rank, whole weights, from
    the JAX prefill's caches: 12 tokens == the JAX ``decode_step``s;
  * the sLSTM relay on two model ranks with 1 and 2 row groups == the JAX
    ``_xlstm_prefill`` of the whole sequence (the rank's outputs and the
    final state on every rank), g + m - 1 all-gathers;
  * the collectives: a prefill 1 a layer (2 an sLSTM on two model ranks)
    and 2 more; a decode token 2 an attention layer, 0 a recurrent one and
    1 more; the weights' gathers of every split leaf;
  * ``dryrun`` takes the recurrent archs' ``long_500k`` cells into the
    batch-1 sharded decode (``test_torch_sharded_serve_native.py`` shows
    that ``--run --world`` no longer skips their serve cells);
  * ``dryrun.run_serve_sharded(trace=True)`` (``--trace``) on xlstm's
    ``prefill_32k`` cell cut to two layers: a line per rank and layer with
    the collectives and gathers so far.

Each world is one spawned run (``launch.ranks.spawn``, a ``FileStore`` in
``tmp_path``, one thread per rank, its own timeout; the two worlds side by
side) that runs its jobs; the JAX references are jitted in this process
while the ranks run, so the ranks import only torch and the port."""
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
POSITIONS, DECODE, MAX_LEN = 128, 12, 160
ARCHS = {"rg": "recurrentgemma-9b", "xl": "xlstm-125m"}
MESHES = [(2, 1), (1, 2), (2, 2)]
JOBS = [f"{a}-{d}x{m}" for a in ARCHS for d, m in MESHES]
RELAY_ROWS, RELAY_S = 2, 64


def _mesh(name):
    return tuple(map(int, name.split("-")[1].split("x")))


def _cfg_of(tmp, a):
    return torch.load(Path(tmp) / f"cfg_{a}.pt", weights_only=False)


def _jobs(world, tmp):
    out = []
    for name in JOBS:
        d, m = _mesh(name)
        a = name.split("-")[0]
        if d * m == world:
            out.append(dict(name=name, cfg=_cfg_of(tmp, a), mesh=((d, m), ("data", "model")),
                            case=str(tmp / f"case_{a}.pt"), max_len=MAX_LEN,
                            ref=str(tmp / f"ref_{a}.pt"), tol=(RTOL, ATOL),
                            out=str(tmp / "logits")))
    return out


def _batch1(a, tmp, dev):
    """The batch-1 decode on (2, 2), the sequence over both axes: this
    rank's slices cut from the JAX prefill's caches, then 12 tokens."""
    from repro_torch.launch import mesh as mesh_lib, serve_checks, sharding
    from repro_torch.models import nsa_sharded
    cfg = _cfg_of(tmp, a)
    case = torch.load(tmp / f"case_{a}.pt", weights_only=False)
    ref = torch.load(serve_checks._when_written(tmp / f"ref1_{a}.pt"), weights_only=False)
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), dev.type)
    axes = ("data", "model")
    shape, coords = mesh_lib.mesh_shape(mesh), mesh_lib.mesh_coords(mesh)
    caches = nsa_sharded.init_local_caches(cfg, 1, MAX_LEN, mesh, axes, dev)
    whole = {"layers": ref["prefill_caches"]["layers"]}
    specs = sharding.cache_specs(whole, mesh, shard_sequence=True)
    for got, want, sp in zip(caches["layers"], whole["layers"], specs["layers"]):
        for part in want:
            for n, w in want[part].items():
                got[part][n].copy_(sharding.local_block(w, sp[part][n], shape, coords))
    caches["length"].fill_(POSITIONS)
    steps, counts = [], []
    for t in range(DECODE):
        nsa_sharded.reset_collectives()
        lg, caches = nsa_sharded.decode_step_sharded(case["params"], cfg, mesh, caches,
                                                     case["decode"][:1, t:t + 1], axes)
        counts.append(nsa_sharded.collectives())
        steps.append(lg)
    ok, err = serve_checks._cache_err(caches, ref["caches"], mesh, RTOL, ATOL,
                                      shard_sequence=True)
    return {"logits": torch.stack(steps), "collectives": counts, "caches_ok": ok,
            "caches_err": err, "kv_rows": list(caches["global_rows"]["kv"]),
            "states": [c["state"] for c in caches["layers"] if "state" in c]}


def _relay(tmp, dev):
    """The sLSTM relay on (1, 2) with 1 and 2 row groups."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import nsa_sharded, recurrent, recurrent_sharded
    cfg = _cfg_of(tmp, "xl")
    case = torch.load(tmp / "relay.pt", weights_only=False)
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"), dev.type)
    group, idx, m = nsa_sharded.shard_of(mesh, ("model",))
    Sl = RELAY_S // m
    out = {}
    for g in (1, 2):
        nsa_sharded.reset_collectives()
        y, st = recurrent_sharded.slstm_prefill_sharded(
            case["params"], cfg, case["x"][:, idx * Sl:(idx + 1) * Sl],
            recurrent.slstm_init_state(cfg, RELAY_ROWS), group, idx, m, row_groups=g)
        out[g] = {"out": y, "state": st, "collectives": nsa_sharded.collectives(),
                  "cols": (idx * Sl, (idx + 1) * Sl)}
    return out


def _rank(rank, world, dev, tmp, out_dir):
    import torch.distributed as dist
    from repro_torch.launch import serve_checks
    tmp = Path(tmp)
    res = {"serve": serve_checks.run_jobs(_jobs(world, tmp), dev)}
    if world == 4:
        res["batch1"] = {a: _batch1(a, tmp, dev) for a in ARCHS}
    else:
        res["relay"] = _relay(tmp, dev)
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
    from repro.models import model as jmodel, recurrent as jrec
    from repro_torch import configs
    from repro_torch.bridge import from_jax
    from repro_torch.launch import ranks
    tmp = tmp_path_factory.mktemp("sharded_serve_recurrent")
    prefill = jax.jit(jmodel.prefill, static_argnums=(1, 3))
    decode = jax.jit(jmodel.decode_step, static_argnums=1)
    t = lambda x: torch.from_numpy(np.array(x))
    cases = {}
    for i, (a, arch) in enumerate(ARCHS.items()):
        jc, tc = jcfg.reduced(arch), configs.reduced(arch)
        p = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(50 + i), jc)
        toks = jax.random.randint(jax.random.PRNGKey(60 + i), (2, POSITIONS), 0, jc.vocab_size)
        dec = jax.random.randint(jax.random.PRNGKey(70 + i), (2, DECODE), 0, jc.vocab_size)
        torch.save(tc, tmp / f"cfg_{a}.pt")
        torch.save({"params": from_jax(jax.tree.map(np.asarray, p), tc, "cpu"),
                    "tokens": t(toks).long(), "decode": t(dec).long()}, tmp / f"case_{a}.pt")
        cases[a] = (jc, tc, p, toks, dec)
    jc = jcfg.reduced("xlstm-125m")
    jp = jrec.INITS["slstm"](jax.random.PRNGKey(80), jc)
    x = jax.random.normal(jax.random.PRNGKey(81), (RELAY_ROWS, RELAY_S, jc.d_model))
    relay_out, relay_state = jmodel._xlstm_prefill("slstm", jp, jc, x)
    torch.save({"params": {k: t(v) for k, v in jp.items()}, "x": t(x)}, tmp / "relay.pt")

    def world_run(world):
        d = tmp / f"world{world}"
        d.mkdir()
        ranks.spawn(_rank, world, "gloo", "cpu", args=(str(tmp), str(d)), timeout=240,
                    threads=1, store_dir=str(d))
        return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]

    def chain(p, jc, tc, toks, dec):
        hidden, caches = prefill(p, jc, toks, MAX_LEN, None)
        ref = {"prefill_logits": t(jmodel.logits_fn(p, jc, hidden[:, -1:])),
               "prefill_caches": _port_caches(caches, tc)}
        steps = []
        for s in range(DECODE):
            lg, caches = decode(p, jc, caches, dec[:, s:s + 1])
            steps.append(t(lg))
        ref.update(decode_logits=torch.stack(steps), caches=_port_caches(caches, tc))
        return ref

    def publish(ref, name):
        torch.save(ref, tmp / f"{name}.part")
        (tmp / f"{name}.part").rename(tmp / f"{name}.pt")

    # the two worlds side by side, started before the references: each rank
    # reads its reference once it exists
    with ThreadPoolExecutor(2) as pool:
        worlds = [pool.submit(world_run, w) for w in (2, 4)]
        refs, refs1 = {}, {}
        for a, (jc, tc, p, toks, dec) in cases.items():
            refs[a] = chain(p, jc, tc, toks, dec)
            publish(refs[a], f"ref_{a}")
        for a, (jc, tc, p, toks, dec) in cases.items():
            refs1[a] = chain(p, jc, tc, toks[:1], dec[:1])
            publish(refs1[a], f"ref1_{a}")
        got = {w: f.result() for w, f in zip((2, 4), worlds)}
    out = {}
    for ranks_of in got.values():
        for r in ranks_of:
            for job in r["serve"]:
                out.setdefault(job["name"], []).append(job)
    return {"refs": refs, "refs1": refs1, "jobs": out, "tmp": tmp, "worlds": got,
            "relay": (t(relay_out), {k: t(v) for k, v in relay_state.items()})}


# ---------------------------------------------------------------- equal to JAX
@pytest.mark.parametrize("name", JOBS)
def test_sharded_prefill_equals_jax_prefill(runs, name):
    """Every rank's vocab slice of the last position's logits, its states
    and its K/V slices (``local_block`` of the JAX caches) within rtol 2e-4
    / atol 2e-5 of the JAX ``prefill``'s; the assembled logits' argmax
    equal."""
    from repro_torch.launch import serve_checks
    for j in runs["jobs"][name]:
        assert j["held"]["prefill_logits"] and j["held"]["prefill_caches"], j["max_abs_err"]
    d, m = _mesh(name)
    whole = serve_checks.assemble(runs["tmp"] / "logits", name, d * m)["prefill"]
    want = runs["refs"][name.split("-")[0]]["prefill_logits"]
    torch.testing.assert_close(whole, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(whole.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", JOBS)
def test_sharded_decode_equals_jax_decode_steps(runs, name):
    """The prefill and 12 sharded decode tokens: each token's logits and
    the caches after the last (states, K/V slices) equal the JAX
    ``prefill`` + 12 ``decode_step``s; each token's argmax equal."""
    from repro_torch.launch import serve_checks
    for j in runs["jobs"][name]:
        assert j["held"]["decode_logits"] and j["held"]["caches"], j["max_abs_err"]
    d, m = _mesh(name)
    whole = serve_checks.assemble(runs["tmp"] / "logits", name, d * m)["decode"]
    want = runs["refs"][name.split("-")[0]]["decode_logits"]
    torch.testing.assert_close(whole, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(whole.argmax(-1), want.argmax(-1))


def test_the_carry_and_the_window_cross_the_model_cut(runs):
    """Reduced recurrentgemma on (1, 2) and (2, 2): model rank 1's chunk
    starts at position 64, so its RG-LRU state and conv window come from
    model rank 0's chunk; every decode token (positions 128-139) sees a
    64-key window that starts below the cache's cut at row 80; and the
    results equal JAX (the tests above)."""
    cfg = _cfg_of(runs["tmp"], "rg")
    assert cfg.attention == "swa" and cfg.window == 64
    assert cfg.layer_kinds()[:3] == ("rglru", "rglru", "attn")
    for name in ("rg-1x2", "rg-2x2"):
        for j in runs["jobs"][name]:
            assert j["ok"], j["max_abs_err"]
            assert j["kv_rows"] == [80 * j["coords"]["model"], 80 * (j["coords"]["model"] + 1)]
    for p in range(POSITIONS, POSITIONS + DECODE):
        assert p - cfg.window + 1 < MAX_LEN // 2 <= p


@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch1_decode_with_the_sequence_over_every_axis(runs, arch):
    """The ``long_500k`` layout at batch 1 on (2, 2): the K/V over all four
    ranks (40 rows each), the states whole on every rank, whole weights;
    from the JAX prefill's caches 12 ``decode_step_sharded`` tokens equal
    the JAX ``decode_step``s (every rank the whole vocabulary) and the
    caches after them; 2 all-reduces an attention layer a token, none for
    a recurrent layer."""
    cfg = _cfg_of(runs["tmp"], arch)
    want = runs["refs1"][arch]["decode_logits"]
    n_attn = cfg.layer_kinds().count("attn")
    for r, res in enumerate(runs["worlds"][4]):
        got = res["batch1"][arch]
        torch.testing.assert_close(got["logits"], want, rtol=RTOL, atol=ATOL)
        assert torch.equal(got["logits"].argmax(-1), want.argmax(-1))
        assert got["caches_ok"], got["caches_err"]
        assert got["kv_rows"] == [40 * r, 40 * (r + 1)]
        assert got["collectives"] == [2 * n_attn] * DECODE


@pytest.mark.parametrize("groups", [1, 2])
def test_slstm_relay_equals_the_jax_scan(runs, groups):
    """The sLSTM relay on two model ranks over ``groups`` row groups: each
    rank's outputs equal its columns of the JAX ``_xlstm_prefill`` of the
    whole 64-step sequence, and both ranks hold its final state; g + m - 1
    all-gathers."""
    want_out, want_state = runs["relay"]
    for res in runs["worlds"][2]:
        got = res["relay"][groups]
        a, b = got["cols"]
        torch.testing.assert_close(got["out"], want_out[:, a:b], rtol=RTOL, atol=ATOL)
        for n, w in want_state.items():
            torch.testing.assert_close(got["state"][n], w, rtol=RTOL, atol=ATOL)
        assert got["collectives"] == groups + 2 - 1


@pytest.mark.parametrize("name", JOBS)
def test_collectives_of_the_recurrent_serve_path(runs, name):
    """A prefill: 1 activation collective an attention, RG-LRU or mLSTM
    layer, g + m - 1 an sLSTM (g = 1), and 2 more; a decode token: 2
    all-reduces an attention layer, none a recurrent one, and 1 for the
    embedding. Each layer's leaves that the mesh splits are gathered once
    a pass."""
    from repro_torch.bridge import init_params
    from repro_torch.config import MeshConfig
    from repro_torch.launch import sharding
    cfg = _cfg_of(runs["tmp"], name.split("-")[0])
    d, m = _mesh(name)
    mc = MeshConfig((d, m), ("data", "model"))
    sizes = dict(zip(mc.axes, mc.shape))
    meta = init_params(cfg, torch.Generator(), "meta")
    specs = sharding.flatten(sharding.param_specs(meta, mc))
    gathers = sum(1 for key in specs if key.startswith("layers/") and math.prod(
        sizes[a] for a in sharding.split_axes(specs[key], mc.axes)) > 1)
    kinds = cfg.layer_kinds()
    prefill = sum(m if k == "slstm" else 1 for k in kinds) + 2
    decode = 2 * kinds.count("attn") + 1
    for j in runs["jobs"][name]:
        assert j["prefill"]["collectives"] == prefill
        assert j["decode"]["collectives_per_token"] == [decode]
        assert j["prefill"]["gathers"] == gathers
        assert j["decode"]["gathers_per_token"] == [gathers]


# ---------------------------------------------------------------- the dry run
def test_long_500k_takes_the_recurrent_archs_natively():
    """``long_500k`` at batch 1 runs natively for the two recurrent archs
    (their own windowed attention and recurrences): ``sharded_decode_ok``
    takes them, and ``rank_bytes`` splits only the windowed K/V over the
    four ranks, the states whole on every rank."""
    from repro_torch.launch import dryrun, specs
    for arch in ("recurrentgemma-9b", "xlstm-125m"):
        cfg = specs.cell_config(arch, "long_500k")[0]
        assert dryrun.sharded_decode_ok(cfg)
        r = dryrun.rank_bytes(arch, "long_500k", 4)
        assert r["sharded_decode"] and r["divides"]
        assert r["cache_replicated"] > 0
        assert (r["cache_split"] > 0) == ("attn" in cfg.layer_kinds())


def test_run_serve_sharded_traces_each_layer_of_the_prefill(tmp_path, capfd):
    """``dryrun --run --world N --trace`` on a prefill cell: reduced
    xlstm-125m cut to one (mlstm, slstm) period at ``prefill_32k``'s 32,768
    positions, batch 1, two gloo ranks on (1, 2). Each rank prints one
    flushed line per layer, in order, with the collectives and weight
    gathers so far: 2 after the mLSTM (the prefill's first and the layer's
    all-gather), 4 after the sLSTM (its relay's 2), and the prefill's last
    collective after them."""
    import dataclasses
    import re
    from repro_torch import configs
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(configs.reduced("xlstm-125m"), num_layers=2)
    recs = dryrun.run_serve_sharded("xlstm-125m", "prefill_32k", 2, "gloo", tmp_path,
                                    model_axis=2, batch=1, cfg=cfg, device_type="cpu",
                                    timeout=240, threads=1, trace=True)
    lines = re.findall(r"\[trace\] \S+ \+\S+s rank (\d) \{[^}]*\} layer (\d+) done: (\d+) "
                       r"activation collectives, (\d+) gathers", capfd.readouterr().out)
    for r, rec in enumerate(recs):
        mine = [tuple(map(int, ln[1:])) for ln in lines if int(ln[0]) == r]
        assert [ln[0] for ln in mine] == [0, 1], mine
        assert [ln[1] for ln in mine] == [2, 4] and rec["collectives"] == 5, (mine, rec)
        assert 0 < mine[0][2] < mine[1][2] <= rec["gathers"], (mine, rec)
        assert rec["logits_finite"]
