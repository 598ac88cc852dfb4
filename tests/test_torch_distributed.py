"""The sequence-sharded NSA decode (``models.nsa_sharded``) across gloo
ranks on the CPU, worlds 2 and 4, against the JAX package:

  * ``nsa_attend_decode_sharded`` equals the single-device
    ``nsa_verify_ref`` (T = 1) within rtol 2e-4 / atol 2e-5 at Gq 1, 2 and
    4, with selected indices equal to ``routing`` + ``select_topn``; one
    case is the input (Hq 8 / Hkv 2, head_dim 16, wq x 4, seed 0) on which
    the JAX ``nsa_attend_decode_sharded`` leaves the reference, shown in an
    8-device JAX subprocess;
  * the new K/V row is written only on the rank that owns its position;
  * ``decode_step_sharded`` of reduced ssv-nsa-1b equals the port's
    ``decode_step`` and the JAX ``decode_step``, and of reduced qwen3-moe's
    NSA variant the port's;
  * a shard count that does not divide S raises; the mesh constructors (a
    test mesh, the production mesh's rank count, ``elastic.build_mesh``)
    and ``sharding.placements_of`` on ``DTensor`` against ``local_block``.

Each world is one spawned run (``launch.ranks.spawn``, a ``FileStore`` in
``tmp_path``, one thread per rank, its own timeout) that runs every case;
the JAX references are computed in this process. JAX is imported inside
the fixtures, so the ranks import only torch and the port."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PREFIX, MAX_LEN = 200, 264
# (name, num_heads, num_kv_heads, wq scale, seed)
LAYER_CASES = [("gq1", 4, 4, 1.0, 0), ("gq2", 4, 2, 1.0, 0), ("gq4", 8, 2, 1.0, 1),
               ("gq4-wq4-seed0", 8, 2, 4.0, 0), ("gq4-wq4-seed1", 8, 2, 4.0, 1)]
MODEL_CASES = ["ssv-nsa-1b", "qwen3-moe-235b-a22b"]
JAX_MODEL_CASES = ["ssv-nsa-1b"]        # the MoE arch's decode_step == JAX's: test_torch_zoo
WORLDS = (2, 4)
RTOL, ATOL = 2e-4, 2e-5


def _layer_cfg(hq, hkv, package):
    return package.ModelConfig(
        name="t", num_layers=1, d_model=64, num_heads=hq, num_kv_heads=hkv, head_dim=16,
        d_ff=128, vocab_size=97, dtype="float32", attention="nsa",
        nsa=package.NSAConfig(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4,
                              window=32))


# ---------------------------------------------------------------- the ranks
def _cases_rank(rank, world, dev, in_dir, out_dir):
    """Every case on one rank; results to ``<out_dir>/rank<r>.pt``."""
    import torch.distributed as dist
    from repro_torch.config import MeshConfig
    from repro_torch.launch import mesh as mesh_lib, sharding
    from repro_torch.models import nsa_sharded
    from repro_torch.runtime import elastic
    mesh = mesh_lib.make_test_mesh(2, world // 2, "cpu")
    axes = ("data", "model")
    shp, coords = mesh_lib.mesh_shape(mesh), mesh_lib.mesh_coords(mesh)
    res = {"layers": {}, "models": {}, "errors": {}, "dtensor": []}

    def local(t, sp):
        return sharding.local_block(t, sp, shp, coords).clone()

    kv_spec = sharding.spec(None, ("data", "model"), None, None)
    for name, *_ in LAYER_CASES:
        d = torch.load(Path(in_dir) / f"layer_{name}.pt", weights_only=False)
        kv = {k: local(d[k], kv_spec) for k in ("k", "v")}
        before = {k: t.clone() for k, t in kv.items()}
        cmp = {k: local(d[k], kv_spec) for k in ("k_cmp", "v_cmp")}
        out, kv, _, (si, sv) = nsa_sharded.nsa_attend_decode_sharded(
            d["mix"], d["cfg"], mesh, d["x"], kv, cmp, PREFIX, axes, return_sel=True)
        changed = {k: (kv[k] != before[k]).any(dim=-1).any(dim=-1)[0].nonzero()[:, 0].tolist()
                   for k in kv}
        res["layers"][name] = {"out": out, "sel": si, "valid": sv, "changed": changed,
                               "k": kv["k"], "v": kv["v"],
                               "collectives": nsa_sharded.collectives()}
        nsa_sharded.reset_collectives()
    for arch in MODEL_CASES:
        d = torch.load(Path(in_dir) / f"model_{arch}.pt", weights_only=False)
        specs = sharding.cache_specs(d["caches"], mesh, shard_sequence=True)
        caches = {"layers": [{p: {k: local(t, specs["layers"][i][p][k]) for k, t in c[p].items()}
                              for p in c} for i, c in enumerate(d["caches"]["layers"])],
                  "length": d["caches"]["length"].clone()}
        logits, caches = nsa_sharded.decode_step_sharded(d["params"], d["cfg"], mesh, caches,
                                                         d["token"], axes)
        res["models"][arch] = {"logits": logits, "length": caches["length"]}
    # what raises
    from repro_torch.configs import reduced
    cfg = reduced("ssv-nsa-1b")
    for what, fn in [
            ("indivisible", lambda: nsa_sharded.init_local_caches(cfg, 1, 263, mesh, axes, dev)),
            ("production", lambda: mesh_lib.make_production_mesh(device_type="cpu")),
            ("build_mesh", lambda: elastic.build_mesh(MeshConfig((world, 2)), "cpu"))]:
        try:
            fn()
            res["errors"][what] = None
        except ValueError as e:
            res["errors"][what] = str(e)
    local_caches = nsa_sharded.init_local_caches(cfg, 1, MAX_LEN, mesh, axes, dev)
    res["local_rows"] = local_caches["global_rows"]
    res["local_shape"] = tuple(local_caches["layers"][0]["kv"]["k"].shape)
    # DTensor placements against local_block, on the planned mesh
    from torch.distributed.tensor import distribute_tensor
    planned = elastic.build_mesh(elastic.plan_mesh(world, prefer_model=2), "cpu")
    full = torch.arange(8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 4)
    pshape, pcoords = mesh_lib.mesh_shape(planned), mesh_lib.mesh_coords(planned)
    for sp in [sharding.spec("data", "model"), sharding.spec(None, ("data", "model")),
               sharding.spec("model", None, None), sharding.spec()]:
        dt = distribute_tensor(full, planned, sharding.placements_of(sp, planned))
        res["dtensor"].append(torch.equal(dt.to_local(),
                                          sharding.local_block(full, sp, pshape, pcoords)))
    res["coords"] = coords
    dist.barrier()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


# ---------------------------------------------------------------- the references
def _start_jax_divergence():
    """The 8-device JAX run of ``test_jax_sharded_reference_leaves_nsa_verify_ref``,
    started beside the fixture's work."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    code = textwrap.dedent("""
        import jax, jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.config import ModelConfig, NSAConfig
        from repro.models import model, nsa as nsa_lib, nsa_sharded
        from repro.launch.mesh import make_test_mesh
        nsa = NSAConfig(cmp_block=8, cmp_stride=4, sel_block=16, n_selected=4, window=32)
        mesh = make_test_mesh(4, 2)
        shard = NamedSharding(mesh, P(None, ("data", "model"), None, None))
        for hq, hkv, seed in ((8, 2, 0), (8, 2, 1), (4, 4, 0)):
            cfg = ModelConfig(name="t", num_layers=1, d_model=64, num_heads=hq,
                              num_kv_heads=hkv, head_dim=16, d_ff=128, vocab_size=97,
                              dtype="float32", attention="nsa", nsa=nsa)
            key = jax.random.PRNGKey(seed)
            p = jax.jit(model.init, static_argnums=1)(key, cfg)
            p["segments"][0][0]["mix"]["wq"] = p["segments"][0][0]["mix"]["wq"] * 4.0
            bp = jax.tree.map(lambda a: a[0], p["segments"][0][0])
            toks = jax.random.randint(key, (1, 200), 0, 97)
            _, caches = jax.jit(model.prefill, static_argnums=(1, 3))(p, cfg, toks, 264)
            cache = jax.tree.map(lambda a: a[0], caches["segments"][0][0])
            x = jax.random.normal(key, (1, 1, 64))
            out_ref = jax.jit(lambda m, x, kv, cmp: nsa_lib.nsa_verify_ref(
                m, cfg, x, kv, cmp, 200, jnp.full((1, 1), 200, jnp.int32),
                jnp.ones((1, 1, 1), bool))[0])(bp["mix"], x, cache["kv"], cache["cmp"])
            kv = {k: jax.device_put(cache["kv"][k], shard) for k in ("k", "v")}
            cmp = {k: jax.device_put(cache["cmp"][k], shard) for k in ("k_cmp", "v_cmp")}
            with mesh:
                out_s = jax.jit(lambda m, x, kv, cmp: nsa_sharded.nsa_attend_decode_sharded(
                    m, cfg, mesh, x, kv, cmp, jnp.int32(200), ("data", "model"))[0])(
                    bp["mix"], x, kv, cmp)
            rel = float(jnp.abs(out_s - out_ref).max() / jnp.abs(out_ref).max())
            print(f"REL {hq // hkv} {seed} {rel:.6e}")
    """)
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX references in this process; one spawned run per world."""
    import jax
    import jax.numpy as jnp
    from repro import config as jconfig, configs as jcfg
    from repro.models import model as jmodel, nsa as jnsa
    from repro_torch import config as tconfig
    from repro_torch import configs as tcfg
    from repro_torch.bridge import from_jax
    from repro_torch.launch import ranks
    from repro_torch.models import model as model_lib
    tmp = tmp_path_factory.mktemp("sharded")
    proc = _start_jax_divergence()
    refs = {"layers": {}, "models": {}}
    init = jax.jit(jmodel.init, static_argnums=1)
    prefill = jax.jit(jmodel.prefill, static_argnums=(1, 3))
    decode = jax.jit(jmodel.decode_step, static_argnums=1)
    verify = jax.jit(lambda m, jc, x, kv, cmp: jnsa.nsa_verify_ref(
        m, jc, x, kv, cmp, PREFIX, jnp.full((1, 1), PREFIX, jnp.int32),
        jnp.ones((1, 1, 1), bool)), static_argnums=1)
    for name, hq, hkv, wq, seed in LAYER_CASES:
        jc = _layer_cfg(hq, hkv, jconfig)
        key = jax.random.PRNGKey(seed)
        p = init(key, jc)
        p["segments"][0][0]["mix"]["wq"] = p["segments"][0][0]["mix"]["wq"] * wq
        bp = jax.tree.map(lambda a: a[0], p["segments"][0][0])
        toks = jax.random.randint(key, (1, PREFIX), 0, 97)
        _, caches = prefill(p, jc, toks, MAX_LEN)
        cache = jax.tree.map(lambda a: a[0], caches["segments"][0][0])
        x = jax.random.normal(key, (1, 1, 64))
        out, (k_new, v_new), (si, sv) = verify(bp["mix"], jc, x, cache["kv"], cache["cmp"])
        tc = _layer_cfg(hq, hkv, tconfig)
        port = from_jax(jax.tree.map(np.asarray, p), tc, "cpu")
        t = lambda a: torch.from_numpy(np.array(a))
        torch.save({"cfg": tc, "mix": port["layers"][0]["mix"], "x": t(x),
                    "k": t(cache["kv"]["k"]), "v": t(cache["kv"]["v"]),
                    "k_cmp": t(cache["cmp"]["k_cmp"]), "v_cmp": t(cache["cmp"]["v_cmp"])},
                   tmp / f"layer_{name}.pt")
        refs["layers"][name] = {"out": t(out), "k_new": t(k_new)[0, 0], "v_new": t(v_new)[0, 0],
                                "sel": t(si)[:, 0], "valid": t(sv)[:, 0]}
    for arch in MODEL_CASES:
        jc, tc = jcfg.reduced(arch), tcfg.reduced(arch)
        if jc.attention != "nsa":
            jc, tc = jcfg.nsa_variant(jc), tcfg.nsa_variant(tc)
        key = jax.random.PRNGKey(3)
        p = init(key, jc)
        toks = np.array(jax.random.randint(key, (1, PREFIX + 1), 0, jc.vocab_size))
        jlogits = None
        if arch in JAX_MODEL_CASES:
            _, jcaches = prefill(p, jc, jnp.asarray(toks[:, :PREFIX]), MAX_LEN)
            jlogits, _ = decode(p, jc, jcaches, jnp.asarray(toks[:, PREFIX:]))
            jlogits = torch.from_numpy(np.array(jlogits))
        params = from_jax(jax.tree.map(np.asarray, p), tc, "cpu")
        _, caches = model_lib.prefill(params, tc, torch.from_numpy(toks[:, :PREFIX]), MAX_LEN)
        token = torch.from_numpy(toks[:, PREFIX:])
        torch.save({"cfg": tc, "params": params, "caches": caches, "token": token},
                   tmp / f"model_{arch}.pt")
        copy = {"layers": [{p_: {k: v.clone() for k, v in c[p_].items()} for p_ in c}
                           for c in caches["layers"]], "length": caches["length"].clone()}
        plogits, _ = model_lib.decode_step(params, tc, copy, token)
        refs["models"][arch] = {"jax": jlogits, "port": plogits}
    out = {}
    for world in WORLDS:
        d = tmp / f"world{world}"
        d.mkdir()
        ranks.spawn(_cases_rank, world, "gloo", "cpu", args=(str(tmp), str(d)), timeout=240,
                    threads=1, store_dir=str(tmp))
        out[world] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
    return refs, out, proc


@pytest.mark.parametrize("case", [c[0] for c in LAYER_CASES])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_layer_equals_nsa_verify_ref(runs, world, case):
    refs, out, _ = runs
    want = refs["layers"][case]["out"]
    for r in out[world]:
        got = r["layers"][case]
        torch.testing.assert_close(got["out"], want, rtol=RTOL, atol=ATOL)
        assert got["collectives"] == 5


@pytest.mark.parametrize("case", [c[0] for c in LAYER_CASES])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_topn_equals_routing_select_topn(runs, world, case):
    """Every rank derives the single-device Top-n (invalid slots hold 0)."""
    refs, out, _ = runs
    want = refs["layers"][case]
    for r in out[world]:
        got = r["layers"][case]
        assert torch.equal(got["valid"], want["valid"])
        assert torch.equal(got["sel"].long(), want["sel"].long())


@pytest.mark.parametrize("world", WORLDS)
def test_new_row_written_only_on_the_owning_rank(runs, world):
    refs, out, _ = runs
    S_loc = MAX_LEN // world
    for r in out[world]:
        idx = r["coords"]["data"] * (world // 2) + r["coords"]["model"]
        owns = idx * S_loc <= PREFIX < (idx + 1) * S_loc
        for case, got in r["layers"].items():
            want = [PREFIX - idx * S_loc] if owns else []
            assert got["changed"] == {"k": want, "v": want}, (case, idx)
            if owns:
                torch.testing.assert_close(got["k"][0, want[0]], refs["layers"][case]["k_new"],
                                           rtol=RTOL, atol=ATOL)
                torch.testing.assert_close(got["v"][0, want[0]], refs["layers"][case]["v_new"],
                                           rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", MODEL_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_decode_step_sharded_equals_decode_step(runs, world, arch):
    """Reduced ssv-nsa-1b (Gq 1): logits equal the port's ``decode_step``
    and the JAX one; reduced qwen3-moe's NSA variant (MoE blocks): the
    port's ``decode_step``."""
    refs, out, _ = runs
    for r in out[world]:
        got = r["models"][arch]
        torch.testing.assert_close(got["logits"], refs["models"][arch]["port"],
                                   rtol=RTOL, atol=ATOL)
        if refs["models"][arch]["jax"] is not None:
            torch.testing.assert_close(got["logits"], refs["models"][arch]["jax"],
                                       rtol=RTOL, atol=ATOL)
        assert got["length"].tolist() == [PREFIX + 1]
        assert torch.equal(got["logits"], out[world][0]["models"][arch]["logits"])


@pytest.mark.parametrize("world", WORLDS)
def test_what_does_not_fit_the_world_raises(runs, world):
    _, out, _ = runs
    for r in out[world]:
        err = r["errors"]
        assert err["indivisible"] == f"S = 263 does not divide by {world} shards"
        assert err["production"] == f"a (16, 16) mesh needs 256 ranks; the world has {world}"
        assert err["build_mesh"] == f"need {2 * world} devices, have {world}"


@pytest.mark.parametrize("world", WORLDS)
def test_local_caches_and_dtensor_placements(runs, world):
    """``init_local_caches`` cuts S / world rows per rank at its offset;
    ``placements_of`` lays a ``DTensor`` out as ``local_block`` cuts."""
    _, out, _ = runs
    for r in out[world]:
        idx = r["coords"]["data"] * (world // 2) + r["coords"]["model"]
        n = MAX_LEN // world
        assert r["local_rows"]["kv"] == (idx * n, (idx + 1) * n)
        assert r["local_shape"] == (1, n, 4, 64)
        assert r["dtensor"] == [True] * 4


def test_importing_the_mesh_modules_touches_no_process_group():
    code = ("import torch.distributed as dist\n"
            "from repro_torch.launch import mesh, sharding, ranks\n"
            "from repro_torch.models import nsa_sharded\n"
            "from repro_torch.runtime import elastic\n"
            "assert not dist.is_initialized()\nprint('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env)
    assert p.returncode == 0 and "OK" in p.stdout, p.stderr[-2000:]


def test_jax_sharded_reference_leaves_nsa_verify_ref(runs):
    """With four query heads per kv head (Hq 8 / Hkv 2, head_dim 16, wq x 4,
    the (4, 2) mesh of ``tests/test_distributed_nsa.py``) the JAX sharded
    decode is off ``nsa_verify_ref`` by more than 1e-2 relative at seed 1:
    it ranks the selection blocks by unnormalised head mass. At seed 0 its
    Top-n happens to agree (printed); at Gq 1 it agrees. The port's sharded
    decode agrees on all of them (``test_sharded_layer_equals_nsa_verify_ref``,
    cases ``gq4-wq4-seed0`` / ``-seed1``)."""
    proc = runs[2]
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    rel = {tuple(map(int, line.split()[1:3])): float(line.split()[3])
           for line in stdout.splitlines() if line.startswith("REL ")}
    assert rel[(4, 1)] > 1e-2, rel
    assert rel[(1, 0)] < 1e-5, rel
    print("JAX sharded decode, max rel err against nsa_verify_ref by (Gq, seed):", rel)


def _failing_rank(rank, world, dev):
    if rank == 1:
        raise RuntimeError("rank 1 fails")


def test_a_failed_rank_fails_the_spawn(tmp_path):
    from repro_torch.launch import ranks
    with pytest.raises(Exception, match="rank 1 fails"):
        ranks.spawn(_failing_rank, 2, "gloo", "cpu", timeout=120, threads=1,
                    store_dir=str(tmp_path))


def test_backend_and_device_are_the_callers(monkeypatch):
    """NCCL refuses CPU ranks and more ranks than cards; without a card a
    CUDA world raises; gloo shares the cards (rank r on card r mod count)."""
    from repro_torch.launch import ranks
    with pytest.raises(ValueError, match="NCCL runs CUDA tensors only"):
        ranks.rank_device(0, 2, "nccl", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        ranks.rank_device(0, 2, "mpi", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ranks.rank_device(0, 1, "gloo", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="a world of 4 ranks needs 4 cards"):
        ranks.rank_device(0, 4, "nccl", "cuda")
    assert ranks.rank_device(3, 4, "gloo", "cuda") == torch.device("cuda", 0)
    assert ranks.rank_device(0, 1, "nccl", "cuda") == torch.device("cuda", 0)


def _raising_rank_beside_a_blocked_peer(rank, world, dev):
    import torch.distributed as dist
    if rank == 0:
        raise RuntimeError("rank 0 fails mid-layer")
    dist.all_reduce(torch.ones(4))            # waits for rank 0, which never comes


def test_a_rank_that_raises_beside_a_blocked_peer_prints_and_fails_fast(tmp_path, capfd):
    """Rank 0 raises while rank 1 waits in an all-reduce with it: the
    raising rank prints its traceback at once and ``spawn`` raises long
    before its timeout, rather than the raising rank's teardown of the
    process group waiting behind its peer's collective (under gloo that
    teardown instead reset the peer's connection, and ``spawn`` reported the
    peer's reset, not rank 0's error). Which rank's error ``spawn`` raises
    is a race; rank 0's traceback is on stderr either way."""
    import time
    from repro_torch.launch import ranks
    t0 = time.time()
    with pytest.raises(Exception):
        ranks.spawn(_raising_rank_beside_a_blocked_peer, 2, "gloo", "cpu", timeout=120,
                    threads=1, store_dir=str(tmp_path))
    took = time.time() - t0
    err = capfd.readouterr().err
    assert "rank 0 of 2 raised:" in err, err
    assert "Traceback (most recent call last)" in err and "rank 0 fails mid-layer" in err, err
    assert took < 60, took
