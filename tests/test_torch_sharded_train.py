"""Training across ranks (``runtime.sharded``) on gloo ranks on the CPU,
against the JAX single-device ``make_train_step`` and the port's:

  * the JAX test's config (``tests/test_distributed.py``: 2 layers, d 64,
    4 / 2 heads, d_ff 128, vocab 128, float32, tokens (8, 64)) on a (2, 4)
    world of 8 ranks and a (2, 2) world of 4: the sharded step equals the
    JAX step (bridged) and the port's (loss rtol 1e-5; params, both moments
    rtol 2e-4 / atol 2e-5);
  * against the port's single-device step: reduced ssv-nsa-1b with two
    micro-batches; int8 error-feedback compression on the (pod 2, data 2,
    model 1) mesh of ``plan_mesh(4, multi_pod=True, pod_size=2)``; reduced
    qwen3-moe (the load-balancing loss over the data ranks, capacity drops
    forced); one reduced recurrentgemma period (rglru, rglru, attn);
  * what a rank holds: its blocks of params, moments and residual equal the
    single device's under ``local_block``, equal a ``DTensor``'s
    ``to_local()`` under ``placements_of``, and no more bytes;
  * the int8 compression on blocks equals the whole leaves' bitwise; the
    int8 check fails a sharded step that draws the next step's noise; a
    block that does not divide raises, naming the leaf, dimension and axes;
  * checkpoints: saved from the (2, 2) world, restored onto (2, 1) and onto
    one device bitwise; one written by the JAX ``save`` restored onto (2, 2)
    bitwise;
  * a frontend's frames: reduced pixtral-12b on (2, 1), its 8 frames a row
    cut over the data ranks with the tokens, equals a JAX step on
    ``loss_fn(frontend=)`` (``jax.value_and_grad``, the clip and AdamW, as
    the JAX dry run's ``train_4k`` step of an arch with a frontend runs it):
    the loss, and through the first moment the gradient of every leaf,
    ``frontend_proj`` too.

  * the positions split over ``model`` (``runtime.sharded.SeqSplit``): the
    (2, 4) and (2, 2) jobs above run it, and five jobs on a (1, 2) mesh in
    the world of 2 hold it to the JAX step or the port's single-device step
    at the same tolerances: the JAX case; reduced ssv-nsa-1b on an uneven
    stream of 65 tokens (chunks of 33 and 32: a compressed block and a
    selected block straddle the cut); reduced qwen3-moe whose dispatch
    groups of one row straddle the cut, its capacity drops equal to the
    single device's; reduced mixtral (``swa`` window 64, MoE) on 96
    positions, rank 1's windows reaching into rank 0's chunk; reduced
    pixtral with 44 frames in front of 36 tokens, frames on both sides of
    the cut and none of rank 0's positions a token. A spy shows every
    layer's input on each rank holds the rank's positions, not the
    stream's.

Each world is one spawned run (``launch.ranks.spawn``, a ``FileStore`` in
``tmp_path``, one thread per rank, its own timeout) that runs every job
(``launch.train_checks``) and the extra checks; the references are
computed in this process. JAX is imported inside the fixture, so the ranks
import only torch and the port."""
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL, ATOL, LOSS_RTOL = 2e-4, 2e-5, 1e-5
TOL = (RTOL, ATOL, LOSS_RTOL)
JAX_CASE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                vocab_size=128, dtype="float32")
POD = (2, 2, 1), ("pod", "data", "model")


def _jobs(world, tmp):
    """Every world's jobs (see the module docstring); paths under ``tmp``."""
    step = lambda name, case, mesh, refs, **kw: dict(
        kind="step", name=name, mesh=mesh, case=str(tmp / f"{case}.pt"),
        refs={r: str(tmp / f"ref_{case}_{r}.pt") for r in refs}, tol=TOL,
        **torch.load(tmp / f"cfg_{case}.pt", weights_only=False), **kw)
    dm = lambda d, m: ((d, m), ("data", "model"))
    if world == 8:
        return [step("jax (2, 4)", "jax", dm(2, 4), ("jax", "port"))]
    if world == 4:
        return [step("jax (2, 2)", "jax", dm(2, 2), ("jax", "port"), save=str(tmp / "ck22")),
                step("ssv-nsa-1b micro-batches 2", "mb", dm(2, 2), ("port",)),
                step("qwen3-moe", "moe", dm(2, 2), ("port",)),
                step("recurrentgemma period", "rec", dm(2, 2), ("port",)),
                step("int8_ef on the pod mesh", "int8", POD, ("port",)),
                dict(kind="restore", name="JAX checkpoint on (2, 2)", mesh=dm(2, 2),
                     dir=str(tmp / "jaxck"), whole=str(tmp / "jaxck_whole.pt"),
                     **torch.load(tmp / "cfg_jax.pt", weights_only=False))]
    return [dict(kind="restore", name="(2, 2) checkpoint on (2, 1)", mesh=dm(2, 1),
                 dir=str(tmp / "ck22"), whole=str(tmp / "ck22" / "whole.pt"),
                 **torch.load(tmp / "cfg_jax.pt", weights_only=False)),
            step("pixtral frames (2, 1)", "frames", dm(2, 1), ("jax",)),
            step("jax (1, 2)", "jax", dm(1, 2), ("jax", "port")),
            *(step(name, case, dm(1, 2), ("port",)) for name, case in SPLIT_CASES.items())]


# the (1, 2) jobs against the port's single-device step: {job name: case}
SPLIT_CASES = {"ssv-nsa-1b uneven (1, 2)": "nsa65", "qwen3-moe (1, 2)": "moe",
               "mixtral swa (1, 2)": "swa", "pixtral frames across the cut (1, 2)": "frames12"}


def _spied(job, dev):
    """``job`` run with two spies: each ``block_apply_train`` call's input
    positions, and the capacity drops among the rank's own tokens of every
    MoE call (forward and recompute)."""
    from repro_torch.launch import train_checks
    from repro_torch.models import model, moe
    positions, drops = [], []
    block, outputs = model.block_apply_train, moe._expert_outputs

    def spy_block(bp, cfg, kind, x, *a, **kw):
        positions.append(x.shape[1])
        return block(bp, cfg, kind, x, *a, **kw)

    def spy_outputs(params, cfg, xf, topk_idx, pos, keep, *a):
        drops.append(int((~keep).sum()))
        return outputs(params, cfg, xf, topk_idx, pos, keep, *a)

    model.block_apply_train, moe._expert_outputs = spy_block, spy_outputs
    try:
        out = train_checks.run_jobs([job], dev)[0]
    finally:
        model.block_apply_train, moe._expert_outputs = block, outputs
    return dict(out, layer_positions=positions, own_drops=sum(drops))


# ---------------------------------------------------------------- the ranks
def _rank(rank, world, dev, tmp, out_dir):
    """The world's jobs, then the extra checks; everything to rank<r>.pt."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import mesh as mesh_lib, sharding, train_checks
    from repro_torch.optim import compress, tree_leaves
    from repro_torch.runtime.sharded import LeafBlocks, MeshLayout
    tmp = Path(tmp)
    jobs = _jobs(world, tmp)
    if world == 2:
        res = {"jobs": [_spied(j, dev) if j["mesh"][0] == (1, 2) else
                        train_checks.run_jobs([j], dev)[0] for j in jobs]}
    else:
        res = {"jobs": train_checks.run_jobs(jobs, dev)}
    if world in (8, 4):
        # DTensor placements against the blocks that shard_tree cuts
        d, m = (2, world // 2)
        mesh = mesh_lib.make_test_mesh(d, m, "cpu")
        params = torch.load(tmp / "jax.pt", weights_only=False)["params"]
        specs = sharding.param_specs(params, mesh)
        blocks = sharding.flatten(sharding.shard_tree(params, specs, mesh))
        flat_specs = sharding.flatten(specs)
        res["dtensor"] = [torch.equal(
            distribute_tensor(t, mesh, sharding.placements_of(flat_specs[key], mesh)).to_local(),
            blocks[key]) for key, t in sharding.flatten(params).items()]
    if world == 8:
        mesh = mesh_lib.make_test_mesh(2, 4, "cpu")
        try:
            sharding.shard_tree({"layers": [{"mix": {"conv": torch.zeros(4, 6)}}]},
                                {"layers": [{"mix": {"conv": sharding.spec(None, "model")}}]},
                                mesh)
            res["raises"] = None
        except ValueError as e:
            res["raises"] = str(e)
    if world == 4:
        # int8 on blocks == the same blocks of the whole leaves' (bitwise)
        mesh = mesh_lib.make_mesh(*POD, "cpu")
        layout = MeshLayout(mesh)
        d = torch.load(tmp / "compress.pt", weights_only=False)
        specs = sharding.param_specs(d["grads"], mesh)
        leaf_specs = [sharding.leaf_at(specs, k) for k, _ in sharding.leaf_paths(d["grads"])]
        (q, s), r = compress.compress_pytree(d["grads"], d["residual"], 3)
        (qb, sb), rb = compress.compress_pytree(
            sharding.shard_tree(d["grads"], specs, mesh),
            sharding.shard_tree(d["residual"], specs, mesh), 3, LeafBlocks(layout, leaf_specs))
        res["compress"] = all(
            torch.equal(layout.block(a, sp), b) for whole, part in ((q, qb), (r, rb))
            for a, b, sp in zip(tree_leaves(whole), tree_leaves(part), leaf_specs)) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(s), tree_leaves(sb)))
        res["collectives"] = dict(layout.counts)
        # the int8 job again, each block drawing the next step's noise
        job = next(j for j in _jobs(world, tmp) if j["name"] == "int8_ef on the pod mesh")
        noise = LeafBlocks.noise
        LeafBlocks.noise = lambda self, block, index, step: noise(self, block, index, step + 1)
        try:
            res["wrong noise"] = train_checks.run_jobs([job], dev)[0]
        finally:
            LeafBlocks.noise = noise
    dist.barrier()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


# ---------------------------------------------------------------- the references
def _save_case(tmp, name, cfg, tcfg, params, tokens, refs, frontend=None):
    """The case's whole inputs, its configs and one reference file per
    entry of ``refs`` ({name: reference dict})."""
    torch.save({"params": params, "tokens": tokens, "frontend": frontend}, tmp / f"{name}.pt")
    torch.save({"cfg": cfg, "tcfg": tcfg}, tmp / f"cfg_{name}.pt")
    for r, ref in refs.items():
        torch.save(ref, tmp / f"ref_{name}_{r}.pt")


def _port_reference(cfg, tcfg, params, tokens, frontend=None):
    """The port's single-device step as a reference
    (``train_checks.single_device_reference``) and its MoE capacity drops
    (read from ``moe.dispatch``, forward and recompute)."""
    from repro_torch.launch import train_checks
    from repro_torch.models import moe
    dropped = []
    dispatch = moe.dispatch

    def spy_dispatch(*a):
        pos, keep = dispatch(*a)
        dropped.append(int((~keep).sum()))
        return pos, keep

    moe.dispatch = spy_dispatch
    try:
        ref = train_checks.single_device_reference(cfg, tcfg, params, tokens,
                                                   frontend=frontend)
    finally:
        moe.dispatch = dispatch
    return ref, sum(dropped)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The references in this process; one spawned run per world."""
    import jax
    import jax.numpy as jnp
    from repro import config as jconfig
    from repro.ckpt import save as jsave
    from repro.models import model as jmodel
    from repro.optim import adamw_init as jadamw_init
    from repro.runtime.trainer import make_train_step as jmake_train_step
    from repro_torch.bridge import from_jax, init_params
    from repro_torch.config import ModelConfig, TrainConfig
    from repro_torch.configs import reduced
    from repro_torch.launch import ranks, train_checks
    from repro_torch.optim import AdamWState, tree_leaves
    tmp = tmp_path_factory.mktemp("sharded_train")
    out = {"drops": {}}

    # the JAX test's case: the JAX step and the port's on the bridged weights
    jc = jconfig.ModelConfig(name="t", **JAX_CASE)
    tc = ModelConfig(name="t", **JAX_CASE)
    jt, tt = jconfig.TrainConfig(steps=1, learning_rate=1e-3), TrainConfig(steps=1,
                                                                          learning_rate=1e-3)
    jp = jmodel.init(jax.random.PRNGKey(0), jc)
    jtoks = jax.random.randint(jax.random.PRNGKey(1), (8, 64), 0, 128)
    p1, o1, _, m1 = jmake_train_step(jc, jt, donate=False)(jp, jadamw_init(jp), jnp.zeros(()),
                                                          jtoks)
    host = lambda tree: jax.tree.map(np.asarray, tree)
    params = from_jax(host(jp), tc, "cpu")
    tokens = torch.from_numpy(np.array(jtoks)).long()
    jstate = {"params": from_jax(host(p1), tc, "cpu"),
              "opt": AdamWState(mu=from_jax(host(o1.mu), tc, "cpu"),
                                nu=from_jax(host(o1.nu), tc, "cpu"),
                                count=torch.tensor(int(o1.count), dtype=torch.int32)),
              "residual": torch.zeros(())}
    jref = train_checks.reference(m1, jstate["params"], jstate["opt"], jstate["residual"])
    pref, _ = _port_reference(tc, tt, params, tokens)
    _save_case(tmp, "jax", tc, tt, params, tokens, {"jax": jref, "port": pref})
    out["jax_loss"] = float(m1["loss"])
    # a checkpoint written by the JAX package, and its whole state in the port's layout
    jsave(str(tmp / "jaxck"), 1, {"params": p1, "opt": o1, "residual": jnp.zeros(())})
    torch.save(jstate, tmp / "jaxck_whole.pt")

    # a frontend's frames: the JAX step on loss_fn(frontend=), as the JAX
    # dry run's train_4k step of an arch with a frontend runs it
    from repro import configs as jcfg
    from repro.optim import adamw_update as jadamw_update, \
        clip_by_global_norm as jclip_by_global_norm
    jc, tc = jcfg.reduced("pixtral-12b"), reduced("pixtral-12b")
    jp = jmodel.init(jax.random.PRNGKey(5), jc)
    jtoks = jax.random.randint(jax.random.PRNGKey(6), (4, 64), 0, jc.vocab_size)
    jfe = jax.random.normal(jax.random.PRNGKey(7), (4, 8, jc.frontend_dim))
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jc, jtoks, frontend=jfe, remat=True))(jp)
    grads, gnorm = jclip_by_global_norm(grads, jt.grad_clip)
    p1, o1 = jadamw_update(grads, jadamw_init(jp), jp, jt)
    fref = train_checks.reference(
        {"loss": loss, "grad_norm": gnorm}, from_jax(host(p1), tc, "cpu"),
        AdamWState(mu=from_jax(host(o1.mu), tc, "cpu"), nu=from_jax(host(o1.nu), tc, "cpu"),
                   count=torch.tensor(int(o1.count), dtype=torch.int32)), torch.zeros(()))
    _save_case(tmp, "frames", tc, tt, from_jax(host(jp), tc, "cpu"),
               torch.from_numpy(np.array(jtoks)).long(), {"jax": fref},
               torch.from_numpy(np.array(jfe)))
    out["frames_loss"] = float(loss)

    # the port-only cases
    g = lambda seed: torch.Generator().manual_seed(seed)
    moe_cfg = reduced("qwen3-moe-235b-a22b")
    cases = {
        "mb": (reduced("ssv-nsa-1b"), TrainConfig(steps=1, learning_rate=1e-3,
                                                  micro_batches=2)),
        "moe": (dataclasses.replace(moe_cfg, moe=dataclasses.replace(moe_cfg.moe,
                                                                     capacity_factor=1.0)),
                TrainConfig(steps=1, learning_rate=1e-3)),
        "rec": (reduced("recurrentgemma-9b", layers=3), TrainConfig(steps=1, learning_rate=1e-3)),
        "int8": (reduced("ssv-nsa-1b"), TrainConfig(steps=1, learning_rate=1e-3,
                                                    grad_compression="int8_ef"))}
    plain = TrainConfig(steps=1, learning_rate=1e-3)
    cases.update({"nsa65": (reduced("ssv-nsa-1b"), plain),
                  "swa": (reduced("mixtral-8x22b"), plain),
                  "frames12": (reduced("pixtral-12b"), plain)})
    shapes = {"nsa65": (2, 65), "swa": (2, 96), "frames12": (2, 36)}
    for i, (name, (cfg, tcfg)) in enumerate(cases.items()):
        params = init_params(cfg, g(10 + i), "cpu")
        tokens = torch.randint(0, cfg.vocab_size, shapes.get(name, (4, 64)), generator=g(20 + i))
        frontend = torch.randn((2, 44, cfg.frontend_dim), generator=g(40)) \
            if name == "frames12" else None
        ref, out["drops"][name] = _port_reference(cfg, tcfg, params, tokens, frontend)
        _save_case(tmp, name, cfg, tcfg, params, tokens, {"port": ref}, frontend)
    # whole gradients and residual for the int8-on-blocks check
    grads = init_params(cases["int8"][0], g(30), "cpu")
    torch.save({"grads": grads, "residual": init_params(cases["int8"][0], g(31), "cpu")},
               tmp / "compress.pt")

    for world in (8, 4, 2):
        d = tmp / f"world{world}"
        d.mkdir()
        ranks.spawn(_rank, world, "gloo", "cpu", args=(str(tmp), str(d)), timeout=240,
                    threads=1, store_dir=str(tmp))
        out[world] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
    out["tmp"] = tmp
    return out


def _job(r, name):
    return next(j for j in r["jobs"] if j["name"] == name)


# ---------------------------------------------------------------- the step
@pytest.mark.parametrize("world,name", [(8, "jax (2, 4)"), (4, "jax (2, 2)"),
                                        (2, "jax (1, 2)")])
def test_sharded_step_equals_the_jax_step(runs, world, name):
    """The JAX test's case, its 64 positions split over the ``model`` ranks:
    every rank's loss and grad norm are the JAX step's and the port's,
    every block of the new params and moments the same block of theirs
    (rtol 2e-4 / atol 2e-5; loss rtol 1e-5)."""
    for r in runs[world]:
        job = _job(r, name)
        for ref in ("jax", "port"):
            assert job["refs"][ref]["ok"], (ref, job["refs"][ref])
        assert abs(job["loss"] - runs["jax_loss"]) <= LOSS_RTOL * abs(runs["jax_loss"])
        assert job["loss"] == _job(runs[world][0], name)["loss"]


@pytest.mark.parametrize("name", ["ssv-nsa-1b micro-batches 2", "qwen3-moe",
                                  "recurrentgemma period", "int8_ef on the pod mesh"])
def test_sharded_step_equals_the_single_device_step(runs, name):
    """The port's single-device step: two micro-batches (the whole batch's
    runs of rows, each cut over the data ranks), the MoE load-balancing
    loss over the data ranks with capacity drops (reduced qwen3-moe,
    capacity factor 1.0: each data rank's 128 tokens hold two dispatch
    groups of 64, the single device's groups), one recurrent period, and
    int8 compression on the pod mesh, where an element whose stochastic
    rounding lands the other way is held one quantization step off in the
    residual and to the update of a gradient one step the other way in its
    params and moments, and the count of such elements to
    ``train_checks.flips_bound`` of the count their residuals predict."""
    for r in runs[4]:
        job = _job(r, name)
        assert job["refs"]["port"]["ok"], job["refs"]["port"]
    if name == "qwen3-moe":
        assert runs["drops"]["moe"] > 0
    if name == "int8_ef on the pod mesh":
        got = [_job(r, name)["refs"]["port"] for r in runs[4]]
        print("int8 rounding flips per rank:", [g["rounding_flips"] for g in got], "expected",
              [round(g["flips_expected"], 2) for g in got], "of", got[0]["elements"])
    print(name, "params held to a moved update per rank, off the reference's tolerance:",
          [(_job(r, name)["refs"]["port"]["moved"],
            _job(r, name)["refs"]["port"]["moved_off_reference"]) for r in runs[4]])


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_step_equals_the_single_device_step(runs, name):
    """On (1, 2) the two ranks split each row's positions: an uneven NSA
    stream, MoE dispatch groups across the cut (the drops of the ranks'
    own tokens add up to the single device's, and there are some), a
    sliding window across it, frames on both sides of it. Every rank's
    loss equals the single device's (rtol 1e-5) and every block of its
    params and moments (rtol 2e-4 / atol 2e-5)."""
    drops = 0
    for r in runs[2]:
        job = _job(r, name)
        assert job["refs"]["port"]["ok"], job["refs"]["port"]
        drops += job["own_drops"]
    if "moe" in name:
        assert drops == runs["drops"]["moe"] > 0
    if "swa" in name:
        assert drops == runs["drops"]["swa"]


@pytest.mark.parametrize("name", ["jax (1, 2)", *SPLIT_CASES])
def test_each_rank_computes_only_its_positions(runs, name):
    """Every layer's input (forward and recompute) on rank i of the (1, 2)
    jobs holds positions ``seq_chunk(S, 2, i)`` of the stream, never all
    S of them: 32 of 64 (the JAX case, qwen3-moe), 33 and 32 of 65, 48 of
    96, 40 of 80 (44 frames and 36 tokens)."""
    from repro_torch.launch.sharding import seq_chunk
    S = {"jax (1, 2)": 64, "ssv-nsa-1b uneven (1, 2)": 65, "qwen3-moe (1, 2)": 64,
         "mixtral swa (1, 2)": 96, "pixtral frames across the cut (1, 2)": 80}[name]
    for i, r in enumerate(runs[2]):
        job = _job(r, name)
        a, b = seq_chunk(S, 2, i)
        assert tuple(job["positions"]) == (a, b, S)
        layers = len(job["layer_positions"])
        assert layers > 0 and job["layer_positions"] == [b - a] * layers, job["layer_positions"]


def test_int8_check_fails_a_step_with_the_wrong_noise(runs):
    """The int8 step with every block drawing the next step's noise: its
    rounding flips far exceed ``flips_bound`` of those expected, and the
    check fails."""
    from repro_torch.launch.train_checks import flips_bound
    for r in runs[4]:
        ref = r["wrong noise"]["refs"]["port"]
        assert not ref["ok"]
        assert ref["rounding_flips"] > max(flips_bound(ref["flips_expected"]),
                                           0.2 * ref["elements"]), ref


@pytest.mark.parametrize("world,name", [(8, "jax (2, 4)"), (4, "jax (2, 2)"),
                                        (4, "int8_ef on the pod mesh")])
def test_ranks_hold_only_their_blocks(runs, world, name):
    """A rank's resident bytes (params, both moments, the residual) are the
    sum of its blocks' under ``param_specs``, less than half the single
    device's; a leaf split over every axis is split into ``world`` blocks
    that together hold its bytes once."""
    from repro_torch.bridge import init_params
    from repro_torch.launch import sharding
    from repro_torch.runtime.elastic import plan_mesh
    cfg = torch.load(runs["tmp"] / f"cfg_{'int8' if 'int8' in name else 'jax'}.pt",
                     weights_only=False)
    comp = cfg["tcfg"].grad_compression == "int8_ef"
    meta = init_params(cfg["cfg"], torch.Generator(), "meta")
    mc = plan_mesh(world, prefer_model=1, multi_pod=True, pod_size=2) if comp else \
        plan_mesh(world, prefer_model=world // 2)
    sizes = dict(zip(mc.axes, mc.shape))
    moments = 3 if comp else 2                      # mu, nu (and the residual), float32
    specs = sharding.flatten(sharding.param_specs(meta, mc))
    per_rank, whole, split_all = 0, 0, 0
    for key, t in sharding.flatten(meta).items():
        n = math.prod(sizes[a] for a in sharding.split_axes(specs[key], mc.axes))
        local = math.prod(sharding.local_shape(t.shape, specs[key], sizes))
        per_rank += local * (t.element_size() + 4 * moments)
        whole += t.numel() * (t.element_size() + 4 * moments)
        if n == world:
            assert local * world == t.numel()
            split_all += 1
    per_rank += 4 + (0 if comp else 4)              # the count; a 0-d residual
    assert split_all > 0
    for r in runs[world]:
        assert _job(r, name)["resident_bytes"] == per_rank
    assert per_rank < whole / 2


@pytest.mark.parametrize("world", [8, 4])
def test_blocks_equal_dtensor_to_local(runs, world):
    for r in runs[world]:
        assert r["dtensor"] and all(r["dtensor"])


def test_int8_on_blocks_equals_the_whole_leaves_bitwise(runs):
    """Quantized values, scales and residuals of each rank's blocks equal
    the same blocks of the whole leaves' (the scale a MAX over the ranks,
    the noise cut from the whole leaf's), with one all-reduce for every
    leaf's scale."""
    for r in runs[4]:
        assert r["compress"]
        assert r["collectives"] == {"gathers": 0, "reductions": 1, "activations": 0}


def test_a_block_that_does_not_divide_raises(runs):
    for r in runs[8]:
        assert r["raises"] == ("layers/0/mix/conv: dimension 1 of size 6 does not divide "
                               "over ('model',) (4 shards)")


def test_collectives_of_a_step(runs):
    """The JAX case on (2, 2) (2 dense layers of 9 leaves, 7 of them split
    over (data, model); 3 top-level leaves, 2 split over ``model`` only;
    remat on), each row's 64 positions split over ``model``: a layer's
    split leaves are gathered twice (the forward and the recompute), the
    top-level ones once; every gradient is summed over the mesh: one
    reduce-scatter for a leaf split over both axes, one all-reduce for a
    replicated one, a reduce-scatter over ``model`` and an all-reduce over
    ``data`` for a top-level table; one all-reduce each for the loss and
    the norm. A layer's K/V are all-gathered along ``model`` in the forward
    and the recompute and their gradient reduce-scattered once (3
    activation collectives a layer), each carrying the 2 ranks' chunks of
    4 rows x 32 positions x 2 kv heads x (K and V) x head dim 16 in
    float32. On (1, 2) the tables' all-reduce over one data rank goes."""
    job = _job(runs[4][0], "jax (2, 2)")
    assert (job["gathers"], job["reductions"], job["activations"]) == \
        (2 * 2 * 7 + 2, 2 * 9 + 5 + 2, 2 * 3)
    assert job["activation_bytes"] == 2 * 3 * (2 * 4 * 32 * 2 * 2 * 16 * 4)
    job = _job(runs[2][0], "jax (1, 2)")
    assert (job["gathers"], job["reductions"], job["activations"]) == \
        (2 * 2 * 7 + 2, 2 * 9 + 3 + 2, 2 * 3)


# ---------------------------------------------------------------- checkpoints
def test_checkpoint_from_2x2_restores_on_2x1_bitwise(runs):
    for r in runs[2]:
        job = _job(r, "(2, 2) checkpoint on (2, 1)")
        assert job["bitwise"] and job["step"] == 1 and job["leaves"] > 0


def test_checkpoint_from_2x2_restores_on_one_device_bitwise(runs):
    from repro_torch.ckpt import restore
    from repro_torch.optim import tree_leaves
    whole = torch.load(runs["tmp"] / "ck22" / "whole.pt", weights_only=False)
    cfg = torch.load(runs["tmp"] / "cfg_jax.pt", weights_only=False)["cfg"]
    template = {k: v for k, v in whole.items()}
    step, back = restore(str(runs["tmp"] / "ck22"), template, cfg)
    assert step == 1
    for a, b in zip(tree_leaves(whole), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_jax_checkpoint_restores_sharded_bitwise(runs):
    for r in runs[4]:
        job = _job(r, "JAX checkpoint on (2, 2)")
        assert job["bitwise"] and job["step"] == 1


def test_sharded_step_with_frontend_frames_equals_the_jax_step(runs):
    """Reduced pixtral-12b on (2, 1), 4 rows of 8 frames + 64 tokens (each
    data rank 2 rows of both): the loss is the JAX ``loss_fn(frontend=)``'s
    (its prefix positions skipped), and the new params and both moments
    equal the JAX step's on every block (rtol 2e-4 / atol 2e-5; loss rtol
    1e-5), so every gradient leaf equals ``jax.value_and_grad``'s, the
    replicated ``frontend_proj`` summed over the data ranks."""
    for r in runs[2]:
        job = _job(r, "pixtral frames (2, 1)")
        assert job["refs"]["jax"]["ok"], job["refs"]["jax"]
        assert abs(job["loss"] - runs["frames_loss"]) <= LOSS_RTOL * abs(runs["frames_loss"])
