"""The sharded train step held against the single-device step, in spawned
ranks: the spawned half of ``chip_smoke.py`` phase 13 and of the card and
CPU tests of ``runtime.sharded``.

A check is a list of jobs (dicts); every rank of a world runs them in order
(``check_rank``, spawned by ``run_checks``) and writes its results to
``<out_dir>/rank<r>.json``:

  * ``"step"``: one ``make_train_step(cfg, tcfg, mesh)`` from the whole
    params and tokens (and frames) of ``case`` (saved at a path, or drawn
    from a seed:
    ``load_case``; each rank cuts its blocks and its rows; fresh moments; a
    zero residual), then the rank's blocks of the
    new params, moments and residual held against the same blocks of each
    reference in ``refs`` (``reference``: a single device's new state, loss
    and grad norm, and under int8 compression each leaf's scale; with
    ``single_ref`` also ``single_device_reference`` computed on the rank's
    own device from the whole params, after the sharded step) within
    ``tol`` = (rtol, atol, loss rtol), compared on the rank's device; the
    rank's resident bytes, the
    collectives of the step (weight gathers, reductions, activation
    collectives along ``model`` and their bytes, by layer kind, and the
    sLSTM relays' busy and idle steps), the positions (a, b, S)
    the rank computed (None when ``model`` has one rank), its wall time
    and peak memory; ``timed`` more
    steps on the host clock, once a file exists at ``timed_after`` when it
    is given (the caller's sign that the card is free); with ``save`` (a
    directory) the new state goes
    to a checkpoint there (``ckpt.save_sharded``) and, whole, to
    ``<save>/whole.pt``.
  * ``"restore"``: ``elastic.block_template`` and ``ckpt.restore(mesh=)``
    of the newest checkpoint in ``dir``: every block bitwise against the
    same block of the whole state saved at ``whole``.

Int8 compression: where the whole batch's gradient and the data ranks'
mean of theirs differ in their last bits, stochastic rounding can send an
element to the next integer (a rounding flip). Its residual is then k
quantization steps off the reference's (k = +-1, a step being the leaf's
scale) and its decompressed gradient k steps the other way. A flipped
element's residual is held to the reference's moved by k steps, its
moments to the AdamW update of the reference's gradient moved by -k steps
and its params to the update of its own gradient (``_moved``); every
other element to the reference's. An
element flips with probability |du| (du: the difference of its rounding
input, in steps, read from its residual), so the count of flips is held
to ``flips_bound`` of the sum of |du|; a wrong noise or scale flips a large
share of the elements.

AdamW's first step from zero moments moves a param by the learning rate
times g / (|g| + EPS), about its sign: where the two gradients of an
element lie on either side of zero, or within ten EPS of it, a last-bit
difference moves the param by up to twice the learning rate, more than
the tolerance. Such an ill-conditioned element's param is held to the
update of the step's own gradient, whose first moment is held to the
reference's (``_moved``); how many there are, how many of them are off
the reference's tolerance and by how much, is reported.
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Dict, List

import torch
import torch.distributed as dist

from repro_torch import ckpt
from repro_torch.bridge import init_params
from repro_torch.launch import mesh as mesh_lib, sharding
from repro_torch.optim import (adamw_init, adamw_update, compress, tree_leaves, tree_map,
                               tree_unflatten)
from repro_torch.optim.adamw import EPS
from repro_torch.runtime import elastic
from repro_torch.runtime.sharded import MeshLayout
from repro_torch.runtime.trainer import make_train_step

# x ``adamw.EPS``: below it an AdamW update is ill-conditioned (``_moved``)
ILL_CONDITIONED = 10


def flips_bound(expected: float) -> float:
    """The most rounding flips held plausible where ``expected`` are
    expected: each element flips alone, with probability |du| < 1, so the
    count's mean is ``expected`` and its variance less; five standard
    deviations above the mean, and 5 for a small count."""
    return expected + 5 * math.sqrt(expected) + 5


def reference(metrics, params, opt, residual, scales=None, host: bool = True) -> Dict:
    """A single device's step result as a reference (a file's contents when
    ``host``: every tensor on the host). ``scales``: each gradient leaf's
    int8 scale, in leaf order."""
    move = (lambda tree: tree_map(lambda t: t.detach().cpu(), tree)) if host else (lambda t: t)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": move(params), "opt": move(opt), "residual": move(residual),
            "scales": None if scales is None else [float(s) for s in scales]}


def single_device_reference(cfg, tcfg, params, tokens, host: bool = True,
                            frontend=None) -> Dict:
    """``make_train_step(cfg, tcfg)`` on one device from ``params`` (fresh
    moments, a zero residual; ``frontend``: the rows' frames) as a
    ``reference`` (on the host when
    ``host``), with the step's wall time (``"wall_ms"``, synchronised) and
    peak memory on a card (``"peak_gib"``); under int8 compression each
    leaf's scale is read as ``compress._quantize`` returns it."""
    dev = tokens.device
    scales = []
    quantize = compress._quantize

    def recorded(*a):
        q, s = quantize(*a)
        scales.append(s)
        return q, s

    compress._quantize = recorded
    try:
        residual = compress.init_residual(params) if tcfg.grad_compression == "int8_ef" \
            else torch.zeros((), device=dev)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        p, o, r, m = make_train_step(cfg, tcfg)(params, adamw_init(params), residual, tokens,
                                                frontend)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        compress._quantize = quantize
    out = reference(m, p, o, r, scales or None, host)
    out["wall_ms"] = wall
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _held(got, ref, specs, layout: MeshLayout, rtol: float, atol: float, moved=None):
    """(ok, max abs error, the leaf keys off the tolerance) of this rank's
    blocks ``got`` against the same blocks of the whole ``ref``, leaf by leaf
    by path; ``moved`` ({leaf key: (mask, values)}) holds the masked
    elements to ``values`` instead."""
    worst, off = 0.0, []
    for key, g in sharding.leaf_paths(got):
        want = _block_of(ref, specs, key, layout, g.device)
        if moved is not None and key in moved:
            mask, values = moved[key]
            want = torch.where(mask, values.float(), want)
        d = (g.detach().float() - want).abs()
        if not bool((d <= atol + rtol * want.abs()).all()):
            off.append(key)
        worst = max(worst, float(d.max()))
    return not off, worst, off


def _block_of(ref, specs, key: str, layout: MeshLayout, dev) -> torch.Tensor:
    """This rank's block of the whole ``ref``'s leaf ``key``, float32 on ``dev``."""
    return layout.block(sharding.leaf_at(ref, key), sharding.leaf_at(specs, key)).to(dev).float()


def _rounding_flips(residual, ref, specs, layout: MeshLayout, scales):
    """({leaf key: k}, flips expected) for this rank's residual blocks
    against the same blocks of the whole ``ref``: k (float, -1, 0 or 1) the
    quantization steps (``scales``, in leaf order) by which each element's
    rounding went the other way, and the sum of |du| = |d / step - k| over
    the elements (d: the residual's difference)."""
    steps, expected = {}, 0.0
    for i, (key, g) in enumerate(sharding.leaf_paths(residual)):
        steps[key], e = rounding_steps(
            (g.detach().float() - _block_of(ref, specs, key, layout, g.device)) / scales[i])
        expected += e
    return steps, expected


def rounding_steps(d: torch.Tensor):
    """(k, the sum of |d - k|) for ``d``, two residuals' difference in
    quantization steps: k (-1, 0 or 1) the steps by which each element's
    stochastic rounding went the other way, d - k the difference of its
    rounding input."""
    k = torch.clamp(torch.round(d), -1, 1)
    return k, float((d - k).abs().sum())


def _moved(ref, opt, params0, opt0, specs, layout: MeshLayout, tcfg, steps=None,
           scales=None):
    """{part: {leaf key: (mask, values)}}: the elements of this rank's blocks
    that are held to other values than the reference's, and those values
    (the step taken from ``params0`` / ``opt0``, this step's inputs; each
    gradient read from a first moment, g = (mu - b1 mu0) / (1 - b1)):

      * an int8 rounding flip (``steps``: k != 0): its residual to the
        reference's moved by k steps (``scales``), its moments to the step
        of the reference's gradient moved by -k steps, clipped by the
        reference's factor, and its params to the step of this step's own
        gradient;
      * an ill-conditioned AdamW update, where the first moments differ
        and either differ in sign or the reference's or this step's
        denominator sqrt(v_hat) is below ``ILL_CONDITIONED`` x
        ``adamw.EPS``: the update m_hat / (sqrt(v_hat) + EPS) there turns by
        O(1) between the two gradients, so a last-bit difference of a
        gradient near zero moves the param by up to twice the learning
        rate. Its params are held to the step of this step's own gradient
        (whose first moment is held to the reference's)."""
    keys = [key for key, _ in sharding.leaf_paths(params0)]
    p_specs = specs["params"]
    b1, b2, count = tcfg.b1, tcfg.b2, int(opt.count)
    mu0 = tree_leaves(opt0.mu)
    dev = mu0[0].device
    grad = lambda mu, m0: (mu - b1 * m0) / (1 - b1)
    ref_mu = [_block_of(ref["opt"].mu, p_specs, key, layout, dev) for key in keys]
    own_p, _ = adamw_update(tree_unflatten(params0, [grad(m.float(), m0) for m, m0 in
                                                     zip(tree_leaves(opt.mu), mu0)]),
                            opt0, params0, tcfg)
    floor = ILL_CONDITIONED * EPS
    denom = lambda nu: torch.sqrt(nu.float() / (1 - b2 ** count))
    ill = {key: ((denom(_block_of(ref["opt"].nu, p_specs, key, layout, dev)) < floor)
                 | (denom(nu) < floor) | (torch.sign(mu) != torch.sign(rm))) & (mu.float() != rm)
           for key, nu, mu, rm in zip(keys, tree_leaves(opt.nu), tree_leaves(opt.mu), ref_mu)}
    out = {"params": {key: (ill[key], p) for key, p in zip(keys, tree_leaves(own_p))}}
    if steps is None:
        return out
    clip = min(1.0, tcfg.grad_clip / max(ref["grad_norm"], 1e-9))
    moved = [grad(m, m0) - steps[key] * scales[i] * clip
             for i, (key, m, m0) in enumerate(zip(keys, ref_mu, mu0))]
    _, mv_opt = adamw_update(tree_unflatten(params0, moved), opt0, params0, tcfg)
    flipped = {key: steps[key] != 0 for key in keys}
    out["residual"] = {key: (flipped[key], _block_of(ref["residual"], specs["residual"], key,
                                                     layout, dev) + steps[key] * scales[i])
                       for i, key in enumerate(keys)}
    out["params"] = {key: (flipped[key] | ill[key], own)
                     for key, own in zip(keys, tree_leaves(own_p))}
    for part, tree in (("mu", mv_opt.mu), ("nu", mv_opt.nu)):
        out[part] = {key: (flipped[key], t) for key, t in zip(keys, tree_leaves(tree))}
    return out


def load_case(case, cfg, dev) -> Dict:
    """A step job's whole params and tokens (and, for an arch with a
    frontend, its rows' ``"frontend"`` frames): saved at a path (read
    lazily, ``mmap``), or {"seed", "batch", "seq"}: ``init_params`` from a
    generator seeded with ``seed`` and uniform tokens from ``seed + 1``, on
    ``dev``."""
    if not isinstance(case, dict):
        return torch.load(case, mmap=True, weights_only=False)
    params = init_params(cfg, torch.Generator(dev).manual_seed(case["seed"]), dev)
    tokens = torch.randint(0, cfg.vocab_size, (case["batch"], case["seq"]), device=dev,
                           generator=torch.Generator(dev).manual_seed(case["seed"] + 1))
    return {"params": params, "tokens": tokens}


def _step_job(job: Dict, dev) -> Dict:
    cfg, tcfg = job["cfg"], job["tcfg"]
    mesh = mesh_lib.make_mesh(*job["mesh"], dev.type)
    step = make_train_step(cfg, tcfg, mesh, job.get("row_groups", 1))
    layout, specs = step.layout, step.specs
    case = load_case(job["case"], cfg, dev)
    params = tree_map(lambda t: t.to(dev), sharding.shard_tree(case["params"], specs["params"],
                                                               mesh))
    residual = compress.init_residual(params) if tcfg.grad_compression == "int8_ef" else \
        torch.zeros((), device=dev)
    bspec = sharding.batch_spec(mesh)
    tokens = layout.block(case["tokens"], bspec).to(dev)
    frontend = None if case.get("frontend") is None else \
        layout.block(case["frontend"], sharding.spec(*bspec, None)).to(dev)
    del case
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params0, opt0 = params, adamw_init(params)   # the step leaves its inputs as they were
    dist.barrier()
    t0 = time.perf_counter()
    params, opt, residual, m = step(params0, opt0, residual, tokens, frontend)
    _sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    state = {"params": params, "opt": opt, "residual": residual}
    res = {"name": job["name"], "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           **layout.counts, "bytes": layout.bytes, "activation_bytes": layout.activation_bytes,
           "activation_kinds": layout.activation_kinds, "relay_steps": layout.relay_steps,
           "positions": layout.positions, "wall_ms": wall,
           "resident_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(state)),
           "refs": {}}
    if dev.type == "cuda":
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    rtol, atol, loss_rtol = job["tol"]
    refs = dict(job["refs"])
    if job.get("single_ref"):
        # the single device's step on this rank's card, after the sharded one
        case = load_case(job["case"], cfg, dev)
        refs["single device"] = single_device_reference(
            cfg, tcfg, tree_map(lambda t: t.to(dev), case["params"]), case["tokens"].to(dev),
            host=False, frontend=None if case.get("frontend") is None else
            case["frontend"].to(dev))
        res["single_wall_ms"] = refs["single device"]["wall_ms"]
        res["single_peak_gib"] = refs["single device"].get("peak_gib")
        del case
    for name, ref in refs.items():
        if not isinstance(ref, dict):
            ref = torch.load(ref, mmap=True, weights_only=False)
        scales = ref["scales"]
        out = {"loss_rel_err": abs(res["loss"] - ref["loss"]) / abs(ref["loss"]),
               "grad_norm_rel_err": abs(res["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
               "count": int(opt.count) == int(ref["opt"].count), "max_abs_err": {}}
        ok = out["count"] and out["loss_rel_err"] <= loss_rtol and \
            out["grad_norm_rel_err"] <= rtol
        steps = None
        if scales is not None:
            steps, expected = _rounding_flips(residual, ref["residual"], specs["residual"],
                                              layout, scales)
            out["rounding_flips"] = sum(int((k != 0).sum()) for k in steps.values())
            out["flips_expected"] = expected
            out["elements"] = sum(k.numel() for k in steps.values())
            ok &= out["rounding_flips"] <= flips_bound(expected)
        moved = _moved(ref, opt, params0, opt0, specs, layout, tcfg, steps, scales)
        # the params held to another value than the reference's: how many,
        # how many of them are off the reference's tolerance, and how far
        out["moved"], out["moved_off_reference"], out["moved_abs_err"] = 0, 0, 0.0
        for key, (mask, _) in moved["params"].items():
            if mask.any():
                want = _block_of(ref["params"], specs["params"], key, layout, mask.device)[mask]
                d = (sharding.leaf_at(params, key).float()[mask] - want).abs()
                out["moved"] += int(mask.sum())
                out["moved_off_reference"] += int((d > atol + rtol * want.abs()).sum())
                out["moved_abs_err"] = max(out["moved_abs_err"], float(d.max()))
        del steps
        parts = [("residual", residual, ref["residual"], specs["residual"]),
                 ("params", params, ref["params"], specs["params"]),
                 ("mu", opt.mu, ref["opt"].mu, specs["opt"].mu),
                 ("nu", opt.nu, ref["opt"].nu, specs["opt"].nu)]
        for part, got, want, sp in parts:
            good, worst, off = _held(got, want, sp, layout, rtol, atol, moved.get(part))
            out["max_abs_err"][part] = worst
            if off:
                out.setdefault("off", {})[part] = off[:5]
            ok &= good
        del moved
        out["ok"] = ok
        res["refs"][name] = out
        del ref
    del refs
    del params0, opt0
    if job.get("save"):
        t0 = time.perf_counter()
        whole = ckpt.save_sharded(job["save"], int(opt.count), state, cfg, mesh, specs)
        if whole is not None:
            torch.save(whole, Path(job["save"]) / "whole.pt")
        del whole
        dist.barrier()
        res["save_s"] = time.perf_counter() - t0
    walls = []
    if job.get("timed_after"):
        t0 = time.perf_counter()
        while not Path(job["timed_after"]).exists():
            if time.perf_counter() - t0 > 600:
                raise TimeoutError(f"no file at {job['timed_after']} after 600 s")
            time.sleep(0.05)
    for _ in range(job.get("timed", 0)):
        dist.barrier()
        t0 = time.perf_counter()
        params, opt, residual, m = step(params, opt, residual, tokens, frontend)
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    res["timed_wall_ms"] = walls
    return res


def _restore_job(job: Dict, dev) -> Dict:
    cfg, tcfg = job["cfg"], job["tcfg"]
    mesh = mesh_lib.make_mesh(*job["mesh"], dev.type)
    template, specs = elastic.block_template(cfg, tcfg, mesh, dev)
    t0 = time.perf_counter()
    step, tree = ckpt.restore(job["dir"], template, cfg, mesh=mesh, specs=specs)
    restore_s = time.perf_counter() - t0
    whole = torch.load(job["whole"], mmap=True, weights_only=False)
    layout = MeshLayout(mesh)
    same = []

    def held(key, t, sp):
        want = layout.block(sharding.leaf_at(whole, key), sp)
        same.append(t.dtype == want.dtype and torch.equal(t.cpu(), want))
    sharding.map_specs(held, tree, specs)
    return {"name": job["name"], "step": step, "leaves": len(same), "bitwise": all(same),
            "restore_s": restore_s, "held_s": time.perf_counter() - t0 - restore_s,
            "resident_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(tree))}


JOBS = {"step": _step_job, "restore": _restore_job}


def run_jobs(jobs: List[Dict], dev) -> List[Dict]:
    """Every job on this rank of the initialised world (TF32 off)."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return [JOBS[j["kind"]](j, dev) for j in jobs]


def check_rank(rank: int, world: int, dev, jobs_path: str, out_dir: str) -> None:
    """The spawned rank: the jobs at ``jobs_path``, results to
    ``<out_dir>/rank<r>.json``."""
    results = run_jobs(torch.load(jobs_path, weights_only=False), dev)
    out = {"rank": rank, "world": world, "device": str(dev), "jobs": results}
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out, indent=1))


def run_checks(jobs: List[Dict], world: int, backend: str, out_dir,
               timeout: float = 600.0) -> List[Dict]:
    """``jobs`` on ``world`` spawned ranks (``launch.ranks``) on the card;
    every rank's results."""
    from repro_torch.launch import ranks
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.save(jobs, out / "jobs.pt")
    ranks.spawn(check_rank, world, backend, "cuda", args=(str(out / "jobs.pt"), str(out)),
                timeout=timeout, store_dir=str(out))
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
