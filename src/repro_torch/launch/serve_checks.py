"""The serving cells across ranks held against the single device, in
spawned ranks: the spawned half of ``chip_smoke.py`` phase 14 and of the
card and CPU tests of ``models.prefill_sharded`` and the batched
``models.nsa_sharded.decode_step_sharded`` — the serving counterpart of
``launch.train_checks``.

A check is a list of jobs (dicts); every rank of a world runs them in order
(``check_rank``, spawned by ``run_checks``) and writes its results to
``<out_dir>/rank<r>.json``. A ``"serve"`` job builds the mesh ``mesh``
(shape, axes), cuts its ``ServeWeights`` from the whole params of ``case``
(saved at a path, or drawn from a seed: ``load_case``; on a card the ranks
draw in turn, after the file at ``after`` exists when the job names one)
and its rows of the prompt (B, S) and of the decode tokens (B, K)
(``batch_spec``), runs
``prefill_sharded`` to ``max_len`` and then K ``decode_step_sharded``
tokens (``seq_axes = ("model",)``), and holds against ``reference``'s
single-device results (``ref``: a file, read once it exists; with
``single_ref`` computed on the rank's own device from the whole params after
the sharded run; with ``plain_ref`` too, the decode once more on the plain
``nsa_verify_ref``, ``plain_nsa_layers``):

  * the prefill's logits (the rank's vocab slice of the last position's)
    and every leaf of its cache slices (``local_block`` of the whole caches
    under ``cache_specs(shard_sequence=False)``: K/V rows, compressed
    blocks and recurrent states);
  * each decode token's logits slice, and the cache slices after the last
    token (the compressed blocks the tokens completed included; each
    layer's largest difference in ``layer_err``), against either decode;

within ``tol`` = (rtol, atol) (``held``: each part's verdict, ``ok``: all
of them, or the parts the job names in ``hold``; ``max_abs_err``: each
part's largest difference). It records
which compressed blocks the rank wrote during the decode and which of them
have rows outside its K/V slice (written across the ``model`` boundary),
for a MoE arch whose rows lie over data ranks the decode's expert
assignments dropped by the whole batch's groups against per-rank groups
(``moe_drops``: ``counting_moe_drops``),
the collectives (``nsa_sharded.
collectives``: of the prefill, and per decode token), the weights' gathers
and their bytes (``MeshLayout``), walls, the seconds waited for ``after``,
and on a card the peak while the rank drew the whole params and after. The
logits slices go to ``<out>/rank<r>_<name>.pt`` when the job names ``out``, for the
caller to assemble the whole vocabulary and compare argmax (with
``single_ref``, rank 0 puts the single device's logits beside them, in
``<out>/single_<name>.pt``).
"""
from __future__ import annotations

import contextlib
import gc
import json
import time
from pathlib import Path
from typing import Dict, List

import torch
import torch.distributed as dist

from repro_torch.bridge import init_params
from repro_torch.launch import mesh as mesh_lib, sharding
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.models import attention, model, moe as moe_lib, nsa as nsa_lib, nsa_sharded
from repro_torch.models.prefill_sharded import SEQ_AXES, prefill_sharded
from repro_torch.optim import tree_map
from repro_torch.runtime.sharded import ServeWeights


def load_case(case, cfg, dev) -> Dict:
    """A serve job's whole params, prompt and decode tokens (and, for an
    arch with a frontend, the rows' ``"frontend"`` frames): saved
    at a path (read lazily, ``mmap``), or {"seed", "batch", "seq",
    "decode"[, "frames"]}: ``init_params`` from a generator seeded with
    ``seed``, the prompt (batch, seq) uniform from ``seed + 1``, the decode
    tokens (batch, decode) from ``seed + 2`` and ``frames`` standard normal
    frames a row from ``seed + 3``, on ``dev``."""
    if not isinstance(case, dict):
        return torch.load(case, mmap=True, weights_only=False)
    gen = lambda s: torch.Generator(dev).manual_seed(s)
    params = init_params(cfg, gen(case["seed"]), dev)
    tokens = torch.randint(0, cfg.vocab_size, (case["batch"], case["seq"]), device=dev,
                           generator=gen(case["seed"] + 1))
    decode = torch.randint(0, cfg.vocab_size, (case["batch"], case["decode"]), device=dev,
                           generator=gen(case["seed"] + 2))
    out = {"params": params, "tokens": tokens, "decode": decode}
    if case.get("frames"):
        out["frontend"] = torch.randn((case["batch"], case["frames"], cfg.frontend_dim),
                                      device=dev, generator=gen(case["seed"] + 3))
    return out


def _clone_caches(caches) -> Dict:
    return {"layers": [{p: {k: t.clone() for k, t in c[p].items()} for p in c}
                       for c in caches["layers"]], "length": caches["length"].clone()}


@contextlib.contextmanager
def counting_moe_drops(cfg, n_rows: int, drops: Dict):
    """Within it, each MoE dispatch of the batched decode across ``n_rows``
    data ranks (whose groups hold the gathered ids of every rank's rows)
    adds to ``drops`` the assignments that the whole group drops
    ("whole"), that groups cut from each data rank's rows would drop
    ("per_rank") and that only the whole group drops ("whole_only"): what
    the decode's gather of the expert ids changes."""
    dispatch = moe_lib.dispatch

    def kept(ids):
        G = moe_lib.group_size(ids.shape[0], cfg.moe)
        return dispatch(ids, G, moe_lib.capacity(G, cfg.moe), cfg.moe.num_experts)[1]

    def counted(ids, G, C, E):
        out = dispatch(ids, G, C, E)
        whole = out[1]
        rank = torch.cat([kept(p) for p in ids.reshape(n_rows, -1, ids.shape[-1])])
        drops["whole"] += int((~whole).sum())
        drops["per_rank"] += int((~rank).sum())
        drops["whole_only"] += int((~whole & rank).sum())
        return out

    moe_lib.dispatch = counted
    try:
        yield
    finally:
        moe_lib.dispatch = dispatch


@contextlib.contextmanager
def plain_attention_layers():
    """Within it, ``model``'s dense and windowed layers run the flash
    kernel's plain version (``kernels.flash.ref``) on any device in place
    of the kernel: the counterpart of ``plain_nsa_layers`` for the native
    attention archs."""
    kernel = attention.flash_ops.flash_verify
    attention.flash_ops.flash_verify = flash_ref.ref_flash_verify
    try:
        yield
    finally:
        attention.flash_ops.flash_verify = kernel


@contextlib.contextmanager
def plain_nsa_layers():
    """Within it, ``model``'s NSA layers run ``nsa.nsa_verify_ref``, the
    plain PyTorch oracle, on any device in place of the kernels: a second
    single-device reference for the checks, never a served path."""
    kernel = model.nsa_ops.nsa_verify_kernel_layer

    def plain(params, cfg, x, cache, cmp_cache, prefix_len, positions, tree_mask,
              sel_idx=None, sel_valid=None, reuse=False, **_):
        return nsa_lib.nsa_verify_ref(params, cfg, x, cache, cmp_cache, prefix_len, positions,
                                      tree_mask, *((sel_idx, sel_valid) if reuse else ()))

    model.nsa_ops.nsa_verify_kernel_layer = plain
    try:
        yield
    finally:
        model.nsa_ops.nsa_verify_kernel_layer = kernel


@torch.no_grad()
def reference(params, cfg, tokens, decode, max_len: int, host: bool = True,
              plain_decode: bool = False, frontend=None) -> Dict:
    """The single device: ``model.prefill`` (after ``frontend``'s frames,
    if any) with the last position's logits (the JAX ``prefill_step``),
    then one ``model.decode_step`` per column of ``decode``.
    {"prefill_logits", "prefill_caches", "decode_logits" (K, B, 1, V),
    "caches"} on the host when ``host``, with the passes' walls on the
    device's clock ("prefill_ms", "decode_ms"). With ``plain_decode`` the
    decode also runs from the same prefill under ``plain_nsa_layers`` and
    ``plain_attention_layers``: "plain_decode_logits", "plain_caches"."""
    dev = tokens.device
    move = (lambda t: t.cpu()) if host else (lambda t: t)
    _sync(dev)
    t0 = time.perf_counter()
    hidden, caches = model.prefill(params, cfg, tokens, max_len, frontend)
    logits = model.logits_fn(params, cfg, hidden[:, -1:])
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del hidden
    out = {"prefill_logits": move(logits), "prefill_caches": tree_map(move, _clone_caches(caches))}
    if plain_decode:
        plain = _clone_caches(caches)
        with plain_nsa_layers(), plain_attention_layers():
            steps = [model.decode_step(params, cfg, plain, decode[:, t:t + 1])[0]
                     for t in range(decode.shape[1])]
        out.update(plain_decode_logits=move(torch.stack(steps)),
                   plain_caches=tree_map(move, plain))
        del plain, steps
    steps, walls = [], []
    for t in range(decode.shape[1]):
        t0 = time.perf_counter()
        lg, caches = model.decode_step(params, cfg, caches, decode[:, t:t + 1])
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append(move(lg))
    out.update(decode_logits=torch.stack(steps) if steps else None,
               caches=tree_map(move, _clone_caches(caches)), prefill_ms=prefill_ms,
               decode_ms=walls)
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cache_err(local, whole, mesh, rtol: float, atol: float, per_layer=None,
               shard_sequence: bool = False):
    """(ok, max abs error) of this rank's cache slices against the same
    blocks of the whole caches under ``cache_specs(shard_sequence=...)``,
    leaf by leaf; each layer's max abs error appended to ``per_layer`` when
    given."""
    shape, coords = mesh_lib.mesh_shape(mesh), mesh_lib.mesh_coords(mesh)
    specs = sharding.cache_specs({"layers": whole["layers"]}, mesh,
                                 shard_sequence=shard_sequence)
    ok, worst = True, 0.0
    for got_l, want_l, sp_l in zip(local["layers"], whole["layers"], specs["layers"]):
        layer = 0.0
        for part in want_l:
            for name, w in want_l[part].items():
                want = sharding.local_block(w, sp_l[part][name], shape, coords)
                want = want.to(got_l[part][name].device).float()
                got = got_l[part][name].float()
                ok &= bool(torch.allclose(got, want, rtol=rtol, atol=atol))
                layer = max(layer, float((got - want).abs().max()))
        worst = max(worst, layer)
        if per_layer is not None:
            per_layer.append(layer)
    return ok, worst


def _logit_err(got, want, rows, vocab, rtol: float, atol: float):
    """(ok, max abs error) of a logits slice (rows, 1, V / m) against the
    same rows and vocab slice of whole logits (B, 1, V)."""
    w = want[rows[0]:rows[1], :, vocab[0]:vocab[1]].to(got.device).float()
    g = got.float()
    return bool(torch.allclose(g, w, rtol=rtol, atol=atol)), float((g - w).abs().max())


def _serve_job(job: Dict, dev) -> Dict:
    cfg, max_len = job["cfg"], job["max_len"]
    rtol, atol = job["tol"]
    mesh = mesh_lib.make_mesh(*job["mesh"], dev.type)
    t0 = time.perf_counter()
    if job.get("after"):
        _when_written(job["after"])
    waited_s = time.perf_counter() - t0
    # on a card the ranks draw the whole params in turn: each keeps its blocks
    # and hands the rest back before the next draws, so the card holds one
    # whole tree at a time however many ranks share it
    turns = range(dist.get_world_size()) if dev.type == "cuda" else [dist.get_rank()]
    for turn in turns:
        if turn == dist.get_rank():
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            case = load_case(job["case"], cfg, dev)
            view = ServeWeights.from_whole(tree_map(lambda t: t.to(dev), case["params"]),
                                           cfg, mesh)
            layout = view.layout
            bspec = sharding.batch_spec(mesh)
            tokens = layout.block(case["tokens"], bspec).to(dev)
            decode = layout.block(case["decode"], bspec).to(dev)
            frontend = None if case.get("frontend") is None else \
                layout.block(case["frontend"], sharding.spec(*bspec, None)).to(dev)
            del case
            gc.collect()
            _sync(dev)
            if dev.type == "cuda":
                load_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                torch.cuda.empty_cache()
        dist.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    nsa_sharded.reset_collectives()
    layout.reset_counts()
    t0 = time.perf_counter()
    logits, caches = prefill_sharded(view, cfg, mesh, tokens, max_len, frontend=frontend)
    _sync(dev)
    res = {"name": job["name"], "mesh": list(job["mesh"][0]), "coords": layout.coords,
           "vocab": list(view.vocab), "rows": list(caches["global_rows"]["batch"]),
           "kv_rows": list(caches["global_rows"]["kv"]),
           "cmp_rows": list(caches["global_rows"]["cmp"]),
           "resident_weight_bytes": view.resident_bytes(),
           "prefill": {"wall_ms": (time.perf_counter() - t0) * 1e3,
                       "collectives": nsa_sharded.collectives(), **layout.counts,
                       "gathered_bytes": layout.bytes}}
    prefill_logits, prefill_caches = logits, _clone_caches(caches)
    cmp0 = [{k: t.clone() for k, t in c["cmp"].items()} for c in caches["layers"] if "cmp" in c]
    drops = {"whole": 0, "per_rank": 0, "whole_only": 0}
    n_rows = layout.n_dp if cfg.moe is not None else 1
    counting = (lambda: counting_moe_drops(cfg, n_rows, drops)) if n_rows > 1 else \
        contextlib.nullcontext
    steps, walls, per_token = [], [], []
    for t in range(decode.shape[1]):
        nsa_sharded.reset_collectives()
        layout.reset_counts()
        dist.barrier()
        t0 = time.perf_counter()
        with counting():
            lg, caches = nsa_sharded.decode_step_sharded(view, cfg, mesh, caches,
                                                         decode[:, t:t + 1], SEQ_AXES)
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        per_token.append((nsa_sharded.collectives(), layout.counts["gathers"], layout.bytes))
        steps.append(lg)
    res["decode"] = {"wall_ms": walls,
                     "collectives_per_token": sorted({c for c, _, _ in per_token}),
                     "gathers_per_token": sorted({g for _, g, _ in per_token}),
                     "gathered_bytes_per_token": sorted({b for _, _, b in per_token}),
                     "moe_drops": drops}
    res["waited_s"] = waited_s
    if dev.type == "cuda":
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        res["load_peak_gib"] = load_peak
    # the compressed blocks this rank wrote, and those whose rows it does not all hold
    c0, (r0, r1) = caches["global_rows"]["cmp"][0], caches["global_rows"]["kv"]
    nsa = cfg.nsa
    cmp1 = [c["cmp"] for c in caches["layers"] if "cmp" in c]
    written = sorted({c0 + int(j) for before, c in zip(cmp0, cmp1)
                      for j in (c["k_cmp"] != before["k_cmp"]).flatten(2).any(-1)
                      .any(0).nonzero()[:, 0].tolist()})
    res["written_blocks"] = written
    res["across_boundary"] = [j for j in written
                              if j * nsa.cmp_stride < r0 or j * nsa.cmp_stride + nsa.cmp_block > r1]
    del cmp0, cmp1
    if job.get("out"):
        out = Path(job["out"])
        out.mkdir(parents=True, exist_ok=True)
        torch.save({"prefill": prefill_logits.float().cpu(),
                    "decode": torch.stack(steps).float().cpu() if steps else None,
                    "vocab": view.vocab, "rows": res["rows"]},
                   out / f"rank{dist.get_rank()}_{job['name']}.pt")
    if job.get("single_ref"):
        del view
        case = load_case(job["case"], cfg, dev)
        ref = reference(tree_map(lambda t: t.to(dev), case["params"]), cfg,
                        case["tokens"].to(dev), case["decode"].to(dev), max_len, host=False,
                        plain_decode=job.get("plain_ref", False),
                        frontend=None if case.get("frontend") is None else
                        case["frontend"].to(dev))
        del case
        res["single"] = {"prefill_ms": ref["prefill_ms"], "decode_ms": ref["decode_ms"]}
        if job.get("out") and dist.get_rank() == 0:
            torch.save({k: ref[k].float().cpu() for k in ("prefill_logits", "decode_logits")},
                       Path(job["out"]) / f"single_{job['name']}.pt")
        if dev.type == "cuda":
            res["single"]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    else:
        ref = torch.load(_when_written(job["ref"]), mmap=True, weights_only=False)
    rows, vocab = res["rows"], res["vocab"]
    errs, held = {}, {}
    held["prefill_logits"], errs["prefill_logits"] = _logit_err(
        prefill_logits, ref["prefill_logits"], rows, vocab, rtol, atol)
    held["prefill_caches"], errs["prefill_caches"] = _cache_err(
        prefill_caches, ref["prefill_caches"], mesh, rtol, atol)
    del prefill_caches
    if steps:
        held["decode_logits"], errs["decode_logits"] = _steps_err(
            steps, ref["decode_logits"], rows, vocab, rtol, atol)
    layers = res["layer_err"] = {"caches": []}
    held["caches"], errs["caches"] = _cache_err(caches, ref["caches"], mesh, rtol, atol,
                                                layers["caches"])
    if "plain_caches" in ref:
        held["plain_decode_logits"], errs["plain_decode_logits"] = _steps_err(
            steps, ref["plain_decode_logits"], rows, vocab, rtol, atol)
        layers["plain_caches"] = []
        held["plain_caches"], errs["plain_caches"] = _cache_err(
            caches, ref["plain_caches"], mesh, rtol, atol, layers["plain_caches"])
    res.update(max_abs_err=errs, held=held,
               ok=all(held[k] for k in job.get("hold", held)))
    del ref, caches
    return res


def _when_written(path, timeout: float = 600.0) -> str:
    """``path`` once it exists: a caller may write the reference while the
    ranks run (it renames the finished file into place)."""
    t0 = time.perf_counter()
    while not Path(path).exists():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"no file at {path} after {timeout:.0f} s")
        time.sleep(0.05)
    return str(path)


def _steps_err(steps, want, rows, vocab, rtol: float, atol: float):
    """``_logit_err`` over every decode token."""
    ok, worst = True, 0.0
    for got, w in zip(steps, want):
        o, e = _logit_err(got, w, rows, vocab, rtol, atol)
        ok &= o
        worst = max(worst, e)
    return ok, worst


JOBS = {"serve": _serve_job}


def run_jobs(jobs: List[Dict], dev) -> List[Dict]:
    """Every job on this rank of the initialised world (TF32 off), the
    job's garbage collected and a card's cached blocks handed back after
    each (ranks share the card)."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = []
    for j in jobs:
        out.append(JOBS[j.get("kind", "serve")](j, dev))
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


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


def assemble(out_dir, name: str, world: int) -> Dict[str, torch.Tensor]:
    """The whole logits of job ``name`` from every rank's slice file:
    {"prefill": (B, 1, V), "decode": (K, B, 1, V)} on the host."""
    parts = [torch.load(Path(out_dir) / f"rank{r}_{name}.pt", weights_only=False)
             for r in range(world)]
    B = max(p["rows"][1] for p in parts)
    V = max(p["vocab"][1] for p in parts)
    out = {}
    for key in ("prefill", "decode"):
        if parts[0][key] is None:
            out[key] = None
            continue
        lead = parts[0][key].shape[:-3]
        whole = torch.zeros(lead + (B, 1, V))
        for p in parts:
            whole[..., p["rows"][0]:p["rows"][1], :, p["vocab"][0]:p["vocab"][1]] = p[key]
        out[key] = whole
    return out
