"""The recurrent mixers in the split train step (``models.train_sharded``:
each ``model`` rank runs an RG-LRU, mLSTM or sLSTM layer on its own
positions, its state carried from the ranks before it and the state's
gradient carried back) on gloo ranks on the CPU:

  * against the JAX single-device ``make_train_step`` (bridged weights): a
    reduced recurrentgemma period (rglru, rglru, attn) and a reduced xlstm
    period (mlstm, slstm) on (1, 2), 2 rows of 65 tokens (chunks of 33 and
    32: the RG-LRU conv window straddles the cut). Loss rtol 1e-5; params
    and both moments (so, through the first moment, every gradient leaf)
    rtol 2e-4 / atol 2e-5; and against the port's single-device step;
  * against the port's single-device step on (1, 4) (chunks of 17, 17, 17
    and 14: a fold over three predecessors, a relay through four ranks):
    xlstm over 2 micro-batches of one row (remat on); xlstm with the sLSTM
    relay over 2 row groups (remat off); recurrentgemma (remat on);
  * the activation collectives a recurrent layer issues (forward, remat
    recompute, backward) on every rank, by count and bytes, equal
    ``carry_collectives`` below (the numbers of ``PERF.md`` §2): the carries'
    size, with no factor of the stream's S;
  * a spy: every recurrent mixer's conv, scan, summary and relay on a rank
    receives the rank's positions (the conv also the cw - 1 window rows),
    never the stream;
  * the relay's idle share is (m - 1) / (g + m - 1) of its steps;
  * a chunk shorter than the conv window that the next rank reads raises,
    naming the chunk.

Both worlds run side by side (``launch.ranks.spawn``, a ``FileStore`` in
``tmp_path``, one thread per rank, each its own timeout) while this process
computes the JAX references; a rank waits for a job's reference files
before its step. JAX is imported inside the fixture, so the ranks import
only torch and the port."""
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL, ATOL, LOSS_RTOL = 2e-4, 2e-5, 1e-5
TOL = (RTOL, ATOL, LOSS_RTOL)
ARCHS = {"rg": ("recurrentgemma-9b", 3), "xl": ("xlstm-125m", 2)}
S = 65

# {job name: (world, case, model ranks, rows, TrainConfig overrides, row groups, refs)}
JOBS = {
    "recurrentgemma (1, 2)": (2, "rg", 2, 2, {}, 1, ("jax", "port")),
    "xlstm (1, 2)": (2, "xl", 2, 2, {}, 1, ("jax", "port")),
    "xlstm (1, 4) micro-batches 2": (4, "xl", 4, 2, {"micro_batches": 2}, 1, ("port",)),
    "xlstm (1, 4) row groups 2": (4, "xl", 4, 2, {"remat": False}, 2, ("port",)),
    "recurrentgemma (1, 4)": (4, "rg", 4, 2, {}, 1, ("port",)),
}


def _tcfg(over):
    from repro_torch.config import TrainConfig
    return TrainConfig(steps=1, learning_rate=1e-3, **over)


def _case_name(name):
    _, case, _, rows, over, _, _ = JOBS[name]
    return f"{case}_{rows}_{'_'.join(f'{k}{v}' for k, v in sorted(over.items()))}"


def carry_collectives(cfg, kinds, m, B, g, remat, micro):
    """(count, bytes) of a step's recurrent activation collectives on one
    rank: per layer and micro-batch of B rows, each pass (the forward, a
    remat recompute) and the backward issue an RG-LRU's 2 (the conv window
    (m, B, cw - 1, sd) and the (A, h) summaries (m, B, 2, sd), float32), an
    mLSTM's 1 ((m, B, H, dh^2 + dh + 2)) and an sLSTM's g + m - 1 ((m, 4,
    B / g, d)); a gather counts its output, a reduce-scatter its input."""
    from repro_torch.models import recurrent
    sd, cw = recurrent.rglru_dims(cfg)
    H = recurrent.mlstm_heads(cfg)
    dh = cfg.d_model // H
    per = {"rglru": (2, m * B * (cw - 1) * sd * 4 + m * B * 2 * sd * 4),
           "mlstm": (1, m * B * H * (dh * dh + dh + 2) * 4),
           "slstm": (g + m - 1, (g + m - 1) * m * 4 * (B // g) * cfg.d_model * 4)}
    passes = 3 if remat else 2
    n = sum(per[k][0] for k in kinds if k in per) * passes * micro
    nbytes = sum(per[k][1] for k in kinds if k in per) * passes * micro
    return n, nbytes


# ---------------------------------------------------------------- the ranks
SPIED = (("recurrent", "_causal_conv"), ("recurrent", "_linear_scan"),
         ("recurrent", "mlstm_scan"), ("recurrent", "_slstm_scan"),
         ("recurrent_sharded", "mlstm_summary"))


def _spied(job, dev):
    """``job`` with spies on the recurrent mixers' sequence functions: each
    call's (function, positions it received, conv window rows)."""
    from repro_torch.launch import train_checks
    from repro_torch.models import recurrent, recurrent_sharded
    mods = {"recurrent": recurrent, "recurrent_sharded": recurrent_sharded}
    seen, saved = [], {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            if name == "_causal_conv":
                x, window = a[1], a[2] if len(a) > 2 else kw.get("window")
                seen.append((name, x.shape[1], 0 if window is None else window.shape[1]))
            elif name in ("_linear_scan", "mlstm_summary"):
                seen.append((name, a[0].shape[1], 0))
            else:
                seen.append((name, a[1].shape[1] if name == "_slstm_scan" else a[0].shape[1], 0))
            return fn(*a, **kw)
        return wrapped

    for mod, name in SPIED:
        saved[(mod, name)] = getattr(mods[mod], name)
        setattr(mods[mod], name, spy(name, saved[(mod, name)]))
    try:
        out = train_checks.run_jobs([job], dev)[0]
    finally:
        for (mod, name), fn in saved.items():
            setattr(mods[mod], name, fn)
    return dict(out, seen=seen)


def _rank(rank, world, dev, tmp, out_dir):
    """This world's jobs, each once its reference files exist; results to
    rank<r>.pt."""
    import torch.distributed as dist
    tmp = Path(tmp)
    res = []
    for name, (w, case, m, rows, over, g, refs) in JOBS.items():
        if w != world:
            continue
        paths = {r: tmp / f"ref_{_case_name(name)}_{r}.pt" for r in refs}
        t0 = time.time()
        while not all(p.exists() for p in paths.values()):
            if time.time() - t0 > 200:
                raise TimeoutError(f"{name}: no reference files after 200 s")
            time.sleep(0.05)
        job = dict(kind="step", name=name, mesh=((1, m), ("data", "model")),
                   case=str(tmp / f"{_case_name(name)}.pt"),
                   refs={r: str(p) for r, p in paths.items()}, tol=TOL, row_groups=g,
                   **torch.load(tmp / f"cfg_{_case_name(name)}.pt", weights_only=False))
        res.append(_spied(job, dev))
    dist.barrier()
    torch.save({"jobs": res}, Path(out_dir) / f"rank{rank}.pt")


# ---------------------------------------------------------------- the references
def _publish(obj, path):
    torch.save(obj, path.with_suffix(".part"))
    path.with_suffix(".part").rename(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Port references first, then both worlds side by side while the JAX
    references are computed here."""
    import jax
    import jax.numpy as jnp
    from repro import config as jconfig, configs as jcfg
    from repro.models import model as jmodel
    from repro.optim import adamw_init as jadamw_init
    from repro.runtime.trainer import make_train_step as jmake_train_step
    from repro_torch import configs
    from repro_torch.bridge import from_jax
    from repro_torch.launch import ranks, train_checks
    from repro_torch.optim import AdamWState
    tmp = tmp_path_factory.mktemp("sharded_train_recurrent")
    host = lambda tree: jax.tree.map(np.asarray, tree)
    jax_cases = {}
    for i, (case, (arch, layers)) in enumerate(ARCHS.items()):
        jc, tc = jcfg.reduced(arch, layers=layers), configs.reduced(arch, layers=layers)
        jp = jmodel.init(jax.random.PRNGKey(90 + i), jc)
        jtoks = jax.random.randint(jax.random.PRNGKey(95 + i), (2, S), 0, jc.vocab_size)
        jax_cases[case] = (jc, tc, jp, jtoks, from_jax(host(jp), tc, "cpu"),
                           torch.from_numpy(np.array(jtoks)).long())
    done = set()
    for name, (_, case, _, rows, over, _, _) in JOBS.items():
        key = _case_name(name)
        if key in done:
            continue
        done.add(key)
        tc, params, tokens = jax_cases[case][1], jax_cases[case][4], jax_cases[case][5]
        tokens = tokens[:rows]
        tcfg = _tcfg(over)
        torch.save({"params": params, "tokens": tokens}, tmp / f"{key}.pt")
        torch.save({"cfg": tc, "tcfg": tcfg}, tmp / f"cfg_{key}.pt")
        _publish(train_checks.single_device_reference(tc, tcfg, params, tokens),
                 tmp / f"ref_{key}_port.pt")

    def world_run(world):
        d = tmp / f"world{world}"
        d.mkdir()
        ranks.spawn(_rank, world, "gloo", "cpu", args=(str(tmp), str(d)), timeout=240,
                    threads=1, store_dir=str(d))
        return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]

    out = {"jax_loss": {}}
    with ThreadPoolExecutor(2) as pool:
        worlds = {w: pool.submit(world_run, w) for w in (2, 4)}
        jt = jconfig.TrainConfig(steps=1, learning_rate=1e-3)
        for name, (_, case, _, rows, over, _, refs) in JOBS.items():
            if "jax" not in refs:
                continue
            jc, tc, jp, jtoks = jax_cases[case][:4]
            p1, o1, _, m1 = jmake_train_step(jc, jt, donate=False)(
                jp, jadamw_init(jp), jnp.zeros(()), jtoks[:rows])
            state = AdamWState(mu=from_jax(host(o1.mu), tc, "cpu"),
                               nu=from_jax(host(o1.nu), tc, "cpu"),
                               count=torch.tensor(int(o1.count), dtype=torch.int32))
            _publish(train_checks.reference(m1, from_jax(host(p1), tc, "cpu"), state,
                                            torch.zeros(())),
                     tmp / f"ref_{_case_name(name)}_jax.pt")
            out["jax_loss"][name] = float(m1["loss"])
        got = {w: f.result() for w, f in worlds.items()}
    out["jobs"] = {}
    for w, ranks_of in got.items():
        for r in ranks_of:
            for job in r["jobs"]:
                out["jobs"].setdefault(job["name"], []).append(job)
    out["tmp"] = tmp
    return out


def _cfg(runs, name):
    return torch.load(runs["tmp"] / f"cfg_{_case_name(name)}.pt", weights_only=False)


# ---------------------------------------------------------------- the step
@pytest.mark.parametrize("name", [n for n, j in JOBS.items() if "jax" in j[-1]])
def test_split_recurrent_step_equals_the_jax_step(runs, name):
    """On (1, 2), 33 and 32 of 65 positions a rank: every rank's loss
    within rtol 1e-5 of the JAX step's, and every block of its new params
    and moments within rtol 2e-4 / atol 2e-5 of the JAX step's and of the
    port's single-device step's."""
    want = runs["jax_loss"][name]
    for job in runs["jobs"][name]:
        for ref in ("jax", "port"):
            assert job["refs"][ref]["ok"], (ref, job["refs"][ref])
        assert abs(job["loss"] - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("name", [n for n, j in JOBS.items() if "jax" not in j[-1]])
def test_split_recurrent_step_equals_the_single_device_step(runs, name):
    """On (1, 4): the fold over three predecessors, the relay through four
    ranks, two micro-batches (each carries its own states from the initial
    one), the relay over two row groups, remat on and off."""
    jobs = runs["jobs"][name]
    assert len(jobs) == JOBS[name][0]
    for job in jobs:
        assert job["refs"]["port"]["ok"], job["refs"]["port"]
        assert job["loss"] == jobs[0]["loss"]


@pytest.mark.parametrize("name", list(JOBS))
def test_recurrent_collectives_are_exact(runs, name):
    """A recurrent layer's activation collectives on every rank, by count
    and bytes, are ``carry_collectives``' and the port's
    ``train_sharded.carry_collectives``' (no factor of S: an RG-LRU
    layer's pass moves m B (cw + 1) sd floats where the gather of its
    stream moved m B ceil(S / m) d; an mLSTM's m B H (dh^2 + dh + 2), more
    than a 65-position stream at dh 64, a twentieth of a 4,096-position one
    at xlstm-125m's dh 192); the attention layers' are 3 a layer (the K/V
    gathered in the forward and the recompute, their gradient
    reduce-scattered)."""
    from repro_torch.models import train_sharded
    from repro_torch.models.recurrent import rglru_dims
    world, case, m, rows, over, g, _ = JOBS[name]
    c = _cfg(runs, name)
    cfg, tcfg = c["cfg"], c["tcfg"]
    kinds = cfg.layer_kinds()
    micro = tcfg.micro_batches
    n, nbytes = carry_collectives(cfg, kinds, m, rows // micro, g, tcfg.remat, micro)
    passes = (3 if tcfg.remat else 2) * micro
    n_attn = kinds.count("attn") * passes
    # what gathering the normed stream moved a layer and pass before the carries
    stream = m * (rows // micro) * -(-S // m) * cfg.d_model * 4
    assert train_sharded.carry_collectives(cfg, m, rows // micro, g, tcfg.remat, micro) == \
        (n, nbytes)
    for job in runs["jobs"][name]:
        kinds_got = job["activation_kinds"]
        assert kinds_got["recurrent"] == {"count": n, "bytes": nbytes}, kinds_got
        assert kinds_got.get("attention", {"count": 0})["count"] == n_attn
        assert job["activations"] == n + n_attn
    if case == "rg":
        assert nbytes / (2 * passes) * -(-S // m) == stream * (rglru_dims(cfg)[1] + 1)


@pytest.mark.parametrize("name", list(JOBS))
def test_recurrent_mixers_see_only_their_positions(runs, name):
    """Every conv, scan, mLSTM summary and sLSTM scan of a recurrent mixer
    on rank i receives the positions ``seq_chunk(65, m, i)`` (the conv also
    its cw - 1 = 3 window rows); none receives the stream."""
    from repro_torch.launch.sharding import seq_chunk
    world, case, m, *_ = JOBS[name]
    for i, job in enumerate(runs["jobs"][name]):
        a, b = seq_chunk(S, m, i)
        assert tuple(job["positions"]) == (a, b, S)
        seen = job["seen"]
        assert seen and {n for n, _, _ in seen} >= (
            {"_causal_conv", "_linear_scan"} if case == "rg" else
            {"mlstm_summary", "mlstm_scan", "_slstm_scan"})
        assert all(n == b - a for _, n, _ in seen), seen
        assert all(w == 3 for f, _, w in seen if f == "_causal_conv"), seen


@pytest.mark.parametrize("name", [n for n, j in JOBS.items() if j[1] == "xl"])
def test_relay_idle_share(runs, name):
    """Rank i scans a row group in g of the relay's g + m - 1 lockstep steps
    and waits in the other m - 1, forward and recompute alike."""
    world, case, m, rows, over, g, _ = JOBS[name]
    for job in runs["jobs"][name]:
        st = job["relay_steps"]
        assert st["busy"] * (m - 1) == st["idle"] * g and st["busy"] > 0, st


def test_a_chunk_shorter_than_the_window_raises():
    """8 positions over 4 model ranks leave chunks of 2, shorter than the 3
    rows of the RG-LRU conv window the next rank reads: every rank raises
    before any collective, naming rank 0's chunk."""
    from repro_torch import configs
    from repro_torch.bridge import init_params
    from repro_torch.models import train_sharded
    cfg = configs.reduced("recurrentgemma-9b", layers=3)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")["layers"][0]["mix"]
    for idx in range(4):
        split = types.SimpleNamespace(S=8, m=4, idx=idx, a=2 * idx, b=2 * idx + 2)
        with pytest.raises(ValueError, match=r"the chunk \[0, 2\) of model rank 0 holds 2 "
                                             r"positions, fewer than the 3 rows"):
            train_sharded.rglru_mix(params, cfg, torch.zeros(1, 2, cfg.d_model), split)
    ok = types.SimpleNamespace(S=10, m=4, idx=0, a=0, b=3)        # chunks 3, 3, 3, 1
    train_sharded._check_window(ok, 3)
