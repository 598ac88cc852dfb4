"""The port's training driver against the JAX one, on the CPU in float32.

* Checkpoint interop: the JAX ``Trainer`` trains 2 steps and saves; the
  port's ``Trainer`` resumes from that checkpoint and trains 2 more, as
  does the JAX ``Trainer``: the losses agree within rtol 1e-3; and the
  reverse direction. Both packages write the same leaves under the same
  keys and shapes.
* One train step with micro-batch accumulation against the JAX step.
* A restart after an injected failure lands on the uninterrupted
  trajectory bitwise; the async checkpointer's round trip is bitwise.
* ``PrefetchIterator``, the watchdog, the injector, the corpus (token for
  token the JAX corpus's) and the train CLI with its resume.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import reduced as jreduced
from repro.data.synthetic import SyntheticConfig as JSyntheticConfig
from repro.data.synthetic import SyntheticCorpus as JSyntheticCorpus
from repro.data.synthetic import token_stream as jtoken_stream
from repro.models import model as jmodel
from repro.optim import adamw_init as jadamw_init
from repro.runtime.trainer import Trainer as JTrainer, make_train_step as jmake_train_step
from repro_torch.bridge import from_jax
from repro_torch.ckpt import AsyncCheckpointer, gc_old, latest_step, load, restore, save
from repro_torch.config import TrainConfig
from repro_torch.configs import reduced
from repro_torch.data.pipeline import PrefetchIterator
from repro_torch.data.synthetic import SyntheticConfig, SyntheticCorpus, token_stream
from repro_torch.launch import train as train_cli
from repro_torch.optim import adamw_init, tree_leaves
from repro_torch.runtime.fault import FailureInjector, InjectedFailure, run_with_restarts
from repro_torch.runtime.straggler import StragglerWatchdog
from repro_torch.runtime.trainer import Trainer, make_train_step

# The tier-1 run gives each of six pytest workers a share of the cores; one
# torch thread per worker keeps the many small CPU ops from oversubscribing
# them (eight threads per worker spent most of the port's test time waiting).
torch.set_num_threads(1)

TRAIN = dict(steps=4, checkpoint_every=2, learning_rate=1e-3, warmup_steps=2, seed=3)
DATA = dict(batch_size=2, seq_len=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small models: the tier-1 run puts
    several test workers on the machine's cores, and a pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs():
    return jreduced("ssv-nsa-1b", layers=2, vocab=256), reduced("ssv-nsa-1b", layers=2, vocab=256)


def jax_trainer(ckdir, **kw):
    return JTrainer(cfgs()[0], JTrainConfig(**TRAIN, checkpoint_dir=str(ckdir)), **DATA, **kw)


def port_trainer(ckdir, **kw):
    return Trainer(cfgs()[1], TrainConfig(**TRAIN, checkpoint_dir=str(ckdir)), **DATA,
                   device="cpu", **kw)


def losses(tr):
    return [m["loss"] for m in tr.metrics_log]


def leaf_shapes(ckdir):
    step, tree = load(str(ckdir))
    flat = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{pre}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{pre}/{i}")
        else:
            flat[pre.lstrip("/")] = (t.shape, t.dtype)
    walk(tree, "")
    return step, flat


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, first):
    """``first`` trains 2 steps and saves; both packages resume from that
    checkpoint and train 2 more: equal losses (rtol 1e-3), and the two
    packages' checkpoints hold the same keys, shapes and dtypes."""
    a, b = tmp_path / "a", tmp_path / "b"
    starter = jax_trainer(a) if first == "jax" else port_trainer(a)
    assert starter.run(2) == 2
    shutil.copytree(a, b)
    port, ref = port_trainer(a), jax_trainer(b)
    assert port.state.step == ref.state.step == 2
    port.run()
    ref.run()
    assert port.state.step == ref.state.step == 4
    np.testing.assert_allclose(losses(port), losses(ref), rtol=1e-3)
    np.testing.assert_allclose([m["grad_norm"] for m in port.metrics_log],
                               [m["grad_norm"] for m in ref.metrics_log], rtol=1e-3)
    step_a, keys_a = leaf_shapes(a)
    step_b, keys_b = leaf_shapes(b)
    assert step_a == step_b == 4 and keys_a == keys_b
    assert "params/segments/0/0/mix/wq" in keys_a and "opt/count" in keys_a
    meta = json.loads((a / "step_00000004" / "meta.json").read_text())
    assert meta["step"] == 4 and meta["metadata"] == {"model": cfgs()[1].name}


def test_micro_batch_step_matches_jax():
    """Two micro-batches: losses and gradients summed in float32, then
    divided; the step's loss, grad norm and AdamW moments (the clipped
    gradient, linearly) match JAX's. The new params are not compared
    element by element: Adam's first step is lr * g / (|g| + 1e-8), which
    turns rounding in a near-zero gradient into a step of up to lr."""
    jcfg, tcfg = cfgs()
    kw = dict(steps=10, micro_batches=2, learning_rate=1e-2, warmup_steps=0)
    jp = jmodel.init(jax.random.PRNGKey(5), jcfg)
    tp = from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (4, 48))
    jstep = jmake_train_step(jcfg, JTrainConfig(**kw), donate=False)
    jp2, jopt, _, jm = jstep(jp, jadamw_init(jp), jnp.zeros(()), jnp.asarray(tokens))
    tp2, topt, _, tm = make_train_step(tcfg, TrainConfig(**kw))(
        tp, adamw_init(tp), torch.zeros(()), torch.as_tensor(tokens))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    for got, want, rtol, atol in ((topt.mu, jopt.mu, 1e-3, 1e-7),
                                  (topt.nu, jopt.nu, 2e-3, 1e-12)):
        want = from_jax(jax.tree.map(np.asarray, want), tcfg, "cpu")
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)
    assert int(topt.count) == int(jopt.count) == 1
    moved = [float((a - b).abs().max()) for a, b in zip(tree_leaves(tp2), tree_leaves(tp))]
    assert 0 < max(moved) <= 2 * 1e-2 * (1 + 0.1)


def test_compressed_step_carries_a_residual():
    _, tcfg = cfgs()
    tc = TrainConfig(grad_compression="int8_ef", checkpoint_every=0)
    tr = Trainer(tcfg, tc, **DATA, device="cpu", resume=False)
    tr.run(2)
    assert all(np.isfinite(losses(tr)))
    assert max(float(r.abs().max()) for r in tree_leaves(tr.state.residual)) > 0


def test_restart_after_failure_matches_uninterrupted(tmp_path):
    """Crash at step 6 and restart from the step-4 checkpoint: the same
    params, bitwise, as the uninterrupted run (the port's counterpart of
    tests/test_engine.py::test_trainer_restart_matches_uninterrupted)."""
    _, cfg = cfgs()

    def run(ckdir, inject):
        tc = TrainConfig(steps=8, checkpoint_every=4, checkpoint_dir=str(ckdir),
                         learning_rate=1e-3, seed=3)
        inj = FailureInjector(fail_at_steps=[6]) if inject else None
        holder = {}

        def driver():
            holder["tr"] = Trainer(cfg, tc, **DATA, injector=inj, device="cpu")
            return holder["tr"].run()

        rep = run_with_restarts(driver)
        assert rep.completed and rep.final_step == 8 and rep.restarts == int(inject)
        return holder["tr"]

    plain = run(tmp_path / "a", inject=False)
    crashed = run(tmp_path / "b", inject=True)
    assert crashed.metrics_log[0]["step"] == 4            # resumed from the checkpoint
    for a, b in zip(tree_leaves(plain.state.params), tree_leaves(crashed.state.params)):
        assert torch.equal(a, b)
    assert losses(plain)[-2:] == losses(crashed)[-2:]


def test_async_checkpointer_round_trip_and_errors(tmp_path):
    _, cfg = cfgs()
    tr = port_trainer(tmp_path / "unused", resume=False)
    tree = {"params": tr.state.params, "opt": tr.state.opt, "residual": tr.state.residual}
    ck = AsyncCheckpointer(str(tmp_path / "c"), cfg, keep=2)
    for step in (1, 2, 3):
        ck.save(step, tree)
    ck.wait()
    assert latest_step(str(tmp_path / "c")) == 3
    assert sorted(os.listdir(tmp_path / "c")) == ["step_00000002", "step_00000003"]
    step, back = restore(str(tmp_path / "c"), tree, cfg)
    assert step == 3
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back["opt"].count.dtype == torch.int32
    bad = dict(tree, params=dict(tree["params"], final_norm={"scale": torch.zeros(3)}))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path / "c"), bad, cfg)
    save(str(tmp_path / "d"), 5, {"params": {"embed": {"table": np.zeros(2)}}})
    with pytest.raises(KeyError, match="missing leaf"):
        restore(str(tmp_path / "d"), {"other": torch.zeros(2)}, cfg)
    gc_old(str(tmp_path / "c"), keep=1)
    assert latest_step(str(tmp_path / "c")) == 3 and len(os.listdir(tmp_path / "c")) == 1
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), tree, cfg)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, cfg = cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig(checkpoint_dir=str(tmp_path)), **DATA)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,classes,seed", [(256, 8, 11), (512, 8, 1234), (97, 4, 0),
                                                (32768, 8, 1234)])
def test_corpus_matches_jax_token_for_token(vocab, classes, seed):
    ours = SyntheticCorpus(SyntheticConfig(vocab_size=vocab, num_classes=classes, seed=seed))
    ref = JSyntheticCorpus(JSyntheticConfig(vocab_size=vocab, num_classes=classes, seed=seed))
    for step in (0, 7):
        np.testing.assert_array_equal(ours.batch(step, 2, 300), ref.batch(step, 2, 300))
    a, b = token_stream(ours, 2, 40, start_step=3), jtoken_stream(ref, 2, 40, start_step=3)
    for _ in range(2):
        (sa, xa), (sb, xb) = next(a), next(b)
        assert sa == sb
        np.testing.assert_array_equal(xa, xb)


def test_prefetch_iterator_order_errors_and_close():
    corpus = SyntheticCorpus(SyntheticConfig(vocab_size=64, seed=2))
    it = PrefetchIterator(token_stream(corpus, 2, 16, start_step=5), depth=2)
    for want in (5, 6, 7):
        step, batch = next(it)
        assert step == want and batch.dtype == torch.int64 and batch.shape == (2, 16)
        assert torch.equal(batch, torch.from_numpy(corpus.batch(want, 2, 16)))
    it.close()
    assert not it.thread.is_alive()

    def broken():
        yield 0, np.zeros((1, 4))
        raise OSError("disk gone")

    it = PrefetchIterator(broken())
    assert next(it)[0] == 0
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    it.close()
    it = PrefetchIterator(iter([(0, np.zeros((1, 2)))]))
    assert next(it)[0] == 0
    with pytest.raises(StopIteration):
        next(it)
    it.close()


def test_watchdog_and_injector():
    seen = []
    wd = StragglerWatchdog(threshold=2.0, warmup_steps=3, on_straggler=seen.append)
    for step in range(6):
        assert wd.observe(step, 1.0) is None
    ev = wd.observe(6, 5.0)
    assert ev is not None and ev.ratio == pytest.approx(5.0) and seen == [ev]
    assert wd.ema == pytest.approx(1.0)                   # the straggler is not averaged in
    inj = FailureInjector(fail_at_steps=[2], max_failures=1)
    inj.maybe_fail(1)
    with pytest.raises(InjectedFailure):
        inj.maybe_fail(2)
    inj.maybe_fail(2)                                     # fires once
    assert inj.failures == [2]
    calls = []

    def always():
        calls.append(1)
        raise InjectedFailure("x")

    rep = run_with_restarts(always, max_restarts=2)
    assert not rep.completed and rep.restarts == 3 and len(calls) == 3


def test_train_cli_trains_and_resumes(tmp_path, capsys):
    args = ["--arch", "ssv-nsa-1b", "--reduced", "--batch", "2", "--seq", "32",
            "--ckpt", str(tmp_path), "--ckpt-every", "2", "--device", "cpu", "--lr", "1e-3"]
    train_cli.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resume step 0" in out and "done at step 3" in out
    logged = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [m["step"] for m in logged] == [0, 1, 2] and all(np.isfinite(m["loss"])
                                                          for m in logged)
    train_cli.main(args + ["--steps", "4", "--micro-batches", "2"])
    out = capsys.readouterr().out
    assert "resume step 3" in out and "done at step 4" in out
    assert latest_step(str(tmp_path)) == 4
