"""The port's examples (``python -m repro_torch.examples.<name>``) run on
the CPU at small sizes with the JAX scripts' flags: the quickstart's hand
verify round and engine generation, batched / sequential / continuous-paged
/ bucketed serving, the end-to-end train-then-serve program, and the
fault-tolerant training demo, whose elastic plans for 512 / 384 / 256 / 128
chips are the JAX ``plan_mesh``'s. Without a card and without ``--device
cpu`` they raise."""
import pytest
import torch

from repro.runtime import elastic as jelastic
from repro_torch.examples import (fault_tolerant_training, quickstart, serve_batched,
                                  train_nsa_e2e)

torch.set_num_threads(1)


def test_quickstart(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "verify logits: (1, 15, 512)" in out
    assert "generated 24 tokens" in out and "mean accepted drafts/step" in out


@pytest.mark.parametrize("flags,expect", [
    ([], "batched: "),
    (["--sequential"], "req 1: ctx 64 -> 6 tokens"),
    (["--continuous", "--slots", "2", "--kv-backend", "paged", "--kv-num-pages", "48"],
     "paged KV store: "),
    (["--continuous", "--slots", "2", "--bucketed", "--warmup"], "bucketed: ")])
def test_serve_batched(capsys, flags, expect):
    serve_batched.main(["--device", "cpu", "--requests", "3", "--tokens", "6", *flags])
    out = capsys.readouterr().out
    assert expect in out and "served 3 requests, 18 tokens" in out


def test_serve_batched_refuses_what_the_jax_script_refuses():
    with pytest.raises(SystemExit):
        serve_batched.main(["--device", "cpu", "--bucketed"])
    with pytest.raises(SystemExit):
        serve_batched.main(["--device", "cpu", "--warmup"])


def test_train_nsa_e2e(capsys, tmp_path):
    train_nsa_e2e.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "64",
                        "--tokens", "8", "--fresh", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "target nsa-mini: " in out and "target trained to step 2" in out
    assert "greedy agreement" in out
    assert (tmp_path / "t").exists() and (tmp_path / "d").exists()


def test_fault_tolerant_training_plans_equal_jax(capsys, tmp_path):
    fault_tolerant_training.main(["--device", "cpu", "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "completed=True after 2 restarts, final step 24" in out
    assert out.count("(re)started at step") == 3
    for n in (512, 384, 256, 128):
        mc = jelastic.plan_mesh(n, prefer_model=16, multi_pod=(n > 256), pod_size=256)
        assert f"  {n} healthy chips -> mesh {mc.shape} axes {mc.axes}" in out


@pytest.mark.parametrize("example", [quickstart, fault_tolerant_training, train_nsa_e2e,
                                     serve_batched])
def test_examples_raise_without_a_card(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
