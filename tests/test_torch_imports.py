"""The PyTorch port stands alone: nothing under ``src/repro_torch`` and
nothing in ``chip_smoke.py`` imports JAX or the JAX package ``repro``
(checked on the source, by AST; the training, analysis and dry-run modules
too), and ``chip_smoke.py`` takes the card's rates and the kernels' bounds
from ``repro_torch.analysis.roofline`` instead of keeping a copy. Also drives the port's serve CLI on the
CPU (single stream; batched, continuous and paged serving) and checks that
the bucketed flags refuse what the JAX CLI refuses."""
import ast
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def test_scan_covers_the_slice_2_modules():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("kernels/flash/ops.py", "kernels/flash/ref.py", "configs/ssv_nsa_8b.py",
                "kernels/nsa_verify/ops.py", "models/attention.py"):
        assert f"src/repro_torch/{rel}" in scanned


def test_scan_covers_the_slice_3_modules():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("core/kvstore.py", "core/schedule.py", "core/engine.py", "core/accept.py",
                "kernels/nsa_verify/ref.py", "launch/serve.py"):
        assert f"src/repro_torch/{rel}" in scanned


def test_scan_covers_the_planner_modules():
    """The planner, bucket admission and group-step modules are scanned."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("core/planner.py", "core/schedule.py", "core/engine.py", "kernels/__init__.py",
                "kernels/build.py", "launch/serve.py"):
        assert f"src/repro_torch/{rel}" in scanned


def test_scan_covers_the_training_modules():
    """The training slice's modules are scanned."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("optim/adamw.py", "optim/compress.py", "ckpt/checkpoint.py",
                "data/pipeline.py", "data/synthetic.py", "runtime/fault.py",
                "runtime/straggler.py", "runtime/trainer.py", "launch/train.py",
                "bridge.py", "models/model.py", "models/attention.py",
                "models/recurrent.py"):
        assert f"src/repro_torch/{rel}" in scanned


def test_scan_covers_the_analysis_and_launch_modules():
    """The analysis layer and the dry run's modules are scanned."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("analysis/__init__.py", "analysis/roofline.py", "launch/specs.py",
                "launch/dryrun.py", "launch/__init__.py", "core/overlap.py",
                "config/base.py", "device.py"):
        assert f"src/repro_torch/{rel}" in scanned


def test_scan_covers_the_decode_across_ranks_and_the_examples():
    """The mesh, sharding, rank-launch and elastic modules, the sharded
    decode and the four examples are scanned."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("launch/mesh.py", "launch/sharding.py", "launch/ranks.py",
                "runtime/elastic.py", "models/nsa_sharded.py", "examples/__init__.py",
                "examples/quickstart.py", "examples/serve_batched.py",
                "examples/train_nsa_e2e.py", "examples/fault_tolerant_training.py"):
        assert f"src/repro_torch/{rel}" in scanned


def test_scan_covers_the_sharded_training_modules():
    """Training across ranks and its checks in spawned ranks are scanned."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in ("runtime/sharded.py", "launch/train_checks.py", "runtime/trainer.py",
                "ckpt/checkpoint.py", "optim/compress.py", "models/moe.py",
                "models/train_sharded.py"):
        assert f"src/repro_torch/{rel}" in scanned


def test_chip_smoke_keeps_no_copy_of_the_roofline():
    """The card's rates and the kernel bounds live in
    ``analysis/roofline.py`` only: ``chip_smoke.py`` defines none of the
    moved functions and writes none of the rates as a number."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    defined = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    moved = {"bound", "dot_rate", "verify_bound", "routing_bound", "flash_bound",
             "attention_flops", "flops_share", "model_flops"}
    assert not defined & moved
    rates = {3.35e12, 989e12, 67e12}
    numbers = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
               and isinstance(n.value, float)}
    assert not numbers & rates
    src = (ROOT / "chip_smoke.py").read_text()
    assert "from repro_torch.analysis import roofline as rl" in src


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_registry_string_imports_stay_in_port():
    src = (ROOT / "src" / "repro_torch" / "configs" / "__init__.py").read_text()
    assert '"repro_torch.configs."' in src
    assert get_config("ssv-nsa-1b").num_heads == 32
    assert get_config("ssv-nsa-8b").head_dim == 128
    assert get_config("qwen3-8b").qk_norm
    assert get_config("smollm-360m").num_heads == 15
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-7b")


def test_serve_cli_on_cpu(capsys):
    serve.main(["--reduced", "--device", "cpu", "--prompts", "1", "--tokens", "4",
                "--prompt-len", "40", "--precision-class", "Approx+Reuse", "--baseline"])
    out = capsys.readouterr().out
    assert "prompt 0: 4 tokens" in out and "AR baseline" in out


@pytest.mark.parametrize("flags,match", [
    (["--bucketed"], "--continuous"), (["--warmup"], "--bucketed"),
    (["--continuous", "--bucketed", "--warmup"], "--profile-json")])
def test_serve_cli_unported_modes_raise(flags, match):
    """The bucketed flags refuse what the JAX CLI refuses: --bucketed
    outside continuous serving or without a profile, --warmup without
    --bucketed."""
    with pytest.raises(ValueError, match=match):
        serve.main(["--reduced", "--device", "cpu", *flags])


@pytest.mark.parametrize("flags,expect", [
    (["--batch", "2"], "batch[0:2]: 8 tokens"),
    (["--batch", "2", "--kv-backend", "paged"], "kv store paged"),
    (["--batch", "2", "--continuous", "--arrival-rate", "0.5"], "continuous over 2 slots"),
    (["--batch", "2", "--continuous", "--kv-backend", "paged", "--kv-num-pages", "16"],
     "peak page occupancy")])
def test_serve_cli_batched_modes_on_cpu(capsys, flags, expect):
    serve.main(["--reduced", "--device", "cpu", "--prompts", "3", "--tokens", "4",
                "--prompt-len", "40", "--tree-depth", "2", *flags])
    out = capsys.readouterr().out
    assert expect in out and "prompt 2: 4 tokens" in out
