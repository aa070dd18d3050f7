"""The port stands alone: no module of ``tumseg_torch``, not
``chip_smoke.py`` and not the drop-in scripts ``sem_seg_*_torch.py`` import
JAX or anything of the JAX package ``tumseg``, and importing the port's
entry points loads neither. The entry points run on the
card unless the caller asks for the CPU: without a CUDA device they raise
unless given ``--gpu cpu``."""

import ast
import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "tumseg")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def test_port_sources_import_no_jax_and_no_tumseg():
    files = sorted((ROOT / "tumseg_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "sem_seg_training_torch.py",
        ROOT / "sem_seg_testing_torch.py"]
    assert len(files) > 30
    bad = [f"{path.relative_to(ROOT)}:{line} imports {name}"
           for path in files for line, name in _imported_modules(path)
           if name.split(".")[0] in BANNED]
    assert not bad, "\n".join(bad)


def test_entry_points_load_no_jax_and_no_tumseg():
    code = (
        "import sys\n"
        "import chip_smoke, tumseg_torch.cli.test, tumseg_torch.cli.train\n"
        "import tumseg_torch.infer.voting, tumseg_torch.train.loop\n"
        "import tumseg_torch.tools.soak, tumseg_torch.tools.miou_parity\n"
        "import sem_seg_training_torch, sem_seg_testing_torch\n"
        "for m in (sem_seg_training_torch, sem_seg_testing_torch):\n"
        "    assert callable(m.main) and callable(m.parse_args)\n"
        "bad = sorted(k for k in sys.modules\n"
        f"             if k.split('.')[0] in {BANNED})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("cli", ["test", "train"])
def test_cli_without_cuda_raises_unless_gpu_cpu(cli, monkeypatch, tmp_path):
    mod = importlib.import_module(f"tumseg_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = mod.parse_args(["--rootdir", str(tmp_path), "--test_area",
                           "missing.las"])
    assert args.gpu == "0"
    with pytest.raises(RuntimeError, match="--gpu cpu"):
        mod.main(args)
    assert mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.resolve_device("1")


def test_runner_and_engine_default_to_cuda():
    from tumseg_torch.infer.voting import InferenceRunner
    from tumseg_torch.train.loop import TrainEngine

    for cls in (InferenceRunner, TrainEngine):
        assert inspect.signature(cls).parameters["device"].default == "cuda"


def test_op_dispatch_has_no_fallback():
    """The kernel wrappers, the autograd Functions and the dispatch catch
    no exception: a kernel that fails to build or launch raises, and no
    path gives way to the plain version or to the CPU."""
    ops_dir = ROOT / "tumseg_torch" / "ops"
    for name in ("__init__.py", "kernels.py", "autograd.py", "core.py"):
        tree = ast.parse((ops_dir / name).read_text())
        handlers = [node.lineno for node in ast.walk(tree)
                    if isinstance(node, ast.ExceptHandler)]
        assert not handlers, f"tumseg_torch/ops/{name}:{handlers}"
