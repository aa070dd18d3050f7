"""The port's end-to-end quality tools against ``tumseg``'s, on the CPU:
``tumseg_torch/tools/soak.py`` (``benchmarks/soak.py``) and
``tumseg_torch/tools/miou_parity.py`` (the ``tumseg`` half of
``tools/miou_parity.py``) write the same tiles and run end to end with
``--gpu cpu``; a checkpoint the port trained serves through ``tumseg``'s
tester as through the port's; and the last API copies (the NumPy
augmentations, the metric helpers, the console scripts) equal
``tumseg``'s."""

import ast
import contextlib
import importlib
import io
import json
import math
import shutil
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from tumseg.data import augment as jaug
from tumseg.train import metrics as jmetrics
from tumseg_torch.data import augment as taug
from tumseg_torch.tools import miou_parity, soak
from tumseg_torch.train import metrics as tmetrics
from tumseg_torch.viz.writers import read_labels_txt

ROOT = Path(__file__).resolve().parents[1]
# (the port's module, its function, the original's file)
TILE_MAKERS = [(soak, "make_tile", "benchmarks/soak.py"),
               (miou_parity, "make_tiles", "tools/miou_parity.py")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _function(path: Path, name: str) -> ast.FunctionDef:
    tree = ast.parse(path.read_text())
    return next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == name)


def _code(fn: ast.FunctionDef, rename: bool) -> str:
    """The function's syntax tree without its docstring, with ``tumseg.*``
    imports read as ``tumseg_torch.*`` when ``rename``."""
    if (fn.body and isinstance(fn.body[0], ast.Expr)
            and isinstance(fn.body[0].value, ast.Constant)):
        fn.body[0] = ast.Pass()
    for node in ast.walk(fn):
        if (rename and isinstance(node, ast.ImportFrom) and node.module
                and node.module.startswith("tumseg.")):
            node.module = "tumseg_torch." + node.module[len("tumseg."):]
    return ast.dump(fn)


def _original(rel: str, name: str):
    """The original function, compiled from its file's syntax tree: both
    originals import JAX and set up its compile cache when their module is
    imported, so the function alone is executed, in a namespace holding
    ``np`` (its own ``tumseg.data.las`` import runs as written)."""
    fn = _function(ROOT / rel, name)
    namespace = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), rel, "exec"),
         namespace)
    return namespace[name]


@pytest.mark.parametrize("module,name,rel", TILE_MAKERS,
                         ids=[name for _, name, _ in TILE_MAKERS])
def test_tile_maker_is_the_original(module, name, rel):
    """Same code as the original but for the ``write_las`` import."""
    port = _function(Path(module.__file__), name)
    assert _code(port, False) == _code(_function(ROOT / rel, name), True)


def test_soak_tiles_are_byte_identical(tmp_path):
    make = _original("benchmarks/soak.py", "make_tile")
    for seed in range(3):
        (tmp_path / "a").mkdir(exist_ok=True)
        (tmp_path / "b").mkdir(exist_ok=True)
        assert make(str(tmp_path / "a" / "t.las"), 3000, seed) == 3000
        assert soak.make_tile(str(tmp_path / "b" / "t.las"), 3000, seed) \
            == 3000
        assert (tmp_path / "a" / "t.las").read_bytes() == \
            (tmp_path / "b" / "t.las").read_bytes()


@pytest.mark.parametrize("style", ["small", "facade"])
@pytest.mark.parametrize("color", [False, True])
def test_parity_tiles_are_byte_identical(tmp_path, style, color):
    make = _original("tools/miou_parity.py", "make_tiles")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = make(str(tmp_path / "a"), 3, style=style, points=3000, color=color)
    got = miou_parity.make_tiles(str(tmp_path / "b"), 3, style=style,
                                 points=3000, color=color)
    assert [Path(p).name for p in got[0]] == ["a.las", "b.las"]
    assert Path(got[1]).name == "t.las"
    for name in ("a.las", "b.las", "t.las"):
        data = (tmp_path / "b" / name).read_bytes()
        assert data == (tmp_path / "a" / name).read_bytes()
    assert len(want[0]) == 2


SOAK_POINTS = 6000


def _small_tile(path, n, seed):
    """``make_tiles``' dense 2 m x 1 m x 2.5 m held-out tile with colour, in
    place of the soak's 20 m x 4 m x 12 m one, so that a few thousand
    points fill its 1 m training blocks."""
    scratch = Path(path).parent / f"small_{seed}"
    scratch.mkdir()
    _, test_path = miou_parity.make_tiles(str(scratch), seed, points=n,
                                          color=True)
    Path(test_path).replace(path)
    shutil.rmtree(scratch)
    return n


@pytest.fixture(scope="module")
def soak_run(tmp_path_factory):
    """The soak's flow on the CPU at a small size: its three tiles are
    small-style tiles of 6,000 points, 256-point blocks, B=4, 1 epoch,
    1 vote. Returns its work directory, its result and the JSON lines it
    printed."""
    work = tmp_path_factory.mktemp("soak")
    argv = ["--gpu", "cpu", "--points", str(SOAK_POINTS), "--npoint", "256",
            "--batch_size", "4", "--test_batch_size", "8", "--epochs", "1",
            "--votes", "1", "--workdir", str(work)]
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(printed):
        mp.setattr(soak, "make_tile", _small_tile)
        out = soak.run(soak.parse_args(argv))
    lines = [json.loads(line) for line in printed.getvalue().splitlines()
             if line.startswith('{"phase"')]
    return work, out, lines


def test_soak_runs_end_to_end_on_the_cpu(soak_run):
    work, out, lines = soak_run
    assert [line["phase"] for line in lines] == [
        "synth", "train", "test", "summary"]
    assert lines[0] == {"phase": "synth", "tiles": 3, "points": SOAK_POINTS,
                        "s": lines[0]["s"]}
    assert lines[1]["epochs"] == 1 and lines[2]["votes"] == 1
    run_dir = work / "log" / "sem_seg" / "soak"
    assert (run_dir / "checkpoints" / "best_model.pth").exists()
    labels = read_labels_txt(str(run_dir / "visual" / "test_tile.txt"))
    assert labels.shape == (SOAK_POINTS,)
    assert len(out["eval_mious"]) == 1
    assert lines[1]["final_eval_miou"] == round(out["eval_mious"][-1], 4)
    # the CPU launches no kernel
    assert not any(out["train_launches"].values())
    assert not any(out["test_launches"].values())


def test_soak_ok_is_its_gate_on_what_it_printed(soak_run):
    """``ok`` is finite losses, the printed mIoU > 0.3, the checkpoint and
    one label a point of the tile."""
    work, out, lines = soak_run
    test, summary = lines[2], lines[3]
    run_dir = work / "log" / "sem_seg" / "soak"
    want = (summary["losses_finite"] and test["miou"] > 0.3
            and summary["checkpoint"]
            and summary["visual_labels"] == lines[0]["points"])
    assert summary["ok"] is want
    assert summary["checkpoint"] is True
    assert summary["visual_labels"] == read_labels_txt(
        str(run_dir / "visual" / "test_tile.txt")).size
    checks = {"losses_finite": True, "miou": 0.31, "checkpoint": True,
              "visual_labels": 100, "points": 100}
    assert soak.gate(checks)
    for broken in ({"miou": 0.3}, {"losses_finite": False},
                   {"checkpoint": False}, {"visual_labels": 99}):
        assert not soak.gate(dict(checks, **broken))


def test_soak_prints_four_phase_lines_and_exits_on_its_gate(
        monkeypatch, capsys, tmp_path):
    """``main`` prints the synth, train, test and summary lines in that
    order, with the original's keys, and its exit code follows ``ok``."""
    monkeypatch.setattr(soak, "make_tile", lambda path, n, seed: n)
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli

    def fake_train(args):
        run = Path(args.exp_dir) / "sem_seg" / args.log_dir
        (run / "checkpoints").mkdir(parents=True)
        (run / "checkpoints" / "best_model.pth").write_bytes(b"")
        return [0.5], [1.25], [0.4]

    def fake_test(args, miou):
        run = Path(args.exp_dir) / args.log_dir / "visual"
        run.mkdir(parents=True)
        (run / "test_tile.txt").write_text("1\n" * 10)
        return {"miou": miou}

    monkeypatch.setattr(train_cli, "main", fake_train)
    for miou, rc in ((0.35, 0), (0.25, 1)):
        monkeypatch.setattr(test_cli, "main",
                            lambda args, m=miou: fake_test(args, m))
        assert soak.main(["--gpu", "cpu", "--points", "10", "--workdir",
                          str(tmp_path / str(rc))]) == rc
        lines = [json.loads(line) for line in
                 capsys.readouterr().out.strip().splitlines()]
        assert [line["phase"] for line in lines] == [
            "synth", "train", "test", "summary"]
        assert set(lines[1]) == {"phase", "epochs", "s", "final_loss",
                                 "final_acc", "final_eval_miou"}
        assert set(lines[2]) == {"phase", "votes", "s", "miou",
                                 "scene_pts_per_s"}
        assert lines[2]["miou"] == miou
        assert lines[3]["ok"] is (rc == 0)
        assert lines[3]["visual_labels"] == 10


def test_miou_parity_runs_end_to_end_on_the_cpu(tmp_path, capsys,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--gpu", "cpu", "--tile_points", "4000", "--npoint", "256",
            "--batch", "4", "--epochs", "1", "--votes", "1", "--workdir",
            str(tmp_path), "--cross_eval", "--cross_seeds", "2"]
    assert miou_parity.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"miou_port", "seed", "config", "cross_seeds",
                         "cross_mious", "cross_spread_pts"}
    assert 0.0 <= line["miou_port"] <= 1.0 and line["seed"] == 0
    assert line["config"]["tile_points"] == 4000
    assert line["config"]["gpu"] == "cpu"
    assert line["config"]["data_pipeline"] == "auto"
    assert line["cross_seeds"] == [100, 200]
    assert len(line["cross_mious"]) == 2
    assert line["cross_spread_pts"] == pytest.approx(
        (max(line["cross_mious"]) - min(line["cross_mious"])) * 100,
        abs=0.02)
    assert (tmp_path / "log" / "sem_seg" / "parity" / "checkpoints"
            / "best_model.pth").exists()


def test_miou_parity_does_not_resume_a_left_checkpoint(tmp_path,
                                                       monkeypatch):
    """A ``best_model.pth`` left in ``--workdir`` by an earlier run is gone
    before training starts: the training CLI would resume it."""
    left = tmp_path / "log" / "sem_seg" / "parity" / "checkpoints"
    left.mkdir(parents=True)
    (left / "best_model.pth").write_bytes(b"")
    seen = []

    def fake_train(test_path, args, tmpdir):
        seen.append((Path(tmpdir) / "log").exists())
        return [0.5], [1.0], [0.4]

    monkeypatch.setattr(miou_parity, "train_port", fake_train)
    monkeypatch.setattr(miou_parity, "serve_port",
                        lambda test_path, args, tmpdir, seed=None: 0.45)
    out, det = miou_parity.run(miou_parity.parse_args(
        ["--gpu", "cpu", "--tile_points", "100", "--workdir",
         str(tmp_path)]))
    assert seen == [False]
    assert out["miou_port"] == 0.45 and det["eval_mious"] == [0.4]


def test_port_checkpoint_serves_the_same_through_tumseg(tmp_path,
                                                        monkeypatch):
    """The port trains one tiny epoch (learning rate 0.01, so its labels
    are not one class); ``tumseg.cli.test`` and ``tumseg_torch.cli.test``
    serve its ``best_model.pth`` on the same vote seed. Labels agree on
    >= 99.9% of points: ``tumseg``'s CPU ball query takes the |a|^2 +
    |b|^2 - 2ab expansion, the port the direct form, so a pick on a
    radius boundary may differ (``tests/test_torch_serve.py``)."""
    from tumseg.cli import test as jtest_cli
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli

    monkeypatch.chdir(tmp_path)
    miou_parity.make_tiles(str(tmp_path), 0, points=8000)
    flags = ["--rootdir", str(tmp_path), "--test_area", "t.las",
             "--class8", "--RGB_OFF", "--seed", "0", "--gpu", "cpu"]
    train_cli.main(train_cli.parse_args(flags + [
        "--exp_dir", str(tmp_path / "log"), "--log_dir", "port",
        "--epoch", "1", "--batch_size", "4", "--npoint", "256",
        "--learning_rate", "0.01"]))
    run = tmp_path / "log" / "sem_seg" / "port"
    (tmp_path / "log" / "sem_seg" / "jax").mkdir()
    (run.parent / "jax" / "checkpoints").symlink_to(run / "checkpoints")
    serve = ["--exp_dir", str(tmp_path / "log" / "sem_seg") + "/",
             "--batch_size", "4", "--num_point", "256", "--num_votes", "1"]
    got = test_cli.main(test_cli.parse_args(flags + serve
                                            + ["--log_dir", "port"]))
    want = jtest_cli.main(jtest_cli.parse_args(flags + serve
                                               + ["--log_dir", "jax"]))
    labels = read_labels_txt(str(run / "visual" / "t.txt"))
    jlabels = read_labels_txt(str(run.parent / "jax" / "visual" / "t.txt"))
    assert labels.shape == jlabels.shape == (8000,)
    assert len(np.unique(jlabels)) > 1  # not a constant labelling
    assert (labels == jlabels).mean() >= 0.999
    assert abs(got["miou"] - want["miou"]) < 0.01


def _clouds(rng, b=4, n=64, c=3):
    return rng.standard_normal((b, n, c)).astype(np.float32)


# each public NumPy augmentation: (name, arguments from a seeded Generator,
# keyword arguments, whether it draws from ``rng``)
AUGMENTATIONS = [
    ("rotate_point_cloud_z", lambda r: (_clouds(r),), True),
    ("rotate_point_cloud", lambda r: (_clouds(r),), True),
    ("rotate_point_cloud_by_angle", lambda r: (_clouds(r, c=6), 0.7), False),
    ("rotate_point_cloud_with_normal", lambda r: (_clouds(r, c=6),), True),
    ("rotate_point_cloud_by_angle_with_normal",
     lambda r: (_clouds(r, c=6), -1.3), False),
    ("rotate_perturbation_point_cloud_with_normal",
     lambda r: (_clouds(r, c=6),), True),
    ("rotate_perturbation_point_cloud", lambda r: (_clouds(r),), True),
    ("jitter_point_cloud", lambda r: (_clouds(r),), True),
    ("shift_point_cloud", lambda r: (_clouds(r),), True),
    ("random_scale_point_cloud", lambda r: (_clouds(r),), True),
    ("random_point_dropout", lambda r: (_clouds(r, c=6),), True),
    ("shuffle_data", lambda r: (_clouds(r, b=7), np.arange(7) * 3), True),
    ("shuffle_points", lambda r: (_clouds(r),), True),
    ("random_point_cloud_crop", lambda r: (_clouds(r)[0], 40), True),
    ("normalize_data", lambda r: (_clouds(r) * 5 + 2,), False),
]


def test_augmentation_list_is_tumseg_public_numpy_api():
    """The 15 functions are every public function of ``tumseg``'s module
    but its four jnp forms."""
    public = {name for name, value in vars(jaug).items()
              if callable(value) and not name.startswith("_")
              and getattr(value, "__module__", "") == jaug.__name__}
    assert public - {name for name, _, _ in AUGMENTATIONS} == {
        "jrotate_z", "jjitter", "jscale", "jshift"}
    assert len(AUGMENTATIONS) == 15


@pytest.mark.parametrize("name,make_args,draws", AUGMENTATIONS,
                         ids=[a[0] for a in AUGMENTATIONS])
def test_numpy_augmentation_is_tumseg_bitwise(name, make_args, draws):
    args = make_args(np.random.default_rng(3))
    kw = {}
    if draws:
        kw_j, kw_t = ({"rng": np.random.default_rng(11)},
                      {"rng": np.random.default_rng(11)})
    else:
        kw_j = kw_t = kw
    want = getattr(jaug, name)(*[np.copy(a) for a in args], **kw_j)
    got = getattr(taug, name)(*[np.copy(a) for a in args], **kw_t)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if draws:  # both consumed the same draws
        assert kw_t["rng"].random() == kw_j["rng"].random()
    for private in ("_rot_z", "_rot_y"):
        angles = np.random.default_rng(5).uniform(-4, 4, 6)
        np.testing.assert_array_equal(getattr(taug, private)(angles),
                                      getattr(jaug, private)(angles))
    np.testing.assert_array_equal(
        taug._perturbation_rots(5, 0.06, 0.18, np.random.default_rng(2)),
        jaug._perturbation_rots(5, 0.06, 0.18, np.random.default_rng(2)))


def test_metric_helpers_are_tumseg():
    r = np.random.default_rng(4)
    seen = r.integers(0, 1000, 8)
    seen[3] = 0  # a class never seen
    correct = np.minimum(seen, r.integers(0, 800, 8))
    predicted = correct + r.integers(0, 300, 8)
    tallies = {"seen": seen, "predicted": predicted, "correct": correct}
    want = jmetrics.miou_from_tallies(tallies)
    assert tmetrics.miou_from_tallies(tallies) == want
    assert tmetrics.miou_from_tallies(
        {k: torch.from_numpy(v) for k, v in tallies.items()}) == want
    total = int(seen.sum())
    assert tmetrics.accuracy_from_tallies(tallies, total) == \
        jmetrics.accuracy_from_tallies(tallies, total)
    assert math.isfinite(want) and 0.0 <= want <= 1.0


@pytest.mark.parametrize("cli", ["train", "test"])
def test_console_main_accepts_help(cli, monkeypatch, capsys):
    mod = importlib.import_module(f"tumseg_torch.cli.{cli}")
    monkeypatch.setattr(sys, "argv", [f"tumseg-torch-{cli}", "--help"])
    with pytest.raises(SystemExit) as exc:
        mod._console_main()
    assert exc.value.code == 0
    assert "--gpu" in capsys.readouterr().out


def test_console_scripts_name_the_port():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    for cli in ("train", "test"):
        target = scripts[f"tumseg-torch-{cli}"]
        module, func = target.split(":")
        assert module == f"tumseg_torch.cli.{cli}"
        assert callable(getattr(importlib.import_module(module), func))
        assert scripts[f"tumseg-{cli}"] == f"tumseg.cli.{cli}:_console_main"
