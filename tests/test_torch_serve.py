"""The port's serving path on the CPU: the vote scatter against a loop oracle,
the port's InferenceRunner against tumseg's (host featurization) on the same
synthetic scene, weights and dataset seed, the port's test CLI end to end,
its parser against tumseg's, and a check that the port never imports JAX."""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg.data.dataset import TestGridDataset
from tumseg.data.las import write_las
from tumseg.viz.writers import read_labels_txt
from tumseg_torch.infer.voting import InferenceRunner, _scatter_votes

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def scene(tmp_path):
    r = np.random.default_rng(0)
    n = 3000
    xyz = np.stack([r.uniform(0, 4, n), r.uniform(0, 2, n),
                    r.uniform(0, 6, n)], 1)
    labels = r.choice([1, 2, 3, 7], n)
    p = str(tmp_path / "scene.las")
    write_las(p, xyz, labels)
    return p


def test_scatter_votes_matches_loop_oracle():
    r = np.random.default_rng(1)
    n_scene, C, B, N = 50, 4, 3, 16
    idx = r.integers(0, n_scene, (B, N)).astype(np.int32)
    pred = r.integers(0, C, (B, N)).astype(np.int64)
    keep = r.random((B, N)) > 0.3
    want = np.zeros((n_scene, C), dtype=np.float32)
    for b in range(B):
        for n in range(N):
            if keep[b, n]:
                want[idx[b, n], pred[b, n]] += 1
    pool = torch.zeros(n_scene, C)
    got = _scatter_votes(pool, torch.from_numpy(idx), torch.from_numpy(pred),
                         torch.from_numpy(keep))
    assert got is pool  # in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_runner_matches_tumseg_runner(scene):
    """Same weights, same dataset seed, one vote: labels agree on >= 99.9%
    of scene points (tumseg's CPU ball query uses the |a|^2+|b|^2-2ab
    expansion, the port the direct form, so an r^2-boundary pick may
    differ)."""
    from tumseg.infer.voting import InferenceRunner as JaxRunner
    from tumseg.models import pointnet2_sem_seg as jmodel
    from tumseg_torch.models.convert import (state_dict_from_variables,
                                             variables_from_state_dict)
    from tumseg_torch.models.pointnet2_sem_seg import get_model
    from tumseg_torch.nn.layers import calibrate_batch_norm

    def dataset():
        return TestGridDataset(las_file_list=[scene], num_classes=8,
                               block_points=256, class8=True, color=False,
                               seed=0)

    var = jmodel.init(jax.random.PRNGKey(0), 8, 0)
    model = get_model(8).eval()
    model.load_state_dict(state_dict_from_variables(
        jax.tree_util.tree_map(np.asarray, var)), strict=True)
    # BN stats from real blocks, so the labels depend on the input
    calibrate_batch_norm(model, torch.from_numpy(
        dataset()[0][0][:4].astype(np.float32)))
    var = jax.tree_util.tree_map(
        jnp.asarray, variables_from_state_dict(model.state_dict()))

    want = JaxRunner(jmodel, var, num_classes=8, batch_size=4,
                     device_features=False,
                     device_reblock=False).infer_scene(dataset(), 0, 1)
    got = InferenceRunner(model, num_classes=8, batch_size=4,
                          device="cpu").infer_scene(dataset(), 0, 1)
    assert got.shape == want.shape == (3000,)
    assert len(np.unique(want)) > 1  # not a constant labelling
    assert (got == want).mean() >= 0.999


def test_runner_predict_blocks_pads_and_trims(scene):
    from tumseg_torch.models.pointnet2_sem_seg import get_model

    torch.manual_seed(0)
    runner = InferenceRunner(get_model(8), num_classes=8, batch_size=4,
                             device="cpu")
    data = np.random.default_rng(2).random((6, 128, 6)).astype(np.float32)
    preds = runner.predict_blocks(data)
    assert preds.shape == (6, 128)
    np.testing.assert_array_equal(preds[4:], runner.predict_blocks(data[4:]))


@pytest.mark.parametrize("option", ["mesh", "device_features",
                                    "device_reblock"])
def test_runner_options_construct(option):
    """Each option constructs on the CPU when asked for: the mesh (here a
    one-rank gloo group; tests/test_torch_parallel.py votes on two ranks),
    and the device featurization and re-blocking paths
    (tests/test_torch_vote_device.py drives them; tests/test_torch_bf16.py
    the bf16 compute). A batch that does not tile the mesh raises."""
    from tumseg_torch.models.pointnet2_sem_seg import get_model
    from tumseg_torch.parallel import mesh as pmesh

    if option == "mesh":
        mesh = pmesh.make_mesh(1, devices="cpu", backend="gloo")
        try:
            runner = InferenceRunner(get_model(8), num_classes=8, mesh=mesh)
            assert runner.mesh is mesh
            assert runner.device == torch.device("cpu")
            with pytest.raises(ValueError, match="multiple of the mesh"):
                InferenceRunner(get_model(8), num_classes=8, batch_size=3,
                                mesh=pmesh.Mesh(2, 0, torch.device("cpu")))
        finally:
            pmesh.close_mesh()
    else:
        runner = InferenceRunner(get_model(8), num_classes=8, device="cpu",
                                 **{option: True})
        assert getattr(runner, option) is True


def test_confusion_tallies_match_tumseg():
    from tumseg.train import metrics as JM
    from tumseg_torch.train import metrics as TM

    r = np.random.default_rng(3)
    pred = r.integers(0, 5, 400)
    target = r.integers(0, 5, 400)
    want = JM.confusion_tallies(jnp.asarray(pred), jnp.asarray(target), 6)
    got = TM.confusion_tallies(torch.from_numpy(pred),
                               torch.from_numpy(target), 6)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(TM.iou_from_tallies(got),
                                  JM.iou_from_tallies(want))


@pytest.fixture
def workspace(tmp_path):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    r = np.random.default_rng(0)
    n = 6000
    xyz = np.stack([r.uniform(0, 4, n), r.uniform(0, 2, n),
                    r.uniform(0, 5, n)], 1)
    labels = r.choice([1, 2, 3, 7], n)
    rgb = r.integers(0, 256, (n, 3)).astype(np.uint16)
    write_las(str(data_dir / "test_tile.las"), xyz, labels, rgb=rgb)
    return tmp_path


def _cli_args(workspace, *extra):
    from tumseg_torch.cli import test as test_cli

    return test_cli.parse_args([
        "--rootdir", str(workspace / "data"), "--test_area", "test_tile.las",
        "--class8", "--exp_dir", str(workspace / "log") + "/sem_seg/",
        "--log_dir", "run1", "--seed", "0", "--batch_size", "4",
        "--num_point", "256", "--num_votes", "1", "--gpu", "cpu", *extra])


def test_cli_end_to_end(workspace, monkeypatch):
    """Checkpoint written by the port, then the port's test CLI: report,
    label dump with one label per point, .obj files and eval log. Colour is
    on (the reference default), so the model sees 3 extra channels."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.models.convert import variables_from_state_dict
    from tumseg_torch.models.pointnet2_sem_seg import get_model
    from tumseg_torch.train.checkpoint import save_checkpoint

    monkeypatch.chdir(workspace)
    run = workspace / "log" / "sem_seg" / "run1"
    (run / "checkpoints").mkdir(parents=True)
    torch.manual_seed(0)
    save_checkpoint(str(run / "checkpoints" / "best_model.pth"), epoch=1,
                    variables=variables_from_state_dict(
                        get_model(8, 3).state_dict()))
    out = test_cli.main(_cli_args(workspace, "--visual"))
    assert 0.0 <= out["miou"] <= 1.0 and len(out["iou"]) == 8
    assert out["infer_seconds"] > 0
    labels = read_labels_txt(str(run / "visual" / "test_tile.txt"))
    assert labels.shape == (6000,) and 0 <= labels.min() <= labels.max() < 8
    assert (run / "visual" / "test_tile_pred.obj").exists()
    assert (run / "eval.txt").exists()


@pytest.mark.parametrize("flag", ["num_devices", "coordinator"])
def test_cli_mesh_flags(workspace, monkeypatch, flag):
    """``--num_devices 2`` (two spawned ranks) and the coordinator flags (a
    one-rank process group joined here) serve the checkpoint on a mesh:
    the labels of the one-process CLI, the log and the dump written
    once."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.models.convert import variables_from_state_dict
    from tumseg_torch.models.pointnet2_sem_seg import get_model
    from tumseg_torch.parallel import mesh as pmesh
    from tumseg_torch.train.checkpoint import save_checkpoint

    monkeypatch.chdir(workspace)
    run = workspace / "log" / "sem_seg" / "run1"
    (run / "checkpoints").mkdir(parents=True)
    torch.manual_seed(0)
    save_checkpoint(str(run / "checkpoints" / "best_model.pth"), epoch=1,
                    variables=variables_from_state_dict(
                        get_model(8, 3).state_dict()))
    test_cli.main(_cli_args(workspace))
    want = read_labels_txt(str(run / "visual" / "test_tile.txt"))
    (run / "eval.txt").unlink()
    extra = (["--num_devices", "2"] if flag == "num_devices" else
             ["--coordinator_address", f"localhost:{pmesh.free_port()}",
              "--num_processes", "1", "--process_id", "0"])
    try:
        out = test_cli.main(_cli_args(workspace, *extra))
    finally:
        pmesh.close_mesh()
    assert 0.0 <= out["miou"] <= 1.0 and len(out["iou"]) == 8
    got = read_labels_txt(str(run / "visual" / "test_tile.txt"))
    assert got.shape == want.shape == (6000,)
    assert int(np.sum(got != want)) <= 6
    assert (run / "eval.txt").read_text().count("PARAMETER ...") == 1


def test_parser_matches_tumseg(monkeypatch):
    from tumseg.cli import test as jax_cli
    from tumseg_torch.cli import test as port_cli

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        lambda self, argv=None: self)

    def surface(parser):
        return [(a.option_strings, a.dest, a.default, a.type, a.nargs,
                 type(a), a.help) for a in parser._actions]

    assert surface(port_cli.parse_args()) == surface(jax_cli.parse_args())


def test_port_never_imports_jax():
    code = (
        "import sys, torch\n"
        "import chip_smoke, tumseg_torch.cli.test, tumseg_torch.ops.kernels\n"
        "from tumseg_torch.models.pointnet2_sem_seg import get_model\n"
        "m = get_model(8).eval()\n"
        "with torch.inference_mode():\n"
        "    assert m(torch.rand(1, 64, 6))[0].shape == (1, 64, 8)\n"
        "jax = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib')]\n"
        "assert not jax, jax\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
