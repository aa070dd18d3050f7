"""The port's pointnet2_sem_seg_msg against tumseg's on the CPU, with the same
weights (tumseg init -> convert -> load_state_dict(strict=True)) and the same
numpy inputs:

- one MSG set abstraction against ``tumseg.nn.layers.set_abstraction_msg``
  within 1e-4;
- the full-width forward at B=2 x 256: log-probs within atol 2e-3 (the
  ROADMAP's torch-parity tolerance), argmax agreement >= 99%, a
  non-constant output;
- the nested MSG weight names against tools/port_torch_checkpoint.py and
  tumseg-ckpt-v2 checkpoints in both directions;
- gradients with eval-mode BN within 2e-3 * max|g| of each tensor, and one
  train-mode step: the loss within rtol 1e-4 and the whole gradient within
  20% in norm (train-mode BN on the CPU is ill-conditioned in tumseg's f32
  batch sums; tests/test_torch_train.py says why);
- a tiny training and serving run through both CLIs.

JAX compiles three functions of the MSG model here (B=2, N=256, 8
classes): the calibrated forward and the eval- and train-mode gradients."""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg.data.las import write_las
from tumseg.models import pointnet2_sem_seg_msg as jmodel
from tumseg.nn import layers as L
from tumseg.train import checkpoint as jckpt
from tumseg.train import loop as jloop
from tumseg_torch.models.convert import (state_dict_from_variables,
                                         variables_from_state_dict)
from tumseg_torch.models.pointnet2_sem_seg_msg import (FP_CFGS, SA_CFGS,
                                                       get_model)
from tumseg_torch.nn.layers import SetAbstractionMsg, calibrate_batch_norm
from tumseg_torch.train import checkpoint as tckpt

ROOT = Path(__file__).resolve().parents[1]
B, N, C = 2, 256, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _init():
    return jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0), C, 0))


@pytest.fixture(scope="module")
def inputs():
    return np.random.default_rng(1).random((B, N, 6)).astype(np.float32)


@pytest.fixture(scope="module")
def variables(inputs):
    """tumseg init, BN running stats calibrated on the inputs so that the
    output depends on them, as a numpy pytree."""
    model = get_model(C).eval()
    model.load_state_dict(state_dict_from_variables(_init()), strict=True)
    calibrate_batch_norm(model, torch.from_numpy(inputs))
    return variables_from_state_dict(model.state_dict())


@pytest.fixture(scope="module")
def port_model(variables):
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("with_points", [True, False])
def test_set_abstraction_msg_matches_tumseg(with_points):
    cfg = dict(npoint=64, radius_list=[0.1, 0.2], nsample_list=[8, 16],
               mlp_list=[[16, 32], [16, 24]])
    r = np.random.default_rng(3)
    xyz = r.random((B, N, 3)).astype(np.float32)
    points = r.standard_normal((B, N, 6)).astype(np.float32)
    in_ch = 6 if with_points else 0
    p, s = L.set_abstraction_msg_init(jax.random.PRNGKey(4), cfg["npoint"],
                                      cfg["radius_list"], cfg["nsample_list"],
                                      in_ch, cfg["mlp_list"])
    want_xyz, want, _ = L.set_abstraction_msg(
        p, s, cfg, jnp.asarray(xyz),
        jnp.asarray(points) if with_points else None, training=False,
        momentum=0.1)
    layer = SetAbstractionMsg(cfg["npoint"], cfg["radius_list"],
                              cfg["nsample_list"], in_ch, cfg["mlp_list"])
    sd = state_dict_from_variables(jax.tree_util.tree_map(
        np.asarray, {"params": {"sa": p}, "batch_stats": {"sa": s}}))
    layer.load_state_dict({k[3:]: v for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        got_xyz, got = layer.eval()(
            torch.from_numpy(xyz),
            torch.from_numpy(points) if with_points else None)
    assert got.shape == (B, 64, 56)
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_forward_matches_tumseg(variables, port_model, inputs):
    var_j = jax.tree_util.tree_map(jnp.asarray, variables)
    want, l4_want, _ = jax.jit(lambda v, x: jmodel.apply(v, x))(
        var_j, jnp.asarray(inputs))
    with torch.inference_mode():
        got, l4_got = port_model(torch.from_numpy(inputs))
    want, got = np.asarray(want), got.numpy()
    assert got.shape == (B, N, C) and l4_got.shape == (B, 16, 1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(l4_got.numpy(), np.asarray(l4_want),
                               rtol=1e-4, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    assert len(np.unique(want.argmax(-1))) > 1  # not a constant output


def test_weight_names_match_port_tool(variables, port_model):
    """The port's sa{i}.conv_blocks.{s} / sa{i}.bn_blocks.{s} stacks read by
    tools/port_torch_checkpoint.py's _mlp_stack give tumseg's nested MSG
    params, and convert round-trips them."""
    tool = _tool("port_torch_checkpoint")
    sd = {k: v.numpy()
          for k, v in state_dict_from_variables(variables).items()}
    assert sd.keys() == port_model.state_dict().keys()
    params, stats = variables["params"], variables["batch_stats"]
    for i, cfg in enumerate(SA_CFGS, start=1):
        assert len(params[f"sa{i}"]) == len(cfg["mlp_list"]) == 2
        for s, mlp in enumerate(cfg["mlp_list"]):
            p, st = tool._mlp_stack(sd, f"sa{i}.conv_blocks.{s}",
                                    f"sa{i}.bn_blocks.{s}")
            assert [layer["conv"]["w"].shape[1] for layer in p] == mlp
            jax.tree_util.tree_map(np.testing.assert_array_equal, p,
                                   params[f"sa{i}"][s])
            jax.tree_util.tree_map(np.testing.assert_array_equal, st,
                                   stats[f"sa{i}"][s])
    for i, cfg in zip([4, 3, 2, 1], FP_CFGS):
        p, _ = tool._mlp_stack(sd, f"fp{i}.mlp_convs", f"fp{i}.mlp_bns")
        assert p[0]["conv"]["w"].shape[0] == cfg["in_channel"]
    assert port_model.sa1.conv_blocks[1][0].weight.shape == (32, 9, 1, 1)
    assert port_model.sa3.conv_blocks[0][1].weight.shape == (196, 128, 1, 1)
    back = variables_from_state_dict(port_model.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)


def test_checkpoint_both_directions(variables, port_model, tmp_path):
    path = str(tmp_path / "jax.pth")
    jckpt.save_checkpoint(path, epoch=2, variables=variables)
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(
        tckpt.load_checkpoint(path)["model_state_dict"]), strict=True)
    for k, v in port_model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k

    path = str(tmp_path / "port.pth")
    tckpt.save_checkpoint(path, epoch=5, variables=variables_from_state_dict(
        port_model.state_dict()))
    restored, opt, epoch = jckpt.restore_variables(jckpt.load_checkpoint(path))
    assert epoch == 5 and opt is None
    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(variables))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        restored, variables)


def _port_grads(model):
    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    return tckpt._flatten(variables_from_state_dict(sd)["params"])


@pytest.mark.parametrize("training", [False, True])
def test_gradients_match_tumseg(inputs, training):
    """d loss / d params through the port's autograd against jax.grad
    through tumseg, on tumseg's initial weights and BN statistics. Eval-mode
    BN: every gradient within 2e-3 * max|g| of its tensor. Train-mode BN
    (FPS from 0, no dropout): the loss within rtol 1e-4, the whole gradient
    within 20% in norm. Inputs are centred for the train step, as in
    tests/test_torch_train.py."""
    variables = _init()
    r = np.random.default_rng(2)
    x = inputs - np.float32(0.5) if training else inputs
    t = r.integers(0, C, (B, N)).astype(np.int32)
    w = (r.random(C) + 0.5).astype(np.float32)

    @jax.jit
    def value_and_grad(params):
        def loss_fn(p):
            logp, aux, _ = jmodel.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                jnp.asarray(x), training=training, bn_momentum=0.1, rngs={})
            return jmodel.loss(logp, jnp.asarray(t), aux, jnp.asarray(w))
        return jax.value_and_grad(loss_fn)(params)

    jloss, jgrads = value_and_grad(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    model.train(training)
    logp, aux = model(torch.from_numpy(x))
    loss = model.loss(logp, torch.from_numpy(t), aux, torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4 if training else 1e-5)
    got = list(_port_grads(model))
    want = jckpt._flatten_model(jgrads)
    assert [p for p, _ in got] == [p for p, _ in want]
    if training:
        diff = np.concatenate([np.ravel(g - np.asarray(jg))
                               for (_, g), (_, jg) in zip(got, want)])
        ref = np.concatenate([np.ravel(np.asarray(jg)) for _, jg in want])
        assert np.linalg.norm(diff) <= 0.2 * np.linalg.norm(ref)
        return
    for (path, g), (_, jg) in zip(got, want):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g, jg, rtol=0,
                                   atol=2e-3 * float(np.abs(jg).max()),
                                   err_msg=str(path))


@pytest.fixture
def workspace(tmp_path):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    r = np.random.default_rng(0)
    # 1500 points per m^2, so a 1 m block holds the > 1024 points that
    # TrainBlockDataset's block sampling waits for
    for name, n in [("building.las", 12000), ("test_tile.las", 12000)]:
        xyz = np.stack([r.uniform(0, 4, n), r.uniform(0, 2, n),
                        r.uniform(0, 5, n)], 1)
        write_las(str(data_dir / name), xyz, r.choice([1, 2, 3, 7], n))
    return tmp_path


def test_cli_train_and_serve_msg(workspace, monkeypatch):
    """One epoch of the training CLI with --model pointnet2_sem_seg_msg
    writes its log and checkpoints (tumseg's MSG engine resumes from them,
    Adam moments included); the test CLI serves the best one."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli

    monkeypatch.chdir(workspace)
    acc, loss, iou = train_cli.main(train_cli.parse_args([
        "--model", "pointnet2_sem_seg_msg", "--rootdir",
        str(workspace / "data"), "--test_area", "test_tile.las", "--class8",
        "--RGB_OFF", "--exp_dir", str(workspace / "log"), "--log_dir", "run1",
        "--seed", "0", "--npoint", "256", "--batch_size", "2", "--epoch", "1",
        "--gpu", "cpu"]))
    assert len(acc) == len(loss) == 1 and math.isfinite(loss[0])
    run = workspace / "log" / "sem_seg" / "run1"
    text = (run / "logs" / "pointnet2_sem_seg_msg.txt").read_text()
    assert "Training mean loss:" in text
    state = jckpt.load_checkpoint(str(run / "checkpoints" / "best_model.pth"))
    jeng = jloop.TrainEngine(jmodel, C, np.ones(C), optimizer="Adam",
                             weight_decay=1e-4)
    assert jeng.load_state(state) == 0
    assert int(jeng.opt_state[1].count) >= 1
    out = test_cli.main(test_cli.parse_args([
        "--model", "pointnet2_sem_seg_msg", "--rootdir",
        str(workspace / "data"), "--test_area", "test_tile.las", "--class8",
        "--RGB_OFF", "--exp_dir", str(workspace / "log") + "/sem_seg/",
        "--log_dir", "run1", "--num_point", "256", "--batch_size", "4",
        "--num_votes", "1", "--seed", "0", "--gpu", "cpu"]))
    assert 0.0 <= out["miou"] <= 1.0 and len(out["iou"]) == C
