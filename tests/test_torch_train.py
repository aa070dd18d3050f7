"""The port's training path on the CPU against tumseg's, on the same numpy
inputs and the same weights (tumseg init -> convert -> load_state_dict):

- train-mode BatchNorm, rotate_z, the schedules and one optimizer step;
- one training step of pointnet2_sem_seg (train-mode BN, FPS from index 0,
  no dropout, weighted NLL, Adam): the loss within rtol 1e-4, the gradient
  of the whole network within 20% in norm, and a 4-step loss trajectory
  within rtol 2e-2 (tests/test_parity_torch.py's trajectory tolerance: Adam's
  eps-normalised updates turn tiny gradient differences into +-lr steps that
  compound);
- Adam's moments through tumseg-ckpt-v2 checkpoints in both directions;
- the Dense init of tumseg, the engine and the training CLI end to end.

Why the gradient is held in norm and not element by element: in train mode
every BatchNorm's statistics are sums over the batch, and tumseg on the CPU
takes them in f32 with XLA's sequential reduction (65536 terms at sa1). Its
E[x^2] - E[x]^2 is then off by ~1e-3 relative at sa1, and the batch-norm
backward, a difference of batch sums, turns that into gradients that differ
from the float64 truth by ~10% of the whole gradient's norm. The port's f32
gradient is within 0.5% of its own float64 gradient (same indices), and
tumseg's comes within 1% of the port's once its batch statistics are summed
in float64. Element by element, the eval-mode step of test_torch_model.py
holds every gradient within 2e-3 * max|g|. Inputs are centred at zero, which
keeps tumseg's cancellation in E[x^2] - E[x]^2 small enough for the loss.

JAX compiles one step function in this module (B=2, N=256, 8 classes)."""

import argparse
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tumseg.data.las import write_las
from tumseg.models import pointnet2_sem_seg as jmodel
from tumseg.train import checkpoint as jckpt
from tumseg.train import loop as jloop
from tumseg_torch.models.convert import (state_dict_from_variables,
                                         variables_from_state_dict)
from tumseg_torch.models.pointnet2_sem_seg import get_model
from tumseg_torch.nn.layers import BatchNorm, Dense
from tumseg_torch.train import checkpoint as tckpt
from tumseg_torch.train import loop as tloop

ROOT = Path(__file__).resolve().parents[1]
B, N, C = 2, 256, 8
LR, WD, STEPS = 1e-3, 1e-4, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grads_as_params(model):
    """The port's parameter gradients as a tumseg params tree."""
    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    return variables_from_state_dict(sd)["params"]


@pytest.fixture(scope="module")
def setup():
    r = np.random.default_rng(1)
    xs = [r.random((B, N, 6)).astype(np.float32) - np.float32(0.5)
          for _ in range(STEPS)]
    ts = [r.integers(0, C, (B, N)).astype(np.int32) for _ in range(STEPS)]
    w = (r.random(C) + 0.5).astype(np.float32)
    var = jax.tree_util.tree_map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(0), C, 0))
    return xs, ts, w, var


@pytest.fixture(scope="module")
def jax_run(setup):
    xs, ts, w, var = setup
    tx = jloop.make_optimizer("Adam", weight_decay=WD)
    jw = jnp.asarray(w)

    @jax.jit
    def step(params, stats, opt_state, x, t):
        def loss_fn(p):
            logp, aux, new_stats = jmodel.apply(
                {"params": p, "batch_stats": stats}, x, training=True,
                bn_momentum=0.1, rngs={})
            return jmodel.loss(logp, t, aux, jw), new_stats

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(
            params, jax.tree_util.tree_map(lambda u: u * LR, updates))
        return params, new_stats, opt_state, loss, grads

    params, stats = var["params"], var["batch_stats"]
    opt_state = tx.init(params)
    losses, first = [], None
    for x, t in zip(xs, ts):
        params, stats, opt_state, loss, grads = step(
            params, stats, opt_state, jnp.asarray(x), jnp.asarray(t))
        losses.append(float(loss))
        if first is None:
            first = dict(grads=grads, params=params, stats=stats,
                         opt_state=opt_state)
    return dict(losses=losses, **first)


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    """The same four steps in the port; the state after step 1 is saved as
    a tumseg-ckpt-v2 checkpoint."""
    xs, ts, w, var = setup
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(var), strict=True)
    model.train()
    opt = tloop.make_optimizer(model.parameters(), "Adam", WD)
    tw = torch.from_numpy(w)
    losses, grads, path = [], None, None
    for x, t in zip(xs, ts):
        for group in opt.param_groups:
            group["lr"] = LR
        # exact gathers: tumseg's CPU train step gathers exactly (its XLA
        # grouping ignores fast_gather off its accelerator)
        logp, aux = model(torch.from_numpy(x), fast_gather=False)
        loss = model.loss(logp, torch.from_numpy(t), aux, tw)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if grads is None:
            grads = _grads_as_params(model)
            path = str(tmp_path_factory.mktemp("port") / "step1.pth")
            tckpt.save_checkpoint(
                path, epoch=1,
                variables=variables_from_state_dict(model.state_dict()),
                opt_leaves=tckpt.optimizer_leaves(opt, model))
    return dict(losses=losses, grads=grads, ckpt=path)


def test_train_step_matches_tumseg(jax_run, port_run):
    np.testing.assert_allclose(port_run["losses"][0], jax_run["losses"][0],
                               rtol=1e-4)
    want = jckpt._flatten_model(jax_run["grads"])
    got = list(tckpt._flatten(port_run["grads"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(g.shape == np.shape(jg) for (_, g), (_, jg) in zip(got, want))
    diff = np.concatenate([np.ravel(g - np.asarray(jg))
                           for (_, g), (_, jg) in zip(got, want)])
    ref = np.concatenate([np.ravel(np.asarray(jg)) for _, jg in want])
    assert np.linalg.norm(diff) <= 0.2 * np.linalg.norm(ref)


def test_train_trajectory_matches_tumseg(jax_run, port_run):
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                               rtol=2e-2)


def test_batch_norm_train_mode_matches_tumseg():
    from tumseg.nn.layers import batch_norm

    r = np.random.default_rng(3)
    x = (r.standard_normal((2, 5, 4, 16)) * 3 + 1).astype(np.float32)
    bn = BatchNorm(16, momentum=0.3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(r.random(16).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(r.random(16).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(r.random(16).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            r.random(16).astype(np.float32) + 0.5))
    params = {"scale": bn.weight.detach().numpy().copy(),
              "bias": bn.bias.detach().numpy().copy()}
    stats = {"mean": bn.running_mean.numpy().copy(),
             "var": bn.running_var.numpy().copy()}
    y_want, new_stats = batch_norm(params, stats, jnp.asarray(x),
                                   training=True, momentum=0.3)
    y_got = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(y_got.detach().numpy(), np.asarray(y_want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_stats["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_stats["var"]), rtol=1e-5)
    # eval mode reads the updated running stats
    y_eval, _ = batch_norm(params, new_stats, jnp.asarray(x), training=False,
                           momentum=0.3)
    np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(y_eval), rtol=1e-5, atol=1e-6)


def test_rotate_z_matches_tumseg():
    from tumseg.data.augment import jrotate_z
    from tumseg_torch.data.augment import rotate_z

    xyz = np.random.default_rng(4).standard_normal((3, 50, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    angles = np.asarray(jax.random.uniform(key, (3,)) * 2 * jnp.pi)
    got = rotate_z(torch.from_numpy(xyz), torch.from_numpy(angles))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jrotate_z(key, jnp.asarray(xyz))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got.numpy()[..., :2], axis=-1),
                               np.linalg.norm(xyz[..., :2], axis=-1),
                               rtol=1e-5)


def test_schedules_match_tumseg():
    for epoch in [0, 1, 9, 10, 25, 60, 200]:
        assert tloop.lr_schedule(epoch, 1e-3, 0.7, 10) == \
            jloop.lr_schedule(epoch, 1e-3, 0.7, 10)
        assert tloop.bn_momentum_schedule(epoch, 10) == \
            jloop.bn_momentum_schedule(epoch, 10)
    assert tloop.lr_schedule(500, 1e-3, 0.7, 10) == 1e-5
    assert tloop.bn_momentum_schedule(500, 10) == 0.01


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_optimizer_steps_match_optax(name):
    r = np.random.default_rng(6)
    shapes = [(4, 3), (5,)]
    params = [r.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[r.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = jloop.make_optimizer(name, weight_decay=WD)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    opt = tloop.make_optimizer(tp, name, WD)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, [u * LR for u in updates])
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.param_groups[0]["lr"] = LR
        opt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_dense_init_matches_tumseg_and_roundtrip(setup):
    torch.manual_seed(0)
    sa = Dense(256, 256, conv_rank=2)
    assert sa.weight.shape == (256, 256, 1, 1)
    std = float(sa.weight.std())
    assert abs(std - math.sqrt(2.0 / 512)) < 0.05 * math.sqrt(2.0 / 512)
    assert torch.count_nonzero(sa.bias) == 0
    fp = Dense(256, 256, conv_rank=1)
    bound = 1.0 / 16
    for t in (fp.weight, fp.bias):
        assert float(t.abs().max()) <= bound
        assert float(t.abs().max()) > 0.9 * bound
    # a tumseg init converts into the port and back unchanged
    var = setup[3]
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(var), strict=True)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           variables_from_state_dict(model.state_dict()), var)
    # and the port's own init has tumseg's zero SA biases
    assert all(torch.count_nonzero(m.bias) == 0
               for m in get_model(C).modules()
               if isinstance(m, Dense) and m.weight.dim() == 4)


def test_checkpoint_optimizer_state_tumseg_to_port(jax_run, setup, tmp_path):
    """tumseg's TrainEngine state after one step, saved as its fit() saves
    it, resumes in the port with the same Adam moments."""
    w = setup[2]
    jeng = jloop.TrainEngine(jmodel, C, w, optimizer="Adam",
                             weight_decay=WD)
    jeng.params, jeng.batch_stats = jax_run["params"], jax_run["stats"]
    jeng.opt_state = jax_run["opt_state"]
    path = str(tmp_path / "jax.pth")
    jckpt.save_checkpoint(path, epoch=1, variables=jeng.variables(),
                          opt_state=jeng.opt_state)

    eng = tloop.TrainEngine(get_model(C), C, w, optimizer="Adam",
                            weight_decay=WD, device="cpu")
    assert eng.load_state(tckpt.load_checkpoint(path)) == 1
    want = jax.tree_util.tree_leaves(jax_run["opt_state"])
    got = tckpt.optimizer_leaves(eng.optimizer, eng.model)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(got[0]) == 1
    p = eng.model.sa1.mlp_convs[0].weight
    mu = jax_run["opt_state"][1].mu["sa1"][0]["conv"]["w"]
    np.testing.assert_array_equal(
        eng.optimizer.state[p]["exp_avg"][:, :, 0, 0].numpy(),
        np.asarray(mu).T)


def test_checkpoint_optimizer_state_port_to_tumseg(port_run, setup):
    """The port's state after one step loads into tumseg's TrainEngine:
    the same leaves, in optax's structure, close to tumseg's own moments."""
    state = jckpt.load_checkpoint(port_run["ckpt"])
    jeng = jloop.TrainEngine(jmodel, C, setup[2], optimizer="Adam",
                             weight_decay=WD)
    assert jeng.load_state(state) == 1
    adam = jeng.opt_state[1]
    assert int(adam.count) == 1
    saved = tckpt.load_checkpoint(port_run["ckpt"])["optimizer_state_dict"]
    for a, b in zip(jax.tree_util.tree_leaves(jeng.opt_state), saved):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the first moment after one step is (1 - b1) * (g + wd * p)
    g = port_run["grads"]["conv2"]["w"]
    np.testing.assert_allclose(np.asarray(adam.mu["conv2"]["w"]),
                               0.1 * (g + WD * setup[3]["params"]["conv2"]["w"]),
                               rtol=1e-5, atol=1e-9)


def test_engine_lowers_loss_on_fixed_batch():
    """With rotation, random FPS starts and dropout on, as fit() trains;
    the label is the point's height bin, which a z-rotation keeps."""
    r = np.random.default_rng(8)
    x = r.random((B, N, 6)).astype(np.float32)
    t = (x[..., 2] * C).astype(np.int32)
    torch.manual_seed(0)
    eng = tloop.TrainEngine(get_model(C), C, np.ones(C), seed=0,
                            device="cpu")
    losses = [float(eng.train_batch(x, t, 1e-2, 0.1)[0]) for _ in range(8)]
    assert all(math.isfinite(v) for v in losses)
    assert np.mean(losses[-2:]) < 0.8 * losses[0], losses
    loss, tallies = eng.eval_batch(x, t)
    assert int(tallies["seen"].sum()) == B * N and math.isfinite(float(loss))


def test_parser_matches_tumseg(monkeypatch):
    from tumseg.cli import train as jax_cli
    from tumseg_torch.cli import train as port_cli

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        lambda self, argv=None: self)

    def surface(parser):
        return [(a.option_strings, a.dest, a.default, a.type, a.nargs,
                 a.choices, a.const, type(a)) for a in parser._actions]

    assert surface(port_cli.parse_args()) == surface(jax_cli.parse_args())


def test_train_cli_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None  # any import of JAX now fails\n"
        "sys.argv = ['train', '--help']\n"
        "import runpy\n"
        "try:\n"
        "    runpy.run_module('tumseg_torch.cli.train', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--data_pipeline" in res.stdout


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


def _train_args(workspace, *extra):
    from tumseg_torch.cli import train as train_cli

    return train_cli.parse_args([
        "--rootdir", str(workspace / "data"), "--test_area", "test_tile.las",
        "--class8", "--RGB_OFF", "--exp_dir", str(workspace / "log"),
        "--log_dir", "run1", "--seed", "0", "--npoint", "256",
        "--batch_size", "2", "--epoch", "1", "--gpu", "cpu", *extra])


def test_train_cli_end_to_end(workspace, monkeypatch):
    """One epoch of the port's training CLI on a synthetic tile writes both
    checkpoints with optimizer state; tumseg reads them and the port's test
    CLI serves the best one."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli

    monkeypatch.chdir(workspace)
    acc, loss, iou = train_cli.main(_train_args(workspace))
    assert len(acc) == len(loss) == len(iou) == 1
    assert math.isfinite(loss[0]) and 0.0 <= acc[0] <= 1.0
    ckpts = workspace / "log" / "sem_seg" / "run1" / "checkpoints"
    for name in ("model.pth", "best_model.pth"):
        state = jckpt.load_checkpoint(str(ckpts / name))
        assert state["epoch"] == 0
        n_params = len(jax.tree_util.tree_leaves(
            state["model_state_dict"]["params"]))
        assert len(state["optimizer_state_dict"]) == 1 + 2 * n_params
    out = test_cli.main(test_cli.parse_args([
        "--rootdir", str(workspace / "data"), "--test_area", "test_tile.las",
        "--class8", "--RGB_OFF", "--exp_dir", str(workspace / "log") + "/sem_seg/",
        "--log_dir", "run1", "--num_point", "256", "--batch_size", "4",
        "--num_votes", "1", "--seed", "0", "--gpu", "cpu"]))
    assert 0.0 <= out["miou"] <= 1.0


@pytest.mark.parametrize("flag", ["num_devices", "coordinator"])
def test_train_cli_mesh_flags(workspace, monkeypatch, flag):
    """``--num_devices 2`` starts two ranks of ``_run`` on the CPU (the run
    itself is tests/test_torch_parallel.py's); the coordinator flags join a
    process group here, a mesh of one rank, and train on it: rank 0 writes
    the log and the checkpoints."""
    from tumseg_torch.cli import train as train_cli
    from tumseg_torch.parallel import mesh as pmesh

    monkeypatch.chdir(workspace)
    if flag == "num_devices":
        calls = []
        monkeypatch.setattr(pmesh, "spawn",
                            lambda *a, **kw: calls.append((a, kw)) or "done")
        assert train_cli.main(_train_args(workspace, "--num_devices",
                                          "2")) == "done"
        (fn, nprocs, (run, args, devices)), kw = calls[0]
        assert (fn, nprocs, run) == (pmesh._cli_rank, 2, train_cli._run)
        assert args.num_devices == 2
        assert devices == [torch.device("cpu")] * 2
        assert kw == {"backend": "gloo", "threads": 1}
        return
    try:
        acc, loss, iou = train_cli.main(_train_args(
            workspace, "--coordinator_address",
            f"localhost:{pmesh.free_port()}", "--num_processes", "1",
            "--process_id", "0"))
    finally:
        pmesh.close_mesh()
    assert len(acc) == 1 and math.isfinite(loss[0])
    run = workspace / "log" / "sem_seg" / "run1"
    text = (run / "logs" / "pointnet2_sem_seg.txt").read_text()
    assert text.count("Saving at") == 2
    state = jckpt.load_checkpoint(str(run / "checkpoints" / "model.pth"))
    assert state["epoch"] == 0
