"""The port's PointNet (``pointnet_sem_seg``) and the frozen variants against
tumseg on the CPU, at full width, with the same weights (tumseg init ->
convert -> load_state_dict(strict=True)) and the same numpy inputs (B=4,
N=256, 8 classes):

- the STN (k = 3 and 64), the encoder (both ``global_feat``) and the
  feature-transform regularizer, each within 1e-5 of the largest |value|;
- the f32 forward: log-probs within 1e-4, argmax agreement >= 99%;
- the bf16 forward (``compute_dtype``) within tests/test_torch_bf16.py's
  tolerance for a whole forward, 4 bf16 steps of the largest |log-prob|;
- eval-mode-BN gradients within 2e-3 * max|g| of each tensor, and one
  train-mode loss, regularizer included, within rtol 1e-4 (B = 4: the
  STN's fc batch norms normalise over B alone);
- the weights against tools/export_torch_checkpoint.py and
  tools/port_torch_checkpoint.py, and tumseg-ckpt-v2 checkpoints with Adam
  state in both directions;
- the frozen variants' pinned channel counts, and both CLIs end to end.

JAX runs eagerly here: no function of this file is jitted."""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg.data.las import write_las
from tumseg.models import get_module as jget_module
from tumseg.models import pointnet_sem_seg as jmodel
from tumseg.nn import layers as L
from tumseg.train import checkpoint as jckpt
from tumseg.train import loop as jloop
from tumseg_torch import models
from tumseg_torch.models.convert import (state_dict_from_variables,
                                         variables_from_state_dict)
from tumseg_torch.models.pointnet_sem_seg import get_model
from tumseg_torch.nn.layers import (STN, PointNetEncoder,
                                    calibrate_batch_norm,
                                    feature_transform_regularizer)
from tumseg_torch.train import checkpoint as tckpt
from tumseg_torch.train import loop as tloop

ROOT = Path(__file__).resolve().parents[1]
B, N, C = 4, 256, 8
LAYER_RTOL = 1e-5    # of a layer's largest |value|
STEP = 2.0 ** -8     # a bf16 step, relative to the binade of the value
LOGP_STEPS = 4       # tests/test_torch_bf16.py's bound on a whole forward
WD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol=LAYER_RTOL, what=""):
    """max|got - want| within ``rtol`` of the largest |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    tol = rtol * float(np.abs(want).max())
    assert err <= tol, f"{what}: max|diff| {err:g} > {tol:g}"


@pytest.fixture(scope="module")
def inputs():
    return np.random.default_rng(1).random((B, N, 6)).astype(np.float32)


@pytest.fixture(scope="module")
def variables(inputs):
    """tumseg init, BN running stats calibrated on the inputs so the output
    depends on them, as a numpy pytree."""
    var = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), C, 0))
    model = get_model(C).eval()
    model.load_state_dict(state_dict_from_variables(var), strict=True)
    calibrate_batch_norm(model, torch.from_numpy(inputs))
    return variables_from_state_dict(model.state_dict())


@pytest.fixture(scope="module")
def port_model(variables):
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    return model.eval()


def _jvars(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


@pytest.mark.parametrize("k", [3, 64])
def test_stn_matches_tumseg(variables, port_model, inputs, k):
    name = "stn" if k == 3 else "fstn"
    x = inputs if k == 3 else np.random.default_rng(2).random(
        (B, N, 64)).astype(np.float32)
    v = _jvars(variables)
    want, _ = L.stn_apply(v["params"]["feat"][name],
                          v["batch_stats"]["feat"][name], jnp.asarray(x), k,
                          training=False, momentum=0.1)
    stn = getattr(port_model.feat, name)
    assert isinstance(stn, STN)
    with torch.inference_mode():
        got = stn(torch.from_numpy(x))
    assert got.shape == (B, k, k)
    _close(got, want, what=name)


@pytest.mark.parametrize("global_feat", [False, True])
def test_encoder_matches_tumseg(variables, port_model, inputs, global_feat):
    v = _jvars(variables)
    feat, trans, trans_feat, _ = L.pointnet_encoder(
        v["params"]["feat"], v["batch_stats"]["feat"], jnp.asarray(inputs),
        global_feat=global_feat, feature_transform=True, training=False,
        momentum=0.1)
    enc = PointNetEncoder(6, global_feat=global_feat, feature_transform=True)
    enc.load_state_dict(port_model.feat.state_dict(), strict=True)
    with torch.inference_mode():
        got, got_trans, got_tf = enc.eval()(torch.from_numpy(inputs))
    assert got.shape == ((B, 1024) if global_feat else (B, N, 1088))
    _close(got, feat, what="features")
    _close(got_trans, trans, what="trans")
    _close(got_tf, trans_feat, what="trans_feat")


def test_regularizer_matches_tumseg():
    r = np.random.default_rng(3)
    trans = (np.eye(64) + 0.1 * r.standard_normal((B, 64, 64))).astype(
        np.float32)
    want = L.feature_transform_regularizer(jnp.asarray(trans))
    got = feature_transform_regularizer(torch.from_numpy(trans))
    np.testing.assert_allclose(float(got), float(want), rtol=LAYER_RTOL)


def test_forward_matches_tumseg(variables, port_model, inputs):
    want, tf_want, _ = jmodel.apply(_jvars(variables), jnp.asarray(inputs),
                                    training=False)
    with torch.inference_mode():
        got, tf_got = port_model(torch.from_numpy(inputs))
    want, got = np.asarray(want), got.numpy()
    assert got.shape == (B, N, C) and tf_got.shape == (B, 64, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    _close(tf_got, tf_want, what="trans_feat")
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    assert len(np.unique(want.argmax(-1))) > 1  # not a constant output


def test_bf16_forward_matches_tumseg(variables, port_model, inputs):
    """Within LOGP_STEPS bf16 steps of the largest |log-prob|; an argmax
    may differ only where tumseg's top two lie within twice that."""
    want, _, _ = jmodel.apply(_jvars(variables), jnp.asarray(inputs),
                              training=False, compute_dtype=jnp.bfloat16)
    with torch.inference_mode():
        got, _ = port_model(torch.from_numpy(inputs),
                            compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    want, got = _np(want), _np(got)
    tol = LOGP_STEPS * STEP * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max|dlogp| {err:g} > {tol:g}"
    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    agree = got.argmax(-1) == want.argmax(-1)
    assert np.all(margin[~agree] <= 2 * tol)
    assert agree[margin > 2 * tol].mean() >= 0.99


def _labels(seed):
    r = np.random.default_rng(seed)
    return (r.integers(0, C, (B, N)).astype(np.int32),
            (r.random(C) + 0.5).astype(np.float32))


def test_gradients_match_tumseg(inputs):
    """d loss / d params, regularizer included, with eval-mode BN on
    tumseg's initial running stats: every gradient within 2e-3 * max|g| of
    its tensor."""
    var = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), C, 0))
    t, w = _labels(2)

    def loss_fn(params):
        logp, aux, _ = jmodel.apply(
            {"params": params, "batch_stats": var["batch_stats"]},
            jnp.asarray(inputs), training=False)
        return jmodel.loss(logp, jnp.asarray(t), aux, jnp.asarray(w))

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, var["params"]))
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(var), strict=True)
    model.eval()
    logp, aux = model(torch.from_numpy(inputs))
    loss = model.loss(logp, torch.from_numpy(t), aux, torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    got = tckpt._flatten(variables_from_state_dict(sd)["params"])
    want = jckpt._flatten_model(jgrads)
    n = 0
    for (path, g), (jpath, jg) in zip(got, want):
        assert path == jpath
        jg = np.asarray(jg)
        np.testing.assert_allclose(g, jg, rtol=0,
                                   atol=2e-3 * float(np.abs(jg).max()),
                                   err_msg=str(path))
        n += 1
    assert n == len(list(model.parameters()))


def test_train_loss_matches_tumseg(variables, inputs):
    """Train-mode BN (batch statistics, running stats updated): the loss,
    0.001 x the regularizer included, within rtol 1e-4, and the running
    stats of the STN's fc batch norm as tumseg updates them."""
    t, w = _labels(4)
    logp, aux, new_stats = jmodel.apply(_jvars(variables),
                                        jnp.asarray(inputs), training=True,
                                        bn_momentum=0.1)
    jloss = jmodel.loss(logp, jnp.asarray(t), aux, jnp.asarray(w))
    jreg = L.feature_transform_regularizer(aux)
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    model.train()
    logp_t, aux_t = model(torch.from_numpy(inputs))
    loss = model.loss(logp_t, torch.from_numpy(t), aux_t,
                      torch.from_numpy(w))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    reg = float(feature_transform_regularizer(aux_t))
    np.testing.assert_allclose(reg, float(jreg), rtol=1e-4)
    assert reg > 0.0
    nll = torch.nn.functional.nll_loss(logp_t.reshape(-1, C),
                                       torch.from_numpy(t).reshape(-1).long(),
                                       weight=torch.from_numpy(w))
    np.testing.assert_allclose(float(loss - nll), 0.001 * reg, rtol=1e-4)
    _close(model.feat.stn.bn4.running_var,
           new_stats["feat"]["stn"]["bn4"]["var"], rtol=1e-4, what="bn4")


def test_weights_match_both_tools(variables, port_model):
    sd = state_dict_from_variables(variables)
    want = _tool("export_torch_checkpoint").export_state_dict(
        variables, "pointnet_sem_seg")
    assert sd.keys() == want.keys() == port_model.state_dict().keys()
    for k in want:
        assert sd[k].shape == tuple(np.shape(want[k])), k
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    assert sd["feat.stn.fc1.weight"].shape == (512, 1024)
    assert sd["feat.fstn.fc3.weight"].shape == (4096, 256)
    assert sd["feat.conv1.weight"].shape == (64, 6, 1)
    ported = _tool("port_torch_checkpoint").port_state_dict(
        port_model.state_dict(), "pointnet_sem_seg")
    back = variables_from_state_dict(port_model.state_dict())
    for tree in (ported, back):
        assert (jax.tree_util.tree_structure(tree)
                == jax.tree_util.tree_structure(variables))
        jax.tree_util.tree_map(np.testing.assert_array_equal, tree, variables)


def _adam_state(params, seed):
    """tumseg's Adam state over ``params`` with random moments and a
    count of 3."""
    template = jloop.make_optimizer("Adam", weight_decay=WD).init(params)
    r = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    leaves = [np.asarray(3, np.int32) if np.ndim(a) == 0 and
              np.asarray(a).dtype == np.int32 else
              r.standard_normal(np.shape(a)).astype(np.float32)
              for a in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def test_checkpoint_tumseg_to_port(variables, port_model, tmp_path):
    """tumseg's variables and Adam state resume in the port's engine."""
    opt_state = _adam_state(variables["params"], 5)
    path = str(tmp_path / "jax.pth")
    jckpt.save_checkpoint(path, epoch=2, variables=variables,
                          opt_state=opt_state, class_avg_iou=0.25)
    eng = tloop.TrainEngine(get_model(C), C, np.ones(C), device="cpu")
    assert eng.load_state(tckpt.load_checkpoint(path)) == 2
    for k, v in port_model.state_dict().items():
        assert torch.equal(eng.model.state_dict()[k], v), k
    want = jax.tree_util.tree_leaves(opt_state)
    got = tckpt.optimizer_leaves(eng.optimizer, eng.model)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    p = eng.model.feat.stn.fc1.weight
    mu = opt_state[1].mu["feat"]["stn"]["fc1"]["w"]
    np.testing.assert_array_equal(
        eng.optimizer.state[p]["exp_avg"].numpy(), np.asarray(mu).T)


def test_checkpoint_port_to_tumseg(variables, inputs, tmp_path):
    """The port's engine after one step saves weights and Adam state that
    tumseg's checkpoint code restores into its optimizer's structure."""
    t, w = _labels(6)
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    eng = tloop.TrainEngine(model, C, w, weight_decay=WD, device="cpu",
                            augment_rotate=False)
    eng.train_batch(inputs, t, 1e-3, 0.1)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    path = str(tmp_path / "port.pth")
    eng.save(path, epoch=1)
    state = jckpt.load_checkpoint(path)
    restored, leaves, epoch = jckpt.restore_variables(state)
    assert epoch == 1
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        restored, variables_from_state_dict(model.state_dict()))
    tx = jloop.make_optimizer("Adam", weight_decay=WD)
    opt_state = jckpt.unflatten_opt_state(tx.init(restored["params"]), leaves)
    adam = opt_state[1]
    assert int(adam.count) == 1
    # the first moment after one step is (1 - b1) * (g + wd * p)
    g = grads["feat.stn.fc1.weight"].numpy().T
    p0 = variables["params"]["feat"]["stn"]["fc1"]["w"]
    np.testing.assert_allclose(np.asarray(adam.mu["feat"]["stn"]["fc1"]["w"]),
                               0.1 * (g + WD * p0), rtol=1e-5, atol=1e-9)


FROZEN = [("pointnet2_sem_seg_original", 3), ("pointnet2_sem_seg_trial", 0),
          ("pointnet_sem_seg_original", 3)]


@pytest.mark.parametrize("name,fixed", FROZEN)
def test_frozen_variant_contract(name, fixed):
    mod = models.get_module(name)
    assert mod.FIXED_EXTRA_FEATURES == fixed
    first = ("feat.stn.conv1.weight" if name.startswith("pointnet_")
             else "sa1.mlp_convs.0.weight")
    for model in (mod.get_model(C), mod.get_model(C, fixed)):
        assert model.state_dict()[first].shape[1] == 6 + fixed + (
            0 if name.startswith("pointnet_") else 3)
    with pytest.raises(ValueError) as port_err:
        mod.get_model(C, fixed + 1)
    with pytest.raises(ValueError) as jax_err:
        jget_module(name).init(jax.random.PRNGKey(0), C, fixed + 1)
    assert str(port_err.value) == str(jax_err.value)


@pytest.fixture
def workspace(tmp_path):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    r = np.random.default_rng(0)
    # 1500 points per m^2: TrainBlockDataset's blocks need > 1024 points
    for name, n in [("building.las", 12000), ("test_tile.las", 12000)]:
        xyz = np.stack([r.uniform(0, 4, n), r.uniform(0, 2, n),
                        r.uniform(0, 5, n)], 1)
        write_las(str(data_dir / name), xyz, r.choice([1, 2, 3, 7], n))
    return tmp_path


def test_cli_train_and_serve(workspace, monkeypatch):
    """One epoch of ``cli.train --model pointnet_sem_seg`` writes a
    checkpoint with Adam state that ``cli.test`` serves."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli

    monkeypatch.chdir(workspace)
    common = ["--model", "pointnet_sem_seg", "--rootdir",
              str(workspace / "data"), "--test_area", "test_tile.las",
              "--class8", "--RGB_OFF", "--seed", "0", "--gpu", "cpu"]
    acc, loss, iou = train_cli.main(train_cli.parse_args(common + [
        "--exp_dir", str(workspace / "log"), "--log_dir", "run1",
        "--npoint", "256", "--batch_size", "2", "--epoch", "1"]))
    assert len(acc) == len(loss) == 1 and math.isfinite(loss[0])
    state = jckpt.load_checkpoint(str(workspace / "log" / "sem_seg" / "run1"
                                      / "checkpoints" / "best_model.pth"))
    n_params = len(jax.tree_util.tree_leaves(
        state["model_state_dict"]["params"]))
    assert "fstn" in state["model_state_dict"]["params"]["feat"]
    assert len(state["optimizer_state_dict"]) == 1 + 2 * n_params
    out = test_cli.main(test_cli.parse_args(common + [
        "--exp_dir", str(workspace / "log") + "/sem_seg/", "--log_dir",
        "run1", "--num_point", "256", "--batch_size", "4", "--num_votes",
        "1"]))
    assert 0.0 <= out["miou"] <= 1.0 and len(out["iou"]) == C
