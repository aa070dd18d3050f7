"""The port's pointnet2_sem_seg against tumseg's on the CPU, with the same
weights (tumseg init -> convert -> load_state_dict(strict=True)) and the same
numpy inputs: log-probs within atol 2e-3 (the ROADMAP's torch-parity
tolerance), argmax agreement >= 99% (near-ties may flip), and the FPS,
ball-query and 3-NN indices of every stage identical. Also the weight
conversion against tools/export_torch_checkpoint.py and tumseg-ckpt-v2
checkpoints in both directions."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg import ops as jops
from tumseg.models import pointnet2_sem_seg as jmodel
from tumseg.train import checkpoint as jckpt
from tumseg_torch import models
from tumseg_torch import ops as tops
from tumseg_torch.models.convert import (state_dict_from_variables,
                                         variables_from_state_dict)
from tumseg_torch.models.pointnet2_sem_seg import (FP_CFGS, SA_CFGS,
                                                   get_model)
from tumseg_torch.nn.layers import calibrate_batch_norm
from tumseg_torch.train import checkpoint as tckpt

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", ROOT / "tools" / "export_torch_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    return np.random.default_rng(1).random((2, 256, 6)).astype(np.float32)


@pytest.fixture(scope="module")
def variables(inputs):
    """tumseg init, with BN running stats calibrated on the inputs so the
    output depends on them, as a numpy pytree."""
    var = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), 8, 0))
    model = get_model(8).eval()
    model.load_state_dict(state_dict_from_variables(var), strict=True)
    calibrate_batch_norm(model, torch.from_numpy(inputs))
    return variables_from_state_dict(model.state_dict())


@pytest.fixture(scope="module")
def port_model(variables):
    model = get_model(8)
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    return model.eval()


def test_forward_matches_tumseg(variables, port_model, inputs):
    var_j = jax.tree_util.tree_map(jnp.asarray, variables)
    want, l4_want, _ = jmodel.apply(var_j, jnp.asarray(inputs),
                                    training=False)
    with torch.inference_mode():
        got, l4_got = port_model(torch.from_numpy(inputs))
    want, got = np.asarray(want), got.numpy()
    assert got.shape == (2, 256, 8) and l4_got.shape == (2, 16, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(l4_got.numpy(), np.asarray(l4_want),
                               rtol=1e-4, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    assert len(np.unique(want.argmax(-1))) > 1  # not a constant output


def test_stage_indices_identical(inputs):
    """FPS, ball query and 3-NN of every stage of the forward, tumseg's CPU
    ops (XLA compositions) against the port's plain ops."""
    xyz_j = jnp.asarray(inputs[..., :3])
    xyz_t = torch.from_numpy(np.ascontiguousarray(inputs[..., :3]))
    levels_j, levels_t = [xyz_j], [xyz_t]
    for cfg in SA_CFGS:
        fj = jops.farthest_point_sample(levels_j[-1], cfg["npoint"])
        ft = tops.farthest_point_sample(levels_t[-1], cfg["npoint"])
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        new_j = jops.gather_rows(levels_j[-1], fj)
        new_t = tops.gather_rows(levels_t[-1], ft)
        np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
        bj = jops.query_ball_point(cfg["radius"], cfg["nsample"],
                                   levels_j[-1], new_j)
        bt = tops.query_ball_point(cfg["radius"], cfg["nsample"],
                                   levels_t[-1], new_t)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        levels_j.append(new_j)
        levels_t.append(new_t)
    assert len(FP_CFGS) == 4
    for lvl in range(4):  # fp1..fp4 interpolate level lvl+1 onto lvl
        _, ij = jops.three_nn_dispatch(levels_j[lvl], levels_j[lvl + 1])
        _, it, _ = tops.three_nn_interpolate(
            levels_t[lvl], levels_t[lvl + 1], torch.zeros(
                2, levels_t[lvl + 1].shape[1], 1))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_convert_matches_export_tool(variables, port_model):
    sd = state_dict_from_variables(variables)
    want = _export_tool().export_state_dict(variables, "pointnet2_sem_seg")
    assert sd.keys() == want.keys() == port_model.state_dict().keys()
    for k in want:
        assert sd[k].shape == tuple(np.shape(want[k])), k
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    back = variables_from_state_dict(port_model.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)


def test_checkpoint_tumseg_to_port(variables, port_model, tmp_path):
    path = str(tmp_path / "jax.pth")
    jckpt.save_checkpoint(path, epoch=3, variables=variables,
                          class_avg_iou=0.5)
    state = tckpt.load_checkpoint(path)
    assert state["epoch"] == 3 and state["class_avg_iou"] == 0.5
    model = get_model(8)
    model.load_state_dict(state_dict_from_variables(
        state["model_state_dict"]), strict=True)
    for k, v in port_model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_checkpoint_port_to_tumseg(variables, port_model, tmp_path):
    path = str(tmp_path / "port.pth")
    tckpt.save_checkpoint(path, epoch=7,
                          variables=variables_from_state_dict(
                              port_model.state_dict()))
    state = jckpt.load_checkpoint(path)
    restored, opt, epoch = jckpt.restore_variables(state)
    assert epoch == 7 and opt is None
    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(variables))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        restored, variables)
    # and the port reads its own file back
    again = tckpt.load_checkpoint(path)["model_state_dict"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, variables)


def test_checkpoint_rejects_pickle(tmp_path):
    import pickle

    path = tmp_path / "legacy.pth"
    path.write_bytes(pickle.dumps({"model_state_dict": {}}))
    with pytest.raises(ValueError, match="convert_legacy_checkpoint"):
        tckpt.load_checkpoint(str(path))


FROZEN_EXTRA = {"pointnet2_sem_seg_original": 3, "pointnet2_sem_seg_trial": 0,
                "pointnet_sem_seg_original": 3}


@pytest.mark.parametrize("name", [*models.AVAILABLE,
                                  "pointnet2_sem_seg_geo_trial"])
def test_registry(name):
    """Every name of tumseg's registry resolves to the port's module of
    that name (the alias to the SSG model); a frozen variant builds its
    pinned channel count and rejects any other, a live model takes any."""
    live = {"pointnet2_sem_seg_geo_trial": "pointnet2_sem_seg"}.get(name,
                                                                     name)
    mod = models.get_module(name)
    assert mod.__name__ == f"tumseg_torch.models.{live}"
    if live == "pointnet2_sem_seg":
        assert mod.get_model is get_model
    fixed = FROZEN_EXTRA.get(name)
    assert getattr(mod, "FIXED_EXTRA_FEATURES", None) == fixed
    if fixed is None:
        assert isinstance(mod.get_model(8, 2), torch.nn.Module)
    else:
        assert isinstance(mod.get_model(8), torch.nn.Module)
        with pytest.raises(ValueError, match="frozen variant"):
            mod.get_model(8, fixed + 1)
    with pytest.raises(ValueError, match="unknown model"):
        models.get_module(name + "_x")


def test_gradients_match_tumseg(inputs):
    """d loss / d params through the port's autograd (the plain group and
    interpolation backward passes) against jax.grad through tumseg, with
    eval-mode BN on tumseg's initial running stats, where the step is well
    conditioned: every parameter gradient within 2e-3 * max|g| of its
    tensor. (BN statistics calibrated on the batch itself, as the other
    tests here use, scale each channel by its own spread and make the
    gradients as sensitive to f32 rounding as a train-mode step is; see
    tests/test_torch_train.py.)"""
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), 8, 0))
    r = np.random.default_rng(2)
    t = r.integers(0, 8, (2, 256)).astype(np.int32)
    w = (r.random(8) + 0.5).astype(np.float32)

    def loss_fn(params):
        logp, aux, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(inputs), training=False)
        return jmodel.loss(logp, jnp.asarray(t), aux, jnp.asarray(w))

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    model = get_model(8)
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    model.eval()
    logp, aux = model(torch.from_numpy(inputs))
    loss = model.loss(logp, torch.from_numpy(t), aux, torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    got = tckpt._flatten(variables_from_state_dict(sd)["params"])
    want = jckpt._flatten_model(jgrads)
    for (path, g), (_, jg) in zip(got, want):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g, jg, rtol=0,
                                   atol=2e-3 * float(np.abs(jg).max()),
                                   err_msg=str(path))


def test_extra_features_channel_contract():
    model = get_model(8, num_extra_features=3).eval()
    assert model.sa1.mlp_convs[0].weight.shape == (32, 12, 1, 1)
    with torch.inference_mode():
        logp, _ = model(torch.rand(1, 128, 9))
    assert logp.shape == (1, 128, 8)
    np.testing.assert_allclose(logp.exp().sum(-1).numpy(), 1.0, atol=1e-5)
