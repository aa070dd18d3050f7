"""PointNeXt-XL (``tumseg_torch.models.pointnext_sem_seg``) on the CPU
against its plain reference, ``gpubench/reference/pointnext.py``, at the
published widths with the strides cut to 2 (the reference's ``tiny``), so
that a 128-point block keeps 8 points at stage 4:

- the registry's model at 18 classes and 9 channels has the published
  41,577,106 parameters, and the reference's seeded weights load strictly;
- the eval forward, the training forward with a generator (FPS starts,
  dropout) in both gather modes, and the loss equal the reference's; every
  parameter's gradient within rtol 1e-5 and 1e-6 of the largest;
- one InvResMLP alone equals the reference's block, on an input where a
  missing residual, a ReLU before the add or offsets not divided by the
  radius each change the output;
- the checkpoint layout round trip (convs without bias, the local
  aggregations' ``[out, in, 1, 1]`` convs), the spans of an eager forward,
  the training CLI on the device pipeline and the test CLI's vote path,
  and the vote path's pool against the reference's.

The JAX package has no PointNeXt, so nothing here imports it."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from gpubench import spec
from gpubench.reference import ops as RO
from gpubench.reference import pointnext as R
from tumseg_torch import models
from tumseg_torch.models import pointnext_sem_seg as P
from tumseg_torch.nn.layers import InvResMLP

NAME = "pointnext_sem_seg"


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads: the suite runs several test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(monkeypatch):
    """The reference's tiny configuration and the port's strides set to
    match it."""
    cfg, program = R.tiny(spec.config("pointnext_xl"))
    for attribute, index, key, value in program:
        monkeypatch.setitem(getattr(P, attribute)[index], key, value)
    return cfg


def _pair(cfg, seed=3):
    """The reference's seeded weights and the port's model loaded with
    them (strictly)."""
    w = R.make_weights(cfg, seed, torch.device("cpu"))
    model = models.get_module(NAME).get_model(18, 3)
    model.load_state_dict({k: v.clone() for k, v in w.items()})
    return w, model


def test_registry_size_and_strict_load():
    model = models.get_module(NAME).get_model(18, 3)
    assert isinstance(model, P.PointNeXtSemSeg)
    assert sum(p.numel() for p in model.parameters()) == 41_577_106
    cfg = spec.config("pointnext_xl")
    assert [s["width"] for s in P.STAGES] == R.widths(cfg)
    assert [s["stride"] for s in P.STAGES] == cfg["strides"]
    assert [s["blocks"] for s in P.STAGES] == cfg["blocks"]
    assert [[s["radius"]] + [s["radius"] * P.RADIUS_SCALING] *
            (s["blocks"] - 1) for s in P.STAGES[1:]] == R.radii(cfg)[1:]
    model.load_state_dict(R.make_weights(cfg, 1, torch.device("cpu")))


def test_eval_forward_equals_the_reference(tiny):
    w, model = _pair(tiny)
    x = torch.rand(2, 128, 9, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, aux = model.eval()(x)
    assert aux.shape == (2, 8, 1024)
    assert torch.equal(got, R.Net(tiny, w, "eval").forward(x)[0])


@pytest.mark.parametrize("fast", [False, True])
def test_train_forward_loss_and_gradients(tiny, fast):
    """The training forward with the generator's draws and the gathers of
    ``fast``, and the weighted NLL, bitwise; the gradients within rtol 1e-5
    and 1e-6 of the largest parameter gradient. They agree to the bit on
    this input, but nothing pins that: the two sides' backward graphs
    differ (the offsets' division in place against a concatenation,
    ``core.batch_norm``'s ops against the reference's formula), so
    autograd may sum a gradient in another order, and a last-bit
    difference grows through 58 BatchNorms; the tolerance is the one that
    ``gpubench``'s tests hold every architecture's gradients to."""
    w, model = _pair(tiny)
    x = torch.rand(2, 128, 9, generator=torch.Generator().manual_seed(1))
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    lp, aux = model.train()(x, generator=g1, fast_gather=fast)
    names = dict(model.named_parameters())
    params = {k: v.clone().requires_grad_(k in names) for k, v in w.items()}
    ref, ref_aux = R.Net(tiny, params, "train", fast=fast,
                         generator=g2).forward(x)
    assert torch.equal(lp, ref)
    assert g1.get_state().equal(g2.get_state())
    target = torch.randint(0, 18, (2, 128),
                           generator=torch.Generator().manual_seed(2))
    cw = torch.rand(18, generator=torch.Generator().manual_seed(4)) + 0.5
    loss = model.loss(lp, target, aux, cw)
    ref_loss = R.loss(tiny, ref, target, ref_aux, cw)
    assert torch.equal(loss, ref_loss)
    loss.backward()
    ref_loss.backward()
    scale = max(params[n].grad.abs().max() for n in names)
    for n, p in names.items():
        assert torch.allclose(p.grad, params[n].grad, rtol=1e-5,
                              atol=1e-6 * scale), n


def _block_inputs():
    g = torch.Generator().manual_seed(7)
    xyz = torch.rand(2, 64, 3, generator=g) * 0.5
    feat = torch.randn(2, 64, 16, generator=g)
    return xyz, feat


def _block_reference(w, xyz, feat, radius, nsample, mutation=None):
    """The reference's InvResMLP over the block's weights ``w`` (its own
    state-dict names), or the block with one ``mutation``: "residual"
    leaves out the residual, "relu_before_add" puts a ReLU on bn2 before
    the add, "undivided" leaves the offsets undivided by the radius."""
    net = R.Net({"nsample": nsample}, w, "train")
    if mutation == "undivided":
        idx = RO.ball_query([radius], [nsample], xyz, xyz)[0]
        g = RO.Group.apply(idx, torch.cat([xyz, feat], -1), xyz, False)
        h = net.layer("aggr.conv", g).amax(dim=2)
    else:
        h = net.aggregate("aggr.conv", radius, xyz, xyz, feat)
    h = net.layer("pw2", net.layer("pw1", h),
                  relu=mutation == "relu_before_add")
    return F.relu(h) if mutation == "residual" else F.relu(h + feat)


def _block():
    torch.manual_seed(11)
    block = InvResMLP(16, 0.2, 8, 4).train()
    with torch.no_grad():
        for bn in (block.aggr.bn, block.bn1, block.bn2):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0.0, 0.5)
    return block


def test_inv_res_mlp_equals_the_reference_block():
    block = _block()
    w = {k: v.detach().clone() for k, v in block.state_dict().items()}
    xyz, feat = _block_inputs()
    got = block(xyz, feat, fast_gather=False)
    assert torch.equal(got, _block_reference(w, xyz, feat, 0.2, 8))


@pytest.mark.parametrize("mutation", ["residual", "relu_before_add",
                                      "undivided"])
def test_inv_res_mlp_input_tells_each_fault(mutation):
    """On the block test's input each fault changes the output, so that a
    port with it fails ``test_inv_res_mlp_equals_the_reference_block``."""
    block = _block()
    w = {k: v.detach().clone() for k, v in block.state_dict().items()}
    xyz, feat = _block_inputs()
    right = _block_reference(w, xyz, feat, 0.2, 8)
    wrong = _block_reference(w, xyz, feat, 0.2, 8, mutation)
    assert (right - wrong).abs().max() > 1e-2


def test_offsets_are_divided_not_multiplied():
    """The group's offsets are divided by the radius as f32 (the reference's
    form), which differs from a multiply by its reciprocal somewhere on
    this input."""
    from tumseg_torch.nn.layers import LocalAggregation

    la = LocalAggregation(4, 8, 0.1, 8)
    dp = torch.rand(1, 1, 4096, 7,
                    generator=torch.Generator().manual_seed(3)) * 0.2 - 0.1
    seen = {}
    la.conv.register_forward_pre_hook(
        lambda conv, args: seen.update(g=args[0].clone()))
    la.reduce(dp.clone(), None, None)
    want = dp[..., :3] / torch.tensor(0.1)
    assert torch.equal(seen["g"][..., :3], want)
    assert not torch.equal(want, dp[..., :3] * (1.0 / 0.1))
    assert torch.equal(seen["g"][..., 3:], dp[..., 3:])


def test_checkpoint_layout_round_trip():
    from tumseg_torch.models.convert import (state_dict_from_variables,
                                             variables_from_state_dict)

    model = models.get_module(NAME).get_model(18, 3)
    sd = model.state_dict()
    var = variables_from_state_dict(sd)
    assert set(var["params"]["res1"]["0"]["aggr"]["conv"]) == {"w"}
    assert set(var["params"]["stem"]) == {"w", "b"}
    back = state_dict_from_variables(var)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k
    assert sd["res2.5.aggr.conv.weight"].shape == (256, 259, 1, 1)
    assert sd["sa4.conv.weight"].shape == (1024, 515, 1, 1)
    assert sd["res4.2.pw1.weight"].shape == (4096, 1024, 1)
    assert "res4.2.pw1.bias" not in sd and "conv2.bias" in sd


def test_spans_of_an_eager_forward(tiny):
    """Under a profiler an eager forward records one
    ``tumseg.model.aggregate`` a set abstraction and local aggregation
    (19) and one ``tumseg.model.block`` an InvResMLP (15); without one,
    nothing."""
    from tumseg_torch.utils import profiling

    _, model = _pair(tiny)
    x = torch.rand(1, 128, 9)
    profiling.reset_spans()
    with torch.no_grad():
        model.eval()(x)
    assert profiling.span_totals() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            model(x)
    totals = profiling.span_totals()
    profiling.reset_spans()
    assert totals["tumseg.model.aggregate"]["count"] == 19
    assert totals["tumseg.model.block"]["count"] == 15


def _tiles(data, n_train=12000, n_test=6000):
    from tumseg_torch.data.las import write_las

    r = np.random.default_rng(0)
    for name, n in [("building.las", n_train), ("test_tile.las", n_test)]:
        xyz = np.stack([r.uniform(0, 4, n), r.uniform(0, 2, n),
                        r.uniform(0, 5, n)], 1)
        write_las(str(data / name), xyz, r.choice([1, 2, 3, 7], n))


def test_cli_trains_on_the_device_pipeline_and_serves(tmp_path,
                                                      monkeypatch):
    """One epoch of ``--model pointnext_sem_seg --data_pipeline device`` on
    the CPU writes a checkpoint that the test CLI serves on its vote
    path."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli

    data = tmp_path / "data"
    data.mkdir()
    _tiles(data)
    monkeypatch.chdir(tmp_path)
    common = ["--rootdir", str(data), "--test_area", "test_tile.las",
              "--class8", "--RGB_OFF", "--seed", "0", "--gpu", "cpu",
              "--model", NAME]
    acc, loss, iou = train_cli.main(train_cli.parse_args(common + [
        "--exp_dir", str(tmp_path / "log"), "--log_dir", "run1", "--npoint",
        "256", "--batch_size", "4", "--epoch", "1", "--data_pipeline",
        "device", "--superstep", "2"]))
    assert len(acc) == 1 and math.isfinite(loss[0]) and 0 <= acc[0] <= 1
    run = tmp_path / "log" / "sem_seg" / "run1"
    assert (run / "checkpoints" / "best_model.pth").exists()
    out = test_cli.main(test_cli.parse_args(common + [
        "--exp_dir", str(tmp_path / "log" / "sem_seg") + "/", "--log_dir",
        "run1", "--num_point", "256", "--batch_size", "4", "--num_votes",
        "1"]))
    assert 0.0 <= out["miou"] <= 1.0


def test_vote_path_pool_equals_the_reference(monkeypatch):
    """``InferenceRunner`` on the CPU's device re-blocking path, through the
    benchmark's tiny serving loop (calibrated weights, two votes of the
    last tile): its pool of votes and its labels equal the plain
    reference's vote by vote."""
    from gpubench.tests import tiny

    monkeypatch.setitem(tiny.FIXTURE_CELLS, "pointnext_xl.serve.facade",
                        ("pointnext_xl", "ssg.serve.facade"))
    line = tiny.execute(monkeypatch, "pointnext_xl.serve.facade")
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert line["attempted"] >= 1
    assert checks == {"votes_gap": 0.0, "pool_rows_off": 0.0,
                      "labels_off": 0.0}
