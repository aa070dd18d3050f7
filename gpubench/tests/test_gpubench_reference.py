"""The frozen copies in ``gpubench`` pinned to the port as it stands, on the
CPU at tiny sizes: the reference's point ops against the plain versions of
``tumseg_torch.ops.core`` (forward and backward), the reference model
against the port's models, the reference's re-blocking and features
against the runner's, its block sampling against ``DeviceBlockSampler``,
and the FLOP and launch counts against ``tools/roofline.py``, for every
configuration of the benchmark and the test configurations
(``tests/configs/``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench import counting, spec, tiles
from gpubench.loops import serve_tiles
from gpubench.reference import ops as R
from gpubench.reference import serve as RS, train as RT
from gpubench.tests import tiny
from tumseg_torch.ops import core

CONFIGS = [c["name"] for c in spec.load_benchmark()["configs"]] + [
    "pointnet"]


@pytest.fixture
def cloud():
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand(2, 256, 3, generator=g)
    xyz[:, 100:110] = xyz[:, 90:100]            # duplicated points: ties
    return xyz, torch.randn(2, 256, 7, generator=g)


def test_fps_ball_query_three_nn(cloud):
    xyz, _ = cloud
    start = torch.tensor([3, 17], dtype=torch.int32)
    assert torch.equal(R.farthest_point_sample(xyz, 64, start),
                       core.farthest_point_sample(xyz, 64, start).long())
    new = R.gather(xyz, R.farthest_point_sample(xyz, 64))
    ours = R.ball_query([0.1, 0.2], [16, 32], xyz, new)
    theirs = core.query_ball_point_multi([0.1, 0.2], [16, 32], xyz, new)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b.long())
    d1, i1 = R.three_nn(xyz, new)
    d2, i2 = core.three_nn(xyz, new)
    assert torch.equal(d1, d2) and torch.equal(i1, i2.long())


@pytest.mark.parametrize("fast", [False, True])
def test_group_and_interpolate_with_gradients(cloud, fast):
    xyz, pts = cloud
    new = R.gather(xyz, R.farthest_point_sample(xyz, 64))
    idx = R.ball_query([0.2], [32], xyz, new)[0]
    src = torch.cat([xyz, pts], -1).requires_grad_(True)
    out = R.Group.apply(idx, src, new, fast)
    ref = core.group_points(idx.int(), src.detach(), new, fast)
    assert torch.equal(out, ref)
    g = torch.randn(out.shape).to(out.dtype)
    out.backward(g)
    assert torch.equal(src.grad, core.group_points_backward(
        idx.int(), g, src.shape[1], fast))
    feat = torch.randn(2, 64, 5, requires_grad=True)
    out = R.interpolate(xyz, new, feat, fast)
    d, i = core.three_nn(xyz, new)
    assert torch.equal(out, core.interpolate_weighted(d, i, feat.detach(),
                                                      fast))
    g = torch.randn(out.shape)
    out.backward(g)
    assert torch.allclose(feat.grad, core.interpolate_backward(
        i, core.interpolation_weights(d), g, 64, fast), rtol=0, atol=1e-6)


def test_rotation():
    from tumseg_torch.data.augment import rotate_z

    x = torch.rand(3, 50, 3)
    a = torch.rand(3) * 6.283
    assert torch.equal(R.rotate_z(x, a), rotate_z(x, a))


@pytest.mark.parametrize("name", CONFIGS)
def test_model_forward_and_gradients(monkeypatch, name):
    from tumseg_torch import models

    cfg, program = tiny.config(name)
    tiny.program_sizes(monkeypatch, cfg, program)
    arch = spec.architecture(cfg)
    w = arch.make_weights(cfg, 3, torch.device("cpu"))
    prog = models.get_module(cfg["model"]).get_model(18, 3)
    prog.load_state_dict({k: v.clone() for k, v in w.items()})
    x = torch.rand(2, 128, 9)
    with torch.no_grad():
        assert torch.equal(prog.eval()(x)[0],
                           arch.Net(cfg, w, "eval").forward(x)[0])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    prog.train()
    lp, aux = prog(x, generator=g1, fast_gather=True)
    params = {k: v.clone().requires_grad_(k in dict(prog.named_parameters()))
              for k, v in w.items()}
    ref, ref_aux = arch.Net(cfg, params, "train", fast=True,
                            generator=g2).forward(x)
    assert torch.equal(lp, ref)
    lp.sum().backward(retain_graph=True)
    ref.sum().backward(retain_graph=True)
    for n, p in prog.named_parameters():
        assert torch.allclose(p.grad, params[n].grad, rtol=1e-5,
                              atol=1e-6), n
        p.grad, params[n].grad = None, None
    # the loss that training runs, its gradients held to the same 1e-6 of
    # the largest gradient as the log-probs' (each about 1 there)
    target = torch.randint(0, 18, (2, 128))
    cw = torch.rand(18) + 0.5
    loss = prog.loss(lp, target, aux, cw)
    ref_loss = arch.loss(cfg, ref, target, ref_aux, cw)
    assert torch.equal(loss, ref_loss)
    loss.backward()
    ref_loss.backward()
    scale = max(params[n].grad.abs().max() for n, _ in prog.named_parameters())
    for n, p in prog.named_parameters():
        assert torch.allclose(p.grad, params[n].grad, rtol=1e-5,
                              atol=1e-6 * scale), n


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_load_strict_into_the_port(name):
    from tumseg_torch import models

    cfg = tiny.full_config(name)
    w = spec.architecture(cfg).make_weights(cfg, 1, torch.device("cpu"))
    models.get_module(cfg["model"]).get_model(18, 3).load_state_dict(w)


def test_reblocking_and_features(monkeypatch):
    from tumseg_torch import models
    from tumseg_torch.infer.voting import InferenceRunner, featurize

    cfg = tiny.config("pointnet2_ssg")[0]
    mix = tiny.mix("facade_tiles")
    tile = tiles.make_tiles(mix, 5, [3000], 18, "cpu")[0]
    ds = serve_tiles._dataset(cfg)
    serve_tiles._put(ds, 1, tile)
    runner = InferenceRunner(models.get_module(cfg["model"]).get_model(18, 3),
                             18, batch_size=2, device="cpu",
                             device_features=True, device_reblock=True,
                             seed=99)
    grid = runner._grid_tensors(ds, 1)
    P = cfg["serve"]["block_points"]
    xyz = torch.as_tensor(tile["xyz"])
    lay = RS.layout(RS.grid_columns(xyz, 1.0, 0.5, 0.001), P, xyz.device)
    for vote in range(2):
        ours = RS.reblock(lay, 99, 1, vote, P)
        assert torch.equal(ours, runner._reblock(grid, 1, vote, P).long())
    assert torch.equal(lay[4], grid[4])
    scene = runner._scene_tensors(ds, 1)
    theirs = featurize(*scene, ours[:4].int(), grid[4][:4], 1.0)
    extra = torch.as_tensor(np.stack(tile["extra"], 1))
    assert torch.equal(RS.features(xyz, extra, torch.ones(3, dtype=bool),
                                   ours[:4], lay[4][:4], 1.0), theirs)


def test_block_sampling():
    from tumseg_torch.data.device_sampler import DeviceBlockSampler

    mix = tiny.mix("facade_rooms")
    rooms = tiles.make_tiles(mix, 7, [3000, 4000], 18, "cpu")
    P = 128
    prog = DeviceBlockSampler([r["xyz"] for r in rooms],
                              [r["labels"] for r in rooms],
                              [r["extra"] for r in rooms], [True] * 3,
                              num_point=P, min_block_points=16, device="cpu")
    ref = RT.Rooms([dict(r, color=[True] * 3) for r in rooms], P, 1.0, 16,
                   torch.device("cpu"))
    assert ref.cap == prog.cap
    ids = np.array([[0, 1, 1], [1, 0, 0]])

    def gens():
        return [torch.Generator().manual_seed(RT.stream_seed(11, i))
                for i in range(2)]
    pts, lab = prog.sample_batches(ids, gens())
    g = gens()
    rid = torch.as_tensor(ids.reshape(-1))
    center, cnt = ref.accept(rid, g)
    ours, our_lab = ref.select(rid, center, cnt, g)
    assert torch.equal(ours, pts) and torch.equal(our_lab, lab)


# the configurations that the port's roofline tool knows, and their
# point-kernel launches of a B=32 forward and of a B=16 training step
LAUNCHES = {"pointnet2_ssg": (20, 27), "pointnet2_msg": (24, 34),
            "pointnet": (0, 0)}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_counts_against_the_roofline_tool(name):
    from tumseg_torch import models
    from tumseg_torch.tools import roofline

    cfg = tiny.full_config(name)
    arch = spec.architecture(cfg)
    model = models.get_module(cfg["model"]).get_model(18, 3)
    layers, bmm = roofline.gemm_layers(model, 32, 4096)
    assert [(r, i, o) for _, r, i, o in layers] == [
        (r, i, o) for _, r, i, o in arch.gemms(cfg, 32, 4096)]
    assert arch.forward_flops(cfg, 32, 4096) == sum(
        2 * r * i * o for _, r, i, o in layers) + bmm
    per = arch.launches(cfg, 32, 4096, train=False)
    if per:
        assert per[0]["nbytes"] == roofline.fps_cost(32, 4096,
                                                     1024)["nbytes"]
        assert per[0]["ops"] == roofline.fps_cost(32, 4096, 1024)["ops"]
    assert (len(per), len(arch.launches(cfg, 16, 4096, train=True))) == \
        LAUNCHES[name]
    assert counting.HBM_BYTES_PER_S == roofline.HBM_BYTES_PER_S
    assert counting.F32_FLOPS_PER_S == roofline.F32_OPS_PER_S
