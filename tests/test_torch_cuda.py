"""The CUDA kernels against their plain PyTorch versions on the card, at
small and ragged shapes (chip_smoke.py covers the model's full shapes).
They need an NVIDIA GPU and skip without one; this file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Indices and grouping must be identical; the interpolation agrees within
rtol 1e-5 / atol 1e-6. The backward kernels add with f32 atomics in an order
that changes from run to run, so they agree within rtol 1e-5 / atol 1e-4."""

import numpy as np
import pytest
import torch

from tumseg_torch import ops
from tumseg_torch.ops import core, kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(rng, shape, device):
    return torch.as_tensor(rng.random(shape).astype(np.float32),
                           device=device)


@pytest.mark.parametrize("B,N,npoint", [(2, 500, 130), (3, 100, 130),
                                        (1, 4100, 37), (2, 31, 8)])
def test_fps(cuda, B, N, npoint):
    rng = np.random.default_rng(0)
    xyz = _rand(rng, (B, N, 3), cuda)
    start = torch.as_tensor(rng.integers(0, N, B).astype(np.int32),
                            device=cuda)
    assert torch.equal(kernels.farthest_point_sample(xyz, npoint),
                       core.farthest_point_sample(xyz, npoint))
    assert torch.equal(kernels.farthest_point_sample(xyz, npoint, start),
                       core.farthest_point_sample(xyz, npoint, start))


@pytest.mark.parametrize("B,N,S,K,r", [(2, 500, 130, 32, 0.15),
                                       (1, 77, 5, 40, 0.5),
                                       (2, 1000, 64, 8, 0.05)])
def test_ball_query_and_group(cuda, B, N, S, K, r):
    rng = np.random.default_rng(1)
    xyz = _rand(rng, (B, N, 3), cuda)
    new_xyz = _rand(rng, (B, S, 3), cuda)
    new_xyz[:, 0] = 50.0  # an empty ball
    idx = kernels.query_ball_point(r, K, xyz, new_xyz)
    assert torch.equal(idx, core.query_ball_point(r, K, xyz, new_xyz))
    assert (idx[:, 0] == N).all()
    src = torch.cat([xyz, _rand(rng, (B, N, 5), cuda)], dim=-1)
    assert torch.equal(kernels.group_points(idx, src, new_xyz),
                       core.group_points(idx, src, new_xyz))


@pytest.mark.parametrize("B,N,S,radii,Ks", [
    (2, 500, 130, (0.1, 0.2), (16, 32)),
    (1, 77, 5, (0.5, 0.05, 0.3, 0.2), (40, 3, 8, 1)),  # unsorted, K > N
    (2, 1000, 64, (0.2, 0.05), (8, 16))])
def test_ball_query_multi(cuda, B, N, S, radii, Ks):
    """One launch for all radii; each output equals the plain multi-radius
    query and the single-radius kernel of its radius."""
    rng = np.random.default_rng(6)
    xyz = _rand(rng, (B, N, 3), cuda)
    new_xyz = _rand(rng, (B, S, 3), cuda)
    new_xyz[:, 0] = 50.0  # an empty ball
    kernels.reset_launches()
    got = kernels.query_ball_point_multi(radii, Ks, xyz, new_xyz)
    assert kernels.launches["ball_query_multi"] == 1
    want = core.query_ball_point_multi(radii, Ks, xyz, new_xyz)
    for r, k, g, w in zip(radii, Ks, got, want):
        assert g.shape == (B, S, k) and g.dtype == torch.int32
        assert torch.equal(g, w)
        assert torch.equal(g, kernels.query_ball_point(r, k, xyz, new_xyz))
        assert (g[:, 0] == N).all()


def test_ball_query_multi_refuses_bad_inputs(cuda):
    xyz = torch.rand(1, 64, 3, device=cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="1 to 4 radii"):
        kernels.query_ball_point_multi((0.1,) * 5, (4,) * 5, xyz, xyz)
    with pytest.raises(ValueError, match="1 to 4 radii"):
        kernels.query_ball_point_multi((), (), xyz, xyz)
    with pytest.raises(ValueError, match="nsample"):
        kernels.query_ball_point_multi((0.1, 0.2), (4, 0), xyz, xyz)
    with pytest.raises(ValueError, match="nsamples"):
        kernels.query_ball_point_multi((0.1, 0.2), (4,), xyz, xyz)
    with pytest.raises(TypeError):
        kernels.query_ball_point_multi((0.1,), (4,), xyz.double(), xyz)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.query_ball_point_multi((0.1,), (4,), xyz, xyz[:, ::2])
    with pytest.raises(ValueError, match="shape"):
        kernels.query_ball_point_multi((0.1,), (4,), xyz, xyz[None])
    assert sum(kernels.launches.values()) == 0
    # through ops: one launch for any number of radii, none under plain()
    ops.query_ball_point_multi((0.1, 0.2), (4, 8), xyz, xyz)
    ops.query_ball_point_multi((0.1,), (4,), xyz, xyz)
    with ops.plain():
        ops.query_ball_point_multi((0.1, 0.2), (4, 8), xyz, xyz)
    assert kernels.launches["ball_query_multi"] == 2
    assert kernels.launches["ball_query"] == 0


def test_msg_forward_kernels_match_plain(cuda):
    """The MSG forward with the kernels against ops.plain() on the card,
    and the launches of one forward."""
    from tumseg_torch.models.pointnet2_sem_seg_msg import get_model
    from tumseg_torch.nn.layers import calibrate_batch_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(7)
    x = _rand(rng, (2, 2048, 6), cuda)
    torch.manual_seed(0)
    model = get_model(8).to(cuda).eval()
    calibrate_batch_norm(model, x)
    kernels.reset_launches()
    with torch.inference_mode():
        got = model(x)[0]
        counts = dict(kernels.launches)
        with ops.plain():
            want = model(x)[0]
    assert counts == {"fps": 4, "ball_query": 0, "ball_query_multi": 4,
                      "group": 12, "three_nn_interpolate": 4,
                      "group_backward": 0, "interpolate_backward": 0}
    assert sum(kernels.launches.values()) == sum(counts.values())
    assert (got - want).abs().max().item() <= 1e-4
    assert (got.argmax(-1) == want.argmax(-1)).float().mean().item() >= 0.999


@pytest.mark.parametrize("B,N,S,D", [(2, 500, 130, 40), (1, 70, 3, 7),
                                     (2, 300, 300, 1)])
def test_three_nn_interpolate(cuda, B, N, S, D):
    rng = np.random.default_rng(2)
    xyz1 = _rand(rng, (B, N, 3), cuda)
    xyz2 = _rand(rng, (B, S, 3), cuda)
    xyz2[:, 2] = xyz2[:, 1]  # a distance tie
    p2 = torch.as_tensor(rng.standard_normal((B, S, D)).astype(np.float32),
                         device=cuda)
    dk, ik, ok = kernels.three_nn_interpolate(xyz1, xyz2, p2)
    dp, ip, op = core.three_nn_interpolate(xyz1, xyz2, p2)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,N,S,K,C", [(2, 77, 19, 32, 35), (1, 1000, 64, 8, 1),
                                       (3, 31, 5, 40, 67)])
def test_group_backward(cuda, B, N, S, K, C):
    """Ragged N, an all-sentinel ball, a short ball padded with repeats and
    one source row that every group holds."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, N + 1, (B, S, K)).astype(np.int32)
    idx[:, 0] = N
    idx[:, 1, 2:] = idx[:, 1, 1:2]
    idx[:, 1:, 0] = N // 2
    idx = torch.as_tensor(idx, device=cuda)
    g = torch.as_tensor(rng.standard_normal((B, S, K, C)).astype(np.float32),
                        device=cuda)
    kernels.reset_launches()
    got = kernels.group_points_backward(idx, g, N)
    torch.testing.assert_close(got, core.group_points_backward(idx, g, N),
                               rtol=1e-5, atol=1e-4)
    assert kernels.launches["group_backward"] == 1


@pytest.mark.parametrize("B,N,S,D", [(2, 500, 130, 40), (1, 70, 3, 7),
                                     (2, 4099, 1024, 128)])
def test_interpolate_backward(cuda, B, N, S, D):
    """Ragged N, S = 3, and one source among the three of every query."""
    rng = np.random.default_rng(4)
    idx = rng.integers(0, S, (B, N, 3)).astype(np.int32)
    idx[:, :, 0] = S - 1
    w = rng.random((B, N, 3)).astype(np.float32) + 0.01
    w /= w.sum(-1, keepdims=True)
    idx, w = (torch.as_tensor(a, device=cuda) for a in (idx, w))
    g = torch.as_tensor(rng.standard_normal((B, N, D)).astype(np.float32),
                        device=cuda)
    got = kernels.interpolate_backward(idx, w, g, S)
    torch.testing.assert_close(got, core.interpolate_backward(idx, w, g, S),
                               rtol=1e-5, atol=1e-4)


def _grads(cuda, backward_plain):
    """Forward through tumseg_torch.ops on the card, then backward, inside
    ops.plain() or not: -> (d src, d points2)."""
    rng = np.random.default_rng(5)
    xyz = _rand(rng, (2, 300, 3), cuda)
    new_xyz = xyz[:, :50].contiguous()
    src = _rand(rng, (2, 300, 9), cuda).requires_grad_()
    idx = kernels.query_ball_point(0.2, 16, xyz, new_xyz)
    p2 = _rand(rng, (2, 50, 24), cuda).requires_grad_()
    grouped = ops.group_points(idx, src, new_xyz)
    out = ops.three_nn_interpolate(xyz, new_xyz, p2)[2]
    loss = (grouped * grouped).sum() + (out * out).sum()
    if backward_plain:
        with ops.plain():
            loss.backward()
    else:
        loss.backward()
    return src.grad, p2.grad


def test_autograd_functions_on_card(cuda):
    """The autograd Functions run the backward kernels on CUDA tensors and
    agree with the plain path; a backward run inside ops.plain() still
    launches the kernels its forward chose (ctx keeps the choice)."""
    kernels.reset_launches()
    d_src, d_p2 = _grads(cuda, backward_plain=False)
    assert kernels.launches["group_backward"] == 1
    assert kernels.launches["interpolate_backward"] == 1
    d_src2, d_p22 = _grads(cuda, backward_plain=True)
    assert kernels.launches["group_backward"] == 2
    assert kernels.launches["interpolate_backward"] == 2
    with ops.plain():
        p_src, p_p2 = _grads(cuda, backward_plain=False)
    assert kernels.launches["group_backward"] == 2
    for got in (d_src, d_src2):
        torch.testing.assert_close(got, p_src, rtol=1e-5, atol=1e-4)
    for got in (d_p2, d_p22):
        torch.testing.assert_close(got, p_p2, rtol=1e-5, atol=1e-4)


def test_wrappers_refuse_bad_inputs_and_count(cuda):
    xyz = torch.rand(1, 64, 3, device=cuda)
    kernels.reset_launches()
    with pytest.raises(TypeError):
        kernels.farthest_point_sample(xyz.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.query_ball_point(0.1, 4, xyz, xyz[:, ::2])
    with pytest.raises(RuntimeError, match="forward-only"):
        kernels.farthest_point_sample(xyz.clone().requires_grad_(), 8)
    with pytest.raises(RuntimeError, match="forward-only"):
        kernels.group_points_backward(
            torch.zeros(1, 4, 2, dtype=torch.int32, device=cuda),
            torch.zeros(1, 4, 2, 3, device=cuda, requires_grad=True), 64)
    with pytest.raises(ValueError, match="shape"):
        kernels.interpolate_backward(
            torch.zeros(1, 64, 3, dtype=torch.int32, device=cuda),
            torch.zeros(1, 64, 2, device=cuda), xyz, 8)
    assert sum(kernels.launches.values()) == 0
    ops.farthest_point_sample(xyz, 8)
    with ops.plain():
        ops.farthest_point_sample(xyz, 8)
    assert kernels.launches["fps"] == 1
