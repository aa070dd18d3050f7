"""The CUDA kernels against their plain PyTorch versions on the card, at
small and ragged shapes (chip_smoke.py covers the model's full shapes).
They need an NVIDIA GPU and skip without one; this file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Indices and grouping must be identical; the interpolation agrees within
rtol 1e-5 / atol 1e-6."""

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


def test_wrappers_refuse_bad_inputs_and_count(cuda):
    xyz = torch.rand(1, 64, 3, device=cuda)
    kernels.reset_launches()
    with pytest.raises(TypeError):
        kernels.farthest_point_sample(xyz.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.query_ball_point(0.1, 4, xyz, xyz[:, ::2])
    with pytest.raises(RuntimeError, match="forward-only"):
        kernels.farthest_point_sample(xyz.clone().requires_grad_(), 8)
    assert sum(kernels.launches.values()) == 0
    ops.farthest_point_sample(xyz, 8)
    with ops.plain():
        ops.farthest_point_sample(xyz, 8)
    assert kernels.launches["fps"] == 1
