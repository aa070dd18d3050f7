"""Point-cloud op dispatch: a CUDA tensor runs the hand-written kernel
(``tumseg_torch.ops.kernels``), a CPU tensor the plain PyTorch version
(``tumseg_torch.ops.core``). There is no fallback between them: a kernel
that fails to build or launch raises.

``plain()`` forces the plain versions on CUDA tensors too, so that
``chip_smoke.py`` and the tests can hold each kernel against its plain
version on the card. Grouping and interpolation are differentiable through
``tumseg_torch.ops.autograd``, which keeps the choice made here at forward
time for the backward pass.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import torch

from tumseg_torch.ops import core, kernels
from tumseg_torch.ops.autograd import GroupPoints, ThreeNNInterpolate

_state = threading.local()


@contextlib.contextmanager
def plain():
    """Run the plain PyTorch versions on CUDA tensors inside this block
    (this thread only)."""
    prev = getattr(_state, "plain", False)
    _state.plain = True
    try:
        yield
    finally:
        _state.plain = prev


def _impl(t: torch.Tensor):
    if t.device.type == "cuda":
        return core if getattr(_state, "plain", False) else kernels
    if t.device.type == "cpu":
        return core
    raise ValueError(f"tumseg_torch ops run on cpu or cuda, not {t.device}")


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: Optional[torch.Tensor] = None):
    return _impl(xyz).farthest_point_sample(xyz, npoint, start=start)


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor):
    return _impl(xyz).query_ball_point(radius, nsample, xyz, new_xyz)


def query_ball_point_multi(radii: Sequence[float], nsamples: Sequence[int],
                           xyz: torch.Tensor, new_xyz: torch.Tensor
                           ) -> Tuple[torch.Tensor, ...]:
    """One [B, S, nsamples[i]] int32 ball query per radius, each equal to
    :func:`query_ball_point` of its radius; on the card all radii share one
    launch of the multi-radius kernel."""
    return _impl(xyz).query_ball_point_multi(radii, nsamples, xyz, new_xyz)


def group_points(idx: torch.Tensor, src: torch.Tensor,
                 new_xyz: torch.Tensor):
    return GroupPoints.apply(idx, src, new_xyz, _impl(src))


def gather_rows(xyz: torch.Tensor, idx: torch.Tensor):
    """[B, S, 3] rows of xyz [B, N, 3] at idx [B, S]: the group op with K=1
    and zero centers (``tumseg/ops/__init__.py:195-211``)."""
    zeros = xyz.new_zeros(idx.shape[0], idx.shape[1], 3)
    return group_points(idx[:, :, None].contiguous(), xyz, zeros)[:, :, 0, :]


def three_nn_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         points2: torch.Tensor):
    return ThreeNNInterpolate.apply(xyz1, xyz2, points2, _impl(xyz1))


def three_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                      points2: torch.Tensor):
    return three_nn_interpolate(xyz1, xyz2, points2)[2]


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: Optional[torch.Tensor],
                     fps_start: Optional[torch.Tensor] = None):
    """FPS (from ``fps_start`` [B], default 0) -> centroid gather -> ball
    query -> group + center:
    -> (new_xyz [B, npoint, 3], grouped [B, npoint, nsample, 3 (+D)])."""
    new_xyz = gather_rows(xyz, farthest_point_sample(xyz, npoint,
                                                     start=fps_start))
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    src = torch.cat([xyz, points], dim=-1) if points is not None else xyz
    return new_xyz, group_points(idx, src, new_xyz)


def msg_ball_groups(radius_list: Sequence[float],
                    nsample_list: Sequence[int], xyz: torch.Tensor,
                    new_xyz: torch.Tensor, src: torch.Tensor):
    """Multi-scale ball query + group (``tumseg/ops/__init__.py:243-272``):
    -> one [B, S, nsample_list[i], C] tensor per radius, channels 0-2 of
    ``src`` [B, N, C] centred on ``new_xyz``."""
    idxs = query_ball_point_multi(radius_list, nsample_list, xyz, new_xyz)
    return [group_points(idx, src, new_xyz) for idx in idxs]
