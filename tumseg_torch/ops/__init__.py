"""Point-cloud op dispatch: a CUDA tensor runs the hand-written kernel
(``tumseg_torch.ops.kernels``), a CPU tensor the plain PyTorch version
(``tumseg_torch.ops.core``). There is no fallback between them: a kernel
that fails to build or launch raises.

``plain()`` forces the plain versions on CUDA tensors too, so that
``chip_smoke.py`` and the tests can hold each kernel against its plain
version on the card. Grouping and interpolation are differentiable through
``tumseg_torch.ops.autograd``, which keeps the choice made here at forward
time for the backward pass.

``window_enabled()`` (this thread) and ``set_window()`` (the process
default) switch :func:`three_nn_interpolate` to the z-window 3-NN where
``tumseg``'s ``three_nn_dispatch`` takes it (``tumseg/ops/__init__.py:
304-314``): N >= 4096 queries, S >= 1024 sources, S a multiple of 128. The
window is exact (a guarded fallback to the full expansion form), so it
never changes what the op computes, only how. Unlike ``tumseg``, no
environment variable turns it on.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import torch

from tumseg_torch.ops import core, kernels
from tumseg_torch.ops.autograd import GroupPoints, ThreeNNInterpolate

_state = threading.local()
_window_default = False
# tumseg/ops/__init__.py:128 and :188-189, :304-310
WINDOW_MIN_N = 4096
WINDOW_N_TILE = 256


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


def set_window(enabled: bool) -> None:
    """Process default of the z-window 3-NN (off unless set)."""
    global _window_default
    _window_default = bool(enabled)


@contextlib.contextmanager
def window_enabled(enabled: bool = True):
    """Take (or, with False, leave) the z-window 3-NN inside this block
    (this thread only), whatever the process default."""
    prev = getattr(_state, "window", None)
    _state.window = bool(enabled)
    try:
        yield
    finally:
        _state.window = prev


def _window_on() -> bool:
    window = getattr(_state, "window", None)
    return _window_default if window is None else window


def three_nn_window(s: int) -> int:
    """Window width for ``s`` sources: 384 at S=1024
    (``tumseg/ops/__init__.py:188-189``)."""
    return min(s, max(384, (s * 3 // 8 + 127) // 128 * 128))


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
    """-> (dists, idx, out): the direct-form 3-NN and the interpolation, or,
    with the window on at N >= 4096, S >= 1024, S % 128 == 0, the z-window
    3-NN in the expansion form (window ``three_nn_window(S)``, tiles of 256
    queries) and the interpolation."""
    N, S = xyz1.shape[1], xyz2.shape[1]
    window = None
    if _window_on() and N >= WINDOW_MIN_N and S >= 1024 and S % 128 == 0:
        window = three_nn_window(S)
    return ThreeNNInterpolate.apply(xyz1, xyz2, points2, _impl(xyz1), window,
                                    WINDOW_N_TILE)


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
