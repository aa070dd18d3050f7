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

``fused_group_enabled()`` and ``set_fused_group()`` do the same for the fused
ball query + group of :func:`ball_group` (``tumseg/ops/__init__.py:230-240,
275-289``, ``TUMSEG_OPS_FUSED_GROUP`` there): off by default, and taken only
where ``tumseg`` takes it, N <= 1024 or N % 1024 == 0. It computes what the
split pair computes, bit for bit.

``fast`` (``fast_gather`` in the composite ops) selects the single-pass bf16
gathers of ``tumseg``'s training step: the neighbourhood group stores bf16,
the interpolation rounds its operands to bf16. The centroid gather
(:func:`gather_rows`) is always exact, as in ``tumseg``.

:func:`batch_norm` routes by its input as the point ops do, with one more
case: a mesh keeps the plain formula on the card too (its ``pmean`` sits
between the statistics and the normalisation). A BatchNorm on a CUDA
tensor that takes the plain formula counts in ``kernels.plain_calls``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import torch

from tumseg_torch.ops import core, kernels
from tumseg_torch.ops.autograd import (BatchNormReLU, FusedBallGroup,
                                       GroupPoints, ThreeNNInterpolate)
# no kernel: plain PyTorch on every device, as no Pallas kernel answers them
from tumseg_torch.ops.core import (  # noqa: F401
    pc_normalize, sample_and_group_all, square_distance)

_state = threading.local()
_window_default = False
_fused_default = False
# tumseg/ops/__init__.py:128 and :188-189, :304-310
WINDOW_MIN_N = 4096
WINDOW_N_TILE = 256
# the fused op's candidate chunk in tumseg (fusedgroup.py:_CHUNK): other N
# take the split path there (tumseg/ops/__init__.py:278-279)
FUSED_CHUNK = 1024


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


def set_fused_group(enabled: bool) -> None:
    """Process default of the fused ball query + group (off unless set)."""
    global _fused_default
    _fused_default = bool(enabled)


@contextlib.contextmanager
def fused_group_enabled(enabled: bool = True):
    """Take (or, with False, leave) the fused ball query + group inside this
    block (this thread only), whatever the process default."""
    prev = getattr(_state, "fused", None)
    _state.fused = bool(enabled)
    try:
        yield
    finally:
        _state.fused = prev


def _fused_on() -> bool:
    fused = getattr(_state, "fused", None)
    return _fused_default if fused is None else fused


def switches() -> Tuple[bool, bool, bool]:
    """(plain, window, fused) as this thread sees them: the choices that a
    step captured as a CUDA graph freezes, so part of the graph's key."""
    return getattr(_state, "plain", False), _window_on(), _fused_on()


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
                 new_xyz: torch.Tensor, fast: bool = False):
    return GroupPoints.apply(idx, src, new_xyz, _impl(src), fast)


def group_neighborhoods(idx: torch.Tensor, src: torch.Tensor,
                        new_xyz: torch.Tensor, fast_gather: bool = False):
    """Gather src rows ([B, N, 3 + D], xyz first) by idx [B, S, K] and centre
    the first 3 channels on new_xyz -> [B, S, K, 3 + D]
    (``tumseg/ops/__init__.py:214-228``): :func:`group_points`, bf16 with
    ``fast_gather``."""
    return group_points(idx, src, new_xyz, fast=fast_gather)


def fused_ball_group(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, src: torch.Tensor,
                     fast: bool = False):
    """-> (grouped [B, S, nsample, C], idx [B, S, nsample] int32): the ball
    query and the group in one op, on the card one launch."""
    return FusedBallGroup.apply(xyz, new_xyz, src, _impl(xyz), radius,
                                nsample, fast)


def gather_rows(xyz: torch.Tensor, idx: torch.Tensor):
    """[B, S, 3] rows of xyz [B, N, 3] at idx [B, S]: the group op with K=1
    and zero centers (``tumseg/ops/__init__.py:195-211``)."""
    zeros = xyz.new_zeros(idx.shape[0], idx.shape[1], 3)
    return group_points(idx[:, :, None].contiguous(), xyz, zeros)[:, :, 0, :]


def three_nn_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         points2: torch.Tensor, fast: bool = False):
    """-> (dists, idx, out): the direct-form 3-NN and the interpolation, or,
    with the window on at N >= 4096, S >= 1024, S % 128 == 0, the z-window
    3-NN in the expansion form (window ``three_nn_window(S)``, tiles of 256
    queries) and the interpolation."""
    N, S = xyz1.shape[1], xyz2.shape[1]
    window = None
    if _window_on() and N >= WINDOW_MIN_N and S >= 1024 and S % 128 == 0:
        window = three_nn_window(S)
    return ThreeNNInterpolate.apply(xyz1, xyz2, points2, _impl(xyz1), window,
                                    WINDOW_N_TILE, fast)


def three_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                      points2: torch.Tensor, fast_gather: bool = False):
    return three_nn_interpolate(xyz1, xyz2, points2, fast_gather)[2]


def ball_group(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor, src: torch.Tensor,
               fast_gather: bool = False) -> torch.Tensor:
    """Ball query + group + centring (``tumseg/ops/__init__.py:275-289``):
    -> [B, S, nsample, C]. With the fused switch on and N <= 1024 or
    N % 1024 == 0 it is one fused op, else the ball query then the group."""
    N = xyz.shape[1]
    if _fused_on() and (N <= FUSED_CHUNK or N % FUSED_CHUNK == 0):
        return fused_ball_group(radius, nsample, xyz, new_xyz, src,
                                fast_gather)[0]
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    return group_points(idx, src, new_xyz, fast_gather)


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: Optional[torch.Tensor],
                     fps_start: Optional[torch.Tensor] = None,
                     fast_gather: bool = False):
    """FPS (from ``fps_start`` [B], default 0) -> centroid gather ->
    :func:`ball_group`:
    -> (new_xyz [B, npoint, 3], grouped [B, npoint, nsample, 3 (+D)])."""
    new_xyz = gather_rows(xyz, farthest_point_sample(xyz, npoint,
                                                     start=fps_start))
    src = torch.cat([xyz, points], dim=-1) if points is not None else xyz
    return new_xyz, ball_group(radius, nsample, xyz, new_xyz, src,
                               fast_gather)


def msg_ball_groups(radius_list: Sequence[float],
                    nsample_list: Sequence[int], xyz: torch.Tensor,
                    new_xyz: torch.Tensor, src: torch.Tensor,
                    fast_gather: bool = False):
    """Multi-scale ball query + group (``tumseg/ops/__init__.py:243-272``):
    -> one [B, S, nsample_list[i], C] tensor per radius, channels 0-2 of
    ``src`` [B, N, C] centred on ``new_xyz``. It never takes the fused op:
    ``tumseg`` reaches ``ball_group`` here only at N % 32 != 0, which no
    model has."""
    idxs = query_ball_point_multi(radius_list, nsample_list, xyz, new_xyz)
    return [group_points(idx, src, new_xyz, fast_gather) for idx in idxs]


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               momentum: torch.Tensor, momentum_keep: torch.Tensor,
               eps: float, training: bool, mesh=None, relu: bool = False,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``core.batch_norm`` (its arguments and result): on a CUDA f32 input
    without a mesh the kernels (:class:`BatchNormReLU`; ``dtype`` f32 or
    bf16), on a CUDA input inside :func:`plain` or with a mesh, or on any
    other device, the plain formula. A CUDA input of another dtype
    raises."""
    if x.device.type == "cuda":
        if mesh is None and not getattr(_state, "plain", False):
            if x.dtype != torch.float32:
                raise TypeError(f"batch_norm on the card takes f32 inputs, "
                                f"got {x.dtype}")
            return BatchNormReLU.apply(
                x, weight, bias, running_mean, running_var, momentum,
                momentum_keep, eps, training, relu,
                torch.float32 if dtype is None else dtype)
        kernels.count_plain("batch_norm_plain")
    return core.batch_norm(x, weight, bias, running_mean, running_var,
                           momentum, momentum_keep, eps, training, mesh,
                           relu, dtype)
