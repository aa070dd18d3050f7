"""FPS on the CPU: the port's plain FPS against tumseg's on inputs full of
ties, and the geometry of the CUDA kernel (csrc/fps.cu), whose tie rule the
card tests (tests/test_torch_cuda.py::test_fps) hold bitwise to the plain
version.

- ``core.farthest_point_sample`` against ``tumseg.ops.core``'s XLA FPS and
  the Pallas ``tumseg.ops.pallas.fps`` kernel in interpret mode, on an
  integer lattice, a row of equal points and duplicates of the farthest
  point, with and without ``start``, and with npoint > N: identical indices.
- ``kernels.fps_geometry`` for every N from 1 to ``FPS_MAX_N``: the limits of
  the kernel's instances, each point owned once, and shared memory.
- A numpy model of the kernel's reduction (each thread's strict > over its
  points, the warp's maximum of the distance bits and least index among the
  lanes holding it, then the same over the warps' slots) at the helper's
  geometry and at others: identical to the plain version.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg.ops import core as xla_ops
from tumseg_torch.ops import core, kernels

# the shared memory a CTA may take on Hopper, and csrc/fps.cu's static slots
SMEM_LIMIT = 232_448
SLOT_BYTES = 2 * 32 * 8
# csrc/fps.cu's instances: points a thread -> the most threads (max_threads;
# 16 points past 512 threads keep the coordinates in shared memory)
MAX_THREADS = {1: 1024, 2: 1024, 4: 1024, 8: 512, 16: 1024}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def layout(threads, points):
    """[threads, points]: the point that thread t of csrc/fps.cu holds in
    its register j, j * threads + t (N and above are padding)."""
    return (torch.arange(points).reshape(1, points) * threads
            + torch.arange(threads).reshape(threads, 1))


@pytest.fixture(autouse=True)
def _interpret_mode():
    """Pallas TPU kernels run under the interpreter on CPU, as in
    tests/test_pallas_ops.py."""
    if os.environ.get("TUMSEG_TEST_TPU") == "1":
        yield
        return
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def tie_heavy(kind, B, N, seed=0):
    """[B, N, 3] f32 inputs whose distances tie: "lattice" (a 4 x 4 x 4
    integer lattice drawn with repeats, every distance exact), "equal" (one
    point N times: every distance +0), "dup_far" (random points with the
    farthest corner repeated at several indices)."""
    rng = np.random.default_rng(seed)
    if kind == "lattice":
        return rng.integers(0, 4, (B, N, 3)).astype(np.float32)
    if kind == "equal":
        return np.full((B, N, 3), 0.375, dtype=np.float32)
    xyz = rng.random((B, N, 3)).astype(np.float32)
    for at in (N // 3, N // 2, N - 1):
        xyz[:, at] = 4.0
    return xyz


CASES = [(kind, B, N, npoint, with_start)
         for kind in ("lattice", "equal", "dup_far")
         for with_start in (False, True)
         for B, N, npoint in ((2, 48, 20), (1, 20, 33))]  # npoint > N


@pytest.mark.parametrize("kind,B,N,npoint,with_start", CASES)
def test_fps_ties_match_xla_and_pallas(kind, B, N, npoint, with_start):
    from tumseg.ops.pallas.fps import farthest_point_sample as fps_pallas

    xyz = tie_heavy(kind, B, N)
    start = (np.random.default_rng(1).integers(0, N, B).astype(np.int32)
             if with_start else None)
    got = core.farthest_point_sample(
        torch.from_numpy(xyz), npoint,
        None if start is None else torch.from_numpy(start)).numpy()
    jstart = None if start is None else jnp.asarray(start)
    want = np.asarray(xla_ops.farthest_point_sample(jnp.asarray(xyz), npoint,
                                                    start=jstart))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(fps_pallas(jnp.asarray(xyz), npoint, start=jstart)))
    if kind == "equal":  # every distance is +0 after the first step
        assert (got[:, 1:] == 0).all()
    if npoint > N:  # once all distances are +0 the argmax returns index 0
        assert (got[:, N:] == 0).all()


def test_fps_geometry_every_n():
    """Every N from 1 to FPS_MAX_N: a multiple of 32 threads within the
    instance's limit, every point owned with less than a warp's worth of
    padding, and the coordinates and slots within a CTA's shared memory;
    each geometry's layout owns every point of the row once."""
    checked = {}
    for N in range(1, kernels.FPS_MAX_N + 1):
        threads, points = geometry = kernels.fps_geometry(N)
        assert threads % 32 == 0 and threads >= 32, (N, geometry)
        assert threads <= MAX_THREADS[points], (N, geometry)
        assert threads * points >= N, (N, geometry)
        assert (threads - 32) * points < N, (N, geometry)
        assert 12 * points * threads + SLOT_BYTES <= SMEM_LIMIT, N
        if geometry not in checked:
            owned = layout(*geometry)
            checked[geometry] = torch.equal(owned.flatten().sort().values,
                                            torch.arange(threads * points))
        assert checked[geometry], geometry
    assert kernels.fps_geometry(4096) == (512, 8)   # sa1
    assert kernels.fps_geometry(64) == (32, 2)      # sa4: one warp
    for N in (0, kernels.FPS_MAX_N + 1):
        with pytest.raises(ValueError, match="fps takes"):
            kernels.fps_geometry(N)


def kernel_model(xyz, start, npoint, threads, points):
    """csrc/fps.cu's reduction in numpy f32: points past N are zeros at
    distance +0; each thread keeps the first of its largest by a strict >
    over its points in register order; a warp takes the largest bit pattern
    and the least index among its lanes holding it; the slots (one a warp)
    reduce the same way."""
    B, N, _ = xyz.shape
    owned = layout(threads, points).numpy()      # [T, P]
    L = owned.size
    pts = np.zeros((B, L, 3), np.float32)
    pts[:, :N] = xyz
    d = np.where(np.arange(L) < N, np.float32(1e10), np.float32(0))
    d = np.broadcast_to(d, (B, L)).copy()
    far = np.asarray(start, np.int64)
    out = np.empty((B, npoint), np.int32)
    rows = np.arange(B)
    for it in range(npoint):
        out[:, it] = far
        c = pts[rows, far][:, None]
        diff = pts - c
        sq = diff * diff
        d = np.fmin(d, (sq[..., 0] + sq[..., 1]) + sq[..., 2])
        vals = d[:, owned]                        # [B, T, P]
        bj = vals.argmax(-1)                      # the first of the largest
        bits = vals.max(-1).view(np.uint32)       # [B, T]
        cand = owned[np.arange(threads), bj].astype(np.uint64)
        bits = bits.reshape(B, -1, 32)            # warps
        cand = cand.reshape(B, -1, 32)
        wmax = bits.max(-1, keepdims=True)
        widx = np.where(bits == wmax, cand, 2 ** 32 - 1).min(-1)
        wmax = wmax[..., 0]                       # [B, slots]
        smax = wmax.max(-1, keepdims=True)
        far = np.where(wmax == smax, widx, 2 ** 32 - 1).min(-1)
        far = far.astype(np.int64)
    return out


# the helper's geometry, one warp, a few warps, and the most padding
MODEL_GEOMETRIES = [None, (32, 8), (64, 4), (224, 1), (128, 2)]


@pytest.mark.parametrize("geometry", MODEL_GEOMETRIES)
@pytest.mark.parametrize("kind", ["lattice", "equal", "dup_far", "random"])
def test_fps_kernel_model_matches_plain(kind, geometry):
    B, N, npoint = 2, 200, 230                    # npoint > N
    xyz = (np.random.default_rng(2).random((B, N, 3)).astype(np.float32)
           if kind == "random" else tie_heavy(kind, B, N))
    start = np.array([N - 1, 7], np.int32)
    geometry = geometry or kernels.fps_geometry(N)
    want = core.farthest_point_sample(torch.from_numpy(xyz), npoint,
                                      torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(
        kernel_model(xyz, start, npoint, *geometry), want)
