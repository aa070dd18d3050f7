"""The 3-NN + interpolation kernel's design on the CPU (csrc/
three_nn_interpolate.cu; the card tests in tests/test_torch_cuda.py hold
the kernel itself to the plain version).

- ``three_nn_probe.walk_model``, a numpy model of the kernel's search: each
  tile of sources split into z-slabs, each query testing its own slab and
  walking the slabs above and below, stopping a direction at the first
  slab whose nearest z gives fl(dz*dz) above its third distance, entries
  kept by (distance, index). At fp1-fp4's shapes and at the kernel's
  limits (S = 3, S past one tile, fewer queries than a block), on inputs
  full of ties (an integer lattice, duplicated sources, every source at one
  point) and on facade blocks:
  indices and distances identical to ``core.three_nn`` and to ``tumseg``'s
  ``_threenn_kernel_t`` in interpret mode.
- A numpy model of the kernel's weights and row sums, both modes: ``out``
  bitwise ``core.three_nn_interpolate``'s (the operations and their order
  are the same, so the card tests print whether the kernel is bitwise too).
- ``kernels.three_nn_geometry`` for every N up to 4096 at several B, S and
  D: every query searched, written and interpolated by exactly one thread,
  shared memory within a block's limit, and at least two blocks an SM at
  fp1-fp4 of B=32 and 16.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg_torch.ops import core, kernels
from tumseg_torch.tools.three_nn_probe import (interpolation_model,
                                               walk_model)

# the shared memory a block may take on Hopper, and the static shared
# memory of csrc/three_nn_interpolate.cu: the float4 source tile, the
# (index, weight) table of its queries, the slabs' offsets, counts and z
# bounds, and the z range's partials
SMEM_LIMIT = 232_448
STATIC_SMEM_LIMIT = 48 * 1024
KERNEL_SMEM = (16 * kernels.THREE_NN_TILE + 24 * kernels.THREE_NN_MAX_QUERIES
               + 4 * (4 * kernels.THREE_NN_MAX_SLABS + 1)
               + 8 * kernels.THREE_NN_THREADS // 32)
# (N, S, D) of fp1..fp4
FP = [(4096, 1024, 128), (1024, 256, 256), (256, 64, 256), (64, 16, 512)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def tie_heavy(kind, B, N, S, seed=0):
    """(xyz1 [B, N, 3], xyz2 [B, S, 3]) f32: "lattice" (a 4 x 4 x 4
    integer lattice drawn with repeats), "duplicates" (points on a grid of
    1/64, one source repeated at several indices and the first queries
    sitting on it), "one_point" (every source at one point of that grid:
    each query's distances all equal), whose distances tie and are exact
    in f32 (so an FMA-contracted sum gives them too); "random" (the unit
    cube, every product rounded)."""
    rng = np.random.default_rng(seed)
    if kind == "lattice":
        return (rng.integers(0, 4, (B, N, 3)).astype(np.float32),
                rng.integers(0, 4, (B, S, 3)).astype(np.float32))
    if kind == "random":
        return (rng.random((B, N, 3)).astype(np.float32),
                rng.random((B, S, 3)).astype(np.float32))
    xyz1 = (rng.integers(0, 64, (B, N, 3)) / 64).astype(np.float32)
    xyz2 = (rng.integers(0, 64, (B, S, 3)) / 64).astype(np.float32)
    if kind == "one_point":
        xyz2[:] = xyz2[:, :1]
    else:
        for at in sorted({S // 3, S // 2, S - 1} - {0}):
            xyz2[:, at] = xyz2[:, 0]
        xyz1[:, : min(N, 4)] = xyz2[:, :1]
    return xyz1, xyz2


def facade(B, N, S, seed=0):
    """1 m x 1 m x 10 m columns, 70% of the points on a wall plane (the
    shapes chip_smoke.py serves), queries and sources drawn alike."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (N, S):
        wall = rng.random((B, n)) < 0.7
        out.append(np.stack([rng.uniform(-0.5, 0.5, (B, n)),
                             np.where(wall, rng.normal(0.0, 0.02, (B, n)),
                                      rng.uniform(-0.5, 0.5, (B, n))),
                             rng.uniform(0.0, 10.0, (B, n))], -1).astype(
                                 np.float32))
    return out


# (N, S): fp1-fp4, S = 3, sources past one tile of the kernel, N below a
# block of the helper's
MODEL_CASES = [fp[:2] for fp in FP] + [(40, 3), (100, 1500), (5, 2100)]


@pytest.mark.parametrize("kind", ["lattice", "duplicates", "one_point",
                                  "random"])
@pytest.mark.parametrize("N,S", MODEL_CASES)
def test_walk_model_matches_plain_and_pallas(kind, N, S):
    """Identical to the plain version everywhere. Identical to the Pallas
    kernel on the exact inputs; on "random", XLA on the CPU contracts the
    interpreted kernel's sums into FMAs (the port rounds every product, as
    the CUDA kernel does under -fmad=false), so there the indices are
    identical and the distances within 2 ulps."""
    from tumseg.ops.pallas.threenn import _three_nn_impl_t

    xyz1, xyz2 = tie_heavy(kind, 1, N, S)
    dists, idx, tested = walk_model(xyz1, xyz2)
    want_d, want_i = core.three_nn(torch.from_numpy(xyz1),
                                   torch.from_numpy(xyz2))
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_array_equal(dists, want_d.numpy())
    assert N * min(S, 3) <= tested <= N * S
    pd, pi = _three_nn_impl_t(jnp.asarray(xyz1), jnp.asarray(xyz2))
    np.testing.assert_array_equal(idx, np.asarray(pi))
    if kind == "random":
        np.testing.assert_array_max_ulp(dists, np.asarray(pd), maxulp=2)
    else:
        np.testing.assert_array_equal(dists, np.asarray(pd))
    if kind == "one_point":                  # all equal: the first three
        assert (idx == [0, 1, 2]).all()


@pytest.mark.parametrize("stage", range(4))
def test_walk_model_on_facade_blocks(stage):
    """On facade blocks the walk is exact and tests a small share of the
    sources at fp1 and fp2, where the full scan's work lies."""
    N, S, _ = FP[stage]
    xyz1, xyz2 = facade(2, N, S, seed=stage)
    dists, idx, tested = walk_model(xyz1, xyz2)
    want_d, want_i = core.three_nn(torch.from_numpy(xyz1),
                                   torch.from_numpy(xyz2))
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_array_equal(dists, want_d.numpy())
    if S >= 256:
        assert tested < 0.25 * 2 * N * S


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("N,S,D", [(256, 64, 128), (100, 16, 7), (33, 3, 1)])
def test_interpolation_model_is_bitwise_plain(fast, N, S, D):
    rng = np.random.default_rng(3)
    xyz1, xyz2 = tie_heavy("duplicates", 2, N, S, seed=4)
    points2 = rng.standard_normal((2, S, D)).astype(np.float32)
    dists, idx, _ = walk_model(xyz1, xyz2)
    got = interpolation_model(dists, idx, points2, fast)
    want = core.three_nn_interpolate(torch.from_numpy(xyz1),
                                     torch.from_numpy(xyz2),
                                     torch.from_numpy(points2), fast)[2]
    np.testing.assert_array_equal(got, want.numpy())


def _row_cover(Q, R, cols):
    """[Q, cols]: how many threads compute each (row, column) of a block's
    output tile (rows q = rg, rg + F, ..., columns lr, lr + R, ...)."""
    F = kernels.THREE_NN_THREADS // R
    cover = np.zeros((Q, max(cols, 1)), np.int64)
    for t in range(kernels.THREE_NN_THREADS):
        rg, lr = divmod(t, R)
        for q in range(rg, Q, F):
            cover[q, lr:cols:R] += 1
    return cover[:, :cols]


@pytest.mark.parametrize("B", [1, 2, 16, 32, 64])
def test_three_nn_geometry_every_n(B):
    """Every N from 1 to 4096 at fp1-fp4's and edge widths D: the limits
    of the kernel's launcher, one thread a query within the block, every
    output element computed once, and two blocks an SM where the batch has
    the queries."""
    covered = {}
    for N in range(1, 4097):
        for D in (1, 7, 40, 128, 256, 512):
            Q, R = g = kernels.three_nn_geometry(B, N, D)
            assert 1 <= Q <= kernels.THREE_NN_MAX_QUERIES, g
            assert Q <= kernels.THREE_NN_THREADS and Q & (Q - 1) == 0, g
            assert 1 <= R <= kernels.THREE_NN_THREADS and R & (R - 1) == 0
            cols = -(-D // 4)
            assert R == 1 or R <= 2 * cols - 1, g   # no lane without one
            assert 4 * R >= cols or R == kernels.THREE_NN_THREADS, g
            assert B * -(-N // Q) >= 2 * kernels.SMS or Q == 1, (N, g)
            if Q > 1:   # a larger Q would fall short of two blocks an SM
                assert B * -(-N // (2 * Q)) < 2 * kernels.SMS or \
                    Q == kernels.THREE_NN_MAX_QUERIES, (N, g)
            if (Q, R, cols) not in covered:
                covered[(Q, R, cols)] = (_row_cover(Q, R, cols) == 1).all()
            assert covered[(Q, R, cols)], (Q, R, cols)
    assert KERNEL_SMEM <= min(SMEM_LIMIT, STATIC_SMEM_LIMIT)


@pytest.mark.parametrize("B", [32, 16])
@pytest.mark.parametrize("stage", range(4))
def test_three_nn_geometry_fills_the_card(B, stage):
    """fp1-fp4 of a B=32 forward and a B=16 step: at least two blocks for
    each of the 132 SMs, and each query owned by one block (the blocks'
    query ranges tile the row)."""
    N, _, D = FP[stage]
    Q, _ = kernels.three_nn_geometry(B, N, D)
    blocks = -(-N // Q)
    assert B * blocks >= 2 * kernels.SMS
    owner = np.zeros(N, np.int64)
    for x in range(blocks):
        owner[x * Q:min(N, (x + 1) * Q)] += 1
    assert (owner == 1).all()


def test_three_nn_geometry_picks():
    """The geometries the main path runs (retune from
    tumseg_torch/tools/three_nn_probe.py on the card)."""
    got = [kernels.three_nn_geometry(32, N, D) for N, _, D in FP]
    assert got == [(256, 8), (64, 16), (16, 16), (4, 64)]
