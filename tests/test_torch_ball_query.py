"""The ball-query kernels' design on the CPU (csrc/ball_query.cuh, launched
by ball_query.cu and ball_query_multi.cu; the card tests in
tests/test_torch_cuda.py hold the kernels themselves to the plain version).

- ``ball_query_probe.walk_model``, a numpy model of the kernels: each tile
  of sources split into z-slabs by the kernel's f32 arithmetic (or scanned),
  each query testing its range of slabs out to the first non-empty slab
  whose nearest z gives fl(dz*dz) above its limit, the hits appended in
  index order. Its indices equal ``core.query_ball_point`` and
  ``core.query_ball_point_multi`` at sa1-sa4's shapes on facade blocks (SSG
  and MSG) and on adversarial inputs (points at |dz| = r and one ulp either
  side, one z for all, duplicates, an empty ball, balls past K, N past one
  tile and at ``FPS_MAX_N``, fewer queries than a block, unsorted radii
  R = 1-4), walked and scanned alike; and ``tumseg``'s ``_ballquery_kernel``
  and ``_ballquery_kernel_bp_multi`` in interpret mode at N <= 1024.
- ``kernels.ball_query_geometry`` for every N up to 4096 and some up to
  ``FPS_MAX_N``: every query owned by one block and one thread, shared
  memory within the block's limit, one block an SM in one wave where the
  batch allows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tumseg_torch.ops import core, kernels
from tumseg_torch.tools.ball_query_probe import (adversarial_cases,
                                                 stage_inputs, walk_model)

# the shared memory a block may take on Hopper, and ball_query.cuh's static
# shared memory: the slabs' offsets, counts and z bounds, the z range's
# partials; the rest is the launcher's dynamic allowance
SMEM_LIMIT = 232_448
STATIC_SMEM = (4 * (4 * kernels.BALL_QUERY_MAX_SLABS + 1)
               + 8 * kernels.BALL_QUERY_THREADS // 32)
CASES = {case[0]: case[1:] for case in adversarial_cases()}


def _plain(xyz, new_xyz, radii, ks):
    return [w.numpy() for w in core.query_ball_point_multi(
        radii, ks, torch.from_numpy(xyz), torch.from_numpy(new_xyz))]


def _assert_model(xyz, new_xyz, radii, ks, geometry=None):
    got, tested = walk_model(xyz, new_xyz, radii, ks, geometry)
    for r, g, w in zip(radii, got, _plain(xyz, new_xyz, radii, ks)):
        np.testing.assert_array_equal(g, w, err_msg=f"r={r}")
    B, N, _ = xyz.shape
    assert 0 <= tested <= B * N * new_xyz.shape[1]
    return got, tested


@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_model_matches_plain(name):
    """Walked and scanned alike, and in tiles of 1024, the model's indices
    are the plain version's."""
    xyz, new_xyz, radii, ks = CASES[name]
    B, N, _ = xyz.shape
    Q, L, tile, _ = kernels.ball_query_geometry(B, N, new_xyz.shape[1],
                                                len(ks))
    got, _ = _assert_model(xyz, new_xyz, radii, ks)
    for geometry in ((Q, L, tile, 0), (Q, L, tile, 1),
                     (Q, L, min(tile, 1024), 1)):
        again, _ = _assert_model(xyz, new_xyz, radii, ks, geometry)
        for g, a in zip(got, again):
            np.testing.assert_array_equal(g, a)
    if name == "empty":
        assert (got[0][0, 0] == N).all() and (got[0][1, 5:9] == N).all()
    if name == "overfull":     # every ball past K: the first K in order
        assert (np.diff(got[0], axis=-1) > 0).all()
    if name.startswith("boundary"):   # the exact edge and the ulp inside
        assert (got[0] >= new_xyz.shape[1]).any()


@pytest.mark.parametrize("msg", [False, True])
@pytest.mark.parametrize("stage", range(4))
def test_walk_model_on_stages(msg, stage):
    """sa1-sa4 of the SSG and MSG forwards on facade blocks: exact, and the
    walked stages test a small share of the row."""
    xyz, new_xyz, radii, ks = stage_inputs(2, stage, msg=msg)
    _, tested = _assert_model(xyz, new_xyz, radii, ks)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if kernels.ball_query_geometry(32, N, S, len(ks))[3]:
        assert tested < 0.06 * B * N * S
    else:      # no ball fills: the scan runs to the tile's end
        assert tested == B * N * S


# cases run through tumseg's Pallas kernels in interpret mode (N <= 1024;
# exact products, or facade blocks, where XLA's FMA contraction on the CPU
# moves no distance across r^2)
PALLAS_SINGLE = ["boundary_r0.1", "boundary_r0.125", "duplicates", "empty",
                 "overfull"]
PALLAS_MULTI = ["multi_R3", "multi_boundary"]


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("name", PALLAS_SINGLE + ["sa2"])
def test_walk_model_matches_pallas(interpret, name):
    from tumseg.ops.pallas.ballquery import query_ball_point

    if name == "sa2":
        xyz, new_xyz, radii, ks = stage_inputs(2, 1)
    else:
        xyz, new_xyz, radii, ks = CASES[name]
    got, _ = walk_model(xyz, new_xyz, radii, ks)
    want = query_ball_point(radii[0], ks[0], jnp.asarray(xyz),
                            jnp.asarray(new_xyz))
    np.testing.assert_array_equal(got[0], np.asarray(want))


@pytest.mark.parametrize("name", PALLAS_MULTI + ["msg_sa2"])
def test_walk_model_matches_pallas_multi(interpret, name):
    from tumseg.ops.pallas.ballquery import query_ball_point_bp_multi

    if name == "msg_sa2":
        xyz, new_xyz, radii, ks = stage_inputs(2, 1, msg=True)
    else:
        xyz, new_xyz, radii, ks = CASES[name]
    assert xyz.shape[1] % 32 == 0      # else tumseg takes its row kernel
    got, _ = walk_model(xyz, new_xyz, radii, ks)
    want = query_ball_point_bp_multi(radii, ks, jnp.asarray(xyz),
                                     jnp.asarray(new_xyz))
    for r, g, w in zip(radii, got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"r={r}")


def _check_geometry(B, N, S, R):
    Q, L, tile, walk = g = kernels.ball_query_geometry(B, N, S, R)
    assert 1 <= Q <= kernels.BALL_QUERY_THREADS and Q & (Q - 1) == 0, g
    assert 8 <= L <= 32 and L & (L - 1) == 0, g
    assert tile == max(1, min(N, kernels.BALL_QUERY_TILE)), g
    assert walk == int(N >= kernels.BALL_QUERY_WALK_N), g
    assert kernels.ball_query_smem(tile, Q, L, R) <= kernels.BALL_QUERY_SMEM
    assert kernels.BALL_QUERY_SMEM + STATIC_SMEM == SMEM_LIMIT
    # Q: the fewest blocks, at most one an SM where the threads allow;
    # L: all of Q in flight, 8 to 32 lanes, more where the masks need it
    assert B * -(-S // Q) <= kernels.SMS or \
        Q == kernels.BALL_QUERY_THREADS, (S, g)
    assert Q == 1 or B * -(-S // (Q // 2)) > kernels.SMS, (S, g)
    lanes = max(8, min(32, kernels.BALL_QUERY_THREADS // Q))
    assert L == lanes or (L > lanes and kernels.ball_query_smem(
        tile, Q, L // 2, R) > kernels.BALL_QUERY_SMEM), (S, g)
    return g


def _owners(S, Q, L):
    """How many (block, group) turns take each query of a row, as the
    kernel's loops run: block x owns queries x*Q + q, q < min(Q, S - x*Q);
    group g of kThreads / L takes q = g, g + G, ..."""
    G = kernels.BALL_QUERY_THREADS // L
    s0 = np.arange(-(-S // Q))[:, None, None] * Q
    q = (np.arange(G)[:, None] + G * np.arange(-(-Q // G))[None, :])[None]
    return np.bincount((s0 + q)[(q < Q) & (q < S - s0)], minlength=S)


@pytest.mark.parametrize("B", [1, 2, 16, 32])
def test_ball_query_geometry_every_n(B):
    """Every N from 1 to 4096 at several S and 1-4 radii: the launcher's
    limits, shared memory within a block's, and every query taken by one
    group once."""
    seen = set()
    for N in range(1, 4097):
        for S in (1, 3, 16, 64, 100, 256, 1024, N):
            for R in (1, 2, 4):
                Q, L, _, _ = _check_geometry(B, N, S, R)
                if (S, Q, L) not in seen:
                    seen.add((S, Q, L))
                    assert (_owners(S, Q, L) == 1).all(), (S, Q, L)


@pytest.mark.parametrize("N", [4097, 5000, 8192, 12345, kernels.FPS_MAX_N])
def test_ball_query_geometry_past_one_tile(N):
    for B in (1, 16, 32):
        for S in (1, 33, 1024, 4096):
            for R in (1, 2, 4):
                _, _, tile, walk = _check_geometry(B, N, S, R)
                assert tile == kernels.BALL_QUERY_TILE and walk == 1


def test_ball_query_geometry_picks():
    """The geometries the main path runs, B=32 and B=16, SSG (one radius)
    and MSG (two): one block an SM in one wave, 8 lanes a query or more
    (retune from tumseg_torch/tools/ball_query_probe.py on the card)."""
    shapes = [(4096, 1024), (1024, 256), (256, 64), (64, 16)]
    got = {(B, R): [kernels.ball_query_geometry(B, N, S, R)
                    for N, S in shapes] for B in (32, 16) for R in (1, 2)}
    assert got[32, 1] == got[32, 2] == [(256, 8, 4096, 1), (64, 16, 1024, 1),
                                        (16, 32, 256, 0), (4, 32, 64, 0)]
    assert got[16, 1] == got[16, 2] == [(128, 8, 4096, 1), (32, 32, 1024, 1),
                                        (8, 32, 256, 0), (2, 32, 64, 0)]


def test_launcher_signatures_match_sources():
    """``build.SIGNATURES`` gives ctypes each launcher's parameters as the
    C source declares them (a pointer as c_void_p, int as c_int, float as
    c_float): a missing one would hand the stream a stray register."""
    import ctypes
    import re

    from tumseg_torch.ops import build

    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    found = {}
    for src in build.CSRC.glob("*.cu"):
        for name, params in re.findall(
                r"TUMSEG_API int (\w+)\(([^)]*)\)", src.read_text()):
            found[name] = ["pointer" if "*" in p else p.split()[-2]
                           for p in " ".join(params.split()).split(",")]
    assert set(found) == set(build.SIGNATURES)
    for name, argtypes in build.SIGNATURES.items():
        assert [kinds[a] for a in argtypes] == found[name], name
