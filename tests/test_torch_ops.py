"""The port's plain point ops (tumseg_torch.ops.core) against tumseg: the XLA
compositions of tumseg.ops.core and the Pallas kernels in interpret mode, on
the same numpy inputs. Indices must be identical; floats agree within
atol 1e-5 (f32 rounding of differently ordered sums). The plain backward
passes agree with jax.grad through the Pallas backward kernels within
rtol 1e-5 / atol 1e-6 (the same f32 terms summed in another order), and the
autograd Functions pass a finite-difference check in f64. The CUDA kernels
are held against these plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg.ops import core as xla_ops
from tumseg_torch import ops as tops
from tumseg_torch.ops import core, kernels


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("B,N,npoint,with_start", [
    (2, 128, 16, True), (3, 100, 32, False), (1, 64, 64, True),
    (2, 40, 64, False),  # npoint > N: the first-index argmax returns 0
])
def test_fps_matches_xla_and_pallas(B, N, npoint, with_start):
    from tumseg.ops.pallas.fps import farthest_point_sample as fps_pallas

    r = np.random.default_rng(0)
    xyz = r.random((B, N, 3)).astype(np.float32)
    start = r.integers(0, N, B).astype(np.int32) if with_start else None
    got = _np(core.farthest_point_sample(
        _t(xyz), npoint, None if start is None else _t(start)))
    jstart = None if start is None else jnp.asarray(start)
    want = _np(xla_ops.farthest_point_sample(jnp.asarray(xyz), npoint,
                                             start=jstart))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _np(fps_pallas(jnp.asarray(xyz), npoint, start=jstart)))
    assert got.dtype == np.int32


@pytest.mark.parametrize("variant", ["row", "transposed", "bitpacked"])
@pytest.mark.parametrize("B,N,S,K,r", [(2, 128, 64, 8, 0.3),
                                       (1, 256, 256, 16, 0.2),
                                       (2, 96, 40, 4, 0.5)])
def test_ball_query_matches_xla_and_pallas(variant, B, N, S, K, r):
    from tumseg.ops.pallas import ballquery

    kernel = {"row": ballquery.query_ball_point,
              "transposed": ballquery.query_ball_point_t,
              "bitpacked": ballquery.query_ball_point_bp}[variant]
    rng = np.random.default_rng(0)
    xyz = rng.random((B, N, 3)).astype(np.float32)
    new_xyz = np.ascontiguousarray(xyz[:, :S])
    got = _np(core.query_ball_point(r, K, _t(xyz), _t(new_xyz)))
    np.testing.assert_array_equal(
        got, _np(kernel(r, K, jnp.asarray(xyz), jnp.asarray(new_xyz))))
    np.testing.assert_array_equal(
        got, _np(xla_ops.query_ball_point(r, K, jnp.asarray(xyz),
                                          jnp.asarray(new_xyz))))


def test_ball_query_fill_and_sentinel():
    from tumseg.ops.pallas.ballquery import query_ball_point as bq_pallas

    xyz = np.asarray([[[0, 0, 0], [10, 10, 10], [10.05, 10, 10]]],
                     np.float32)
    queries = np.asarray([[[0, 0, 0], [10, 10, 10], [50, 50, 50]]],
                         np.float32)
    got = _np(core.query_ball_point(0.2, 4, _t(xyz), _t(queries)))
    np.testing.assert_array_equal(got[0], [[0, 0, 0, 0],    # fill: first hit
                                           [1, 2, 1, 1],
                                           [3, 3, 3, 3]])   # empty: N
    np.testing.assert_array_equal(
        got, _np(bq_pallas(0.2, 4, jnp.asarray(xyz), jnp.asarray(queries))))
    # nsample > N pads with the first hit, as tumseg/ops/core.py:117-121
    np.testing.assert_array_equal(
        _np(core.query_ball_point(0.2, 5, _t(xyz), _t(queries[:, :1]))),
        _np(xla_ops.query_ball_point(0.2, 5, jnp.asarray(xyz),
                                     jnp.asarray(queries[:, :1]))))


@pytest.mark.parametrize("B,N,S,radii,Ks", [
    (2, 512, 128, (0.1, 0.2), (16, 32)),
    (1, 512, 128, (0.2, 0.05, 0.1), (8, 16, 4)),  # unsorted radii
])
def test_ball_query_multi_matches_pallas_and_single(B, N, S, radii, Ks):
    """core.query_ball_point_multi against the Pallas multi-radius kernel
    (query_ball_point_bp_multi, the same direct-form distances) and against
    one plain single-radius query per radius."""
    from tumseg.ops.pallas.ballquery import query_ball_point_bp_multi

    rng = np.random.default_rng(7)
    xyz = rng.random((B, N, 3)).astype(np.float32)
    new_xyz = np.ascontiguousarray(xyz[:, :S])
    got = core.query_ball_point_multi(radii, Ks, _t(xyz), _t(new_xyz))
    want = query_ball_point_bp_multi(radii, Ks, jnp.asarray(xyz),
                                     jnp.asarray(new_xyz))
    assert len(got) == len(want) == len(radii)
    for r, k, g, w in zip(radii, Ks, got, want):
        assert g.shape == (B, S, k) and g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"r={r}")
        np.testing.assert_array_equal(
            _np(g), _np(core.query_ball_point(r, k, _t(xyz), _t(new_xyz))))
    np.testing.assert_array_equal(
        _np(got[0]), _np(tops.query_ball_point_multi(
            radii, Ks, _t(xyz), _t(new_xyz))[0]))


def test_ball_query_multi_empty_ball_and_shortfall():
    """An empty ball gives N in every slot of every radius; a ball with
    fewer hits than K repeats its first hit."""
    from tumseg.ops.pallas.ballquery import query_ball_point_bp_multi

    rng = np.random.default_rng(8)
    N = 64
    xyz = rng.random((1, N, 3)).astype(np.float32)
    new_xyz = xyz[:, :32].copy()
    new_xyz[0, 0] = 50.0
    radii, Ks = (0.3, 0.1), (8, 40)
    got = core.query_ball_point_multi(radii, Ks, _t(xyz), _t(new_xyz))
    want = query_ball_point_bp_multi(radii, Ks, jnp.asarray(xyz),
                                     jnp.asarray(new_xyz))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
        assert (_np(g)[0, 0] == N).all()
    small = _np(got[1])[0, 1:]
    hits = (small != small[:, :1]).sum(-1) + 1
    assert (hits < 40).all()  # every ball of r = 0.1 falls short of K = 40
    for row, n in zip(small, hits):
        assert (row[n:] == row[0]).all() and (np.diff(row[:n]) > 0).all()


def test_ball_query_multi_ragged_n_matches_single():
    """N % 32 != 0: the plain multi-radius query against per-radius plain
    calls and tumseg's per-radius fallback."""
    from tumseg.ops.pallas.ballquery import query_ball_point_bp_multi

    rng = np.random.default_rng(9)
    xyz = rng.random((2, 100, 3)).astype(np.float32)
    new_xyz = np.ascontiguousarray(xyz[:, :16])
    radii, Ks = (0.4, 0.2), (8, 4)
    got = core.query_ball_point_multi(radii, Ks, _t(xyz), _t(new_xyz))
    want = query_ball_point_bp_multi(radii, Ks, jnp.asarray(xyz),
                                     jnp.asarray(new_xyz))
    for r, k, g, w in zip(radii, Ks, got, want):
        np.testing.assert_array_equal(
            _np(g), _np(core.query_ball_point(r, k, _t(xyz), _t(new_xyz))))
        np.testing.assert_array_equal(_np(g), _np(w))
    with pytest.raises(ValueError, match="nsamples"):
        core.query_ball_point_multi((0.1, 0.2), (4,), _t(xyz), _t(new_xyz))


def test_msg_ball_groups_is_per_radius_group():
    rng = np.random.default_rng(10)
    xyz = _t(rng.random((2, 96, 3)).astype(np.float32))
    new_xyz = xyz[:, :24].contiguous()
    src = torch.cat([xyz, _t(rng.random((2, 96, 5)).astype(np.float32))], -1)
    groups = tops.msg_ball_groups([0.2, 0.4], [8, 16], xyz, new_xyz, src)
    assert [g.shape for g in groups] == [(2, 24, 8, 8), (2, 24, 16, 8)]
    for r, k, g in zip([0.2, 0.4], [8, 16], groups):
        idx = core.query_ball_point(r, k, xyz, new_xyz)
        assert torch.equal(g, core.group_points(idx, src, new_xyz))


@pytest.mark.parametrize("B,N,S,K,C", [(2, 64, 16, 8, 9), (1, 40, 8, 4, 35)])
def test_group_matches_pallas_with_sentinel(B, N, S, K, C):
    from tumseg.ops.pallas.group import group_points as group_pallas

    rng = np.random.default_rng(1)
    src = rng.standard_normal((B, N, C)).astype(np.float32)
    new_xyz = rng.standard_normal((B, S, 3)).astype(np.float32)
    idx = rng.integers(0, N + 1, (B, S, K)).astype(np.int32)
    idx[:, 0, :] = N  # one all-sentinel group: an empty ball
    got = _np(core.group_points(_t(idx), _t(src), _t(new_xyz)))
    want = _np(group_pallas(jnp.asarray(idx), jnp.asarray(src),
                            jnp.asarray(new_xyz)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 0, :, :3],
                                  -np.broadcast_to(new_xyz[:, 0, None],
                                                   (B, K, 3)))
    np.testing.assert_array_equal(got[:, 0, :, 3:], 0.0)
    # in-range rows: the XLA gather + centre subtraction, exactly
    in_range = np.where(idx == N, 0, idx)
    xla = np.array(xla_ops.index_points(jnp.asarray(src),
                                        jnp.asarray(in_range)))
    xla[..., :3] -= new_xyz[:, :, None, :]
    keep = idx != N
    np.testing.assert_array_equal(got[keep], xla[keep])


def test_gather_rows_is_index_points():
    rng = np.random.default_rng(2)
    xyz = rng.standard_normal((2, 50, 3)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 12)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(core.gather_rows(_t(xyz), _t(idx))),
        _np(xla_ops.index_points(jnp.asarray(xyz), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        _np(tops.gather_rows(_t(xyz), _t(idx))),
        _np(core.gather_rows(_t(xyz), _t(idx))))


@pytest.mark.parametrize("B,N,S", [(2, 128, 64), (1, 512, 16), (2, 100, 40)])
def test_three_nn_with_ties_matches_xla_and_pallas(B, N, S):
    from tumseg.ops.pallas.threenn import three_nn as tnn_pallas

    rng = np.random.default_rng(3)
    xyz1 = rng.random((B, N, 3)).astype(np.float32)
    xyz2 = rng.random((B, S, 3)).astype(np.float32)
    xyz2[:, 5] = xyz2[:, 2]   # duplicated sources: exact distance ties
    xyz2[:, 9] = xyz2[:, 2]
    xyz1[:, :4] = xyz2[:, 2:3]  # queries sitting on the duplicates
    gd, gi = core.three_nn(_t(xyz1), _t(xyz2))
    pd, pi = tnn_pallas(jnp.asarray(xyz1), jnp.asarray(xyz2))
    xd, xi = xla_ops.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
    np.testing.assert_array_equal(_np(gi), _np(pi))
    np.testing.assert_array_equal(_np(gi), _np(xi))
    np.testing.assert_array_equal(_np(gi)[:, :4],
                                  np.broadcast_to([2, 5, 9], (B, 4, 3)))
    np.testing.assert_allclose(_np(gd), _np(pd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(gd), _np(xd), rtol=0, atol=1e-5)
    assert gi.dtype == torch.int32


@pytest.mark.parametrize("B,N,S,D", [(2, 128, 64, 8), (1, 512, 16, 128)])
def test_interpolation_matches_xla_and_pallas(B, N, S, D):
    from tumseg.ops.pallas.interpolate import weighted_interpolate

    rng = np.random.default_rng(5)
    dists = (rng.random((B, N, 3)) + 0.01).astype(np.float32)
    idx = rng.integers(0, S, (B, N, 3)).astype(np.int32)
    pts2 = rng.random((B, S, D)).astype(np.float32)
    got = _np(core.interpolate_weighted(_t(dists), _t(idx), _t(pts2)))
    want = _np(xla_ops.interpolate_weighted(
        jnp.asarray(dists), jnp.asarray(idx), jnp.asarray(pts2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    recip = 1.0 / (dists + np.float32(1e-8))
    w = recip / recip.sum(axis=2, keepdims=True)
    np.testing.assert_allclose(
        got, _np(weighted_interpolate(jnp.asarray(idx), jnp.asarray(w),
                                      jnp.asarray(pts2))), rtol=0, atol=1e-5)


def test_three_interpolate_matches_pallas_path():
    """3-NN + weights + interpolation as tumseg runs them on the TPU (the
    direct-form 3-NN kernel, then the interpolation kernel)."""
    from tumseg.ops.pallas.interpolate import weighted_interpolate
    from tumseg.ops.pallas.threenn import three_nn as tnn_pallas

    rng = np.random.default_rng(6)
    xyz1 = rng.random((2, 96, 3)).astype(np.float32)
    xyz2 = rng.random((2, 24, 3)).astype(np.float32)
    pts2 = rng.random((2, 24, 16)).astype(np.float32)
    d, i, out = tops.three_nn_interpolate(_t(xyz1), _t(xyz2), _t(pts2))
    pd, pi = tnn_pallas(jnp.asarray(xyz1), jnp.asarray(xyz2))
    recip = 1.0 / (pd + 1e-8)
    w = recip / jnp.sum(recip, axis=2, keepdims=True)
    want = _np(weighted_interpolate(pi, w, jnp.asarray(pts2)))
    np.testing.assert_array_equal(_np(i), _np(pi))
    np.testing.assert_allclose(_np(out), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        _np(out), _np(tops.three_interpolate(_t(xyz1), _t(xyz2), _t(pts2))))


@pytest.mark.parametrize("B,N,S,K,C", [(2, 64, 16, 8, 9), (1, 40, 8, 32, 35)])
def test_group_backward_matches_pallas_grad(B, N, S, K, C):
    """d src of the Pallas group kernel's custom VJP (_group_bwd_kernel),
    with empty balls (sentinel N), repeated indices and one source row that
    every group holds."""
    from tumseg.ops.pallas.group import group_points as group_pallas

    rng = np.random.default_rng(11)
    src = rng.standard_normal((B, N, C)).astype(np.float32)
    new_xyz = rng.standard_normal((B, S, 3)).astype(np.float32)
    idx = rng.integers(0, N + 1, (B, S, K)).astype(np.int32)
    idx[:, 0, :] = N            # an empty ball
    idx[:, 1, 3:] = idx[:, 1, 2:3]  # a short ball padded with a repeat
    idx[:, :, 0] = 7            # one row in every group
    g = rng.standard_normal((B, S, K, C)).astype(np.float32)
    want = jax.grad(lambda s_: jnp.sum(group_pallas(
        jnp.asarray(idx), s_, jnp.asarray(new_xyz), fast=False)
        * jnp.asarray(g)))(jnp.asarray(src))
    got = core.group_points_backward(_t(idx), _t(g), N)
    assert got.shape == (B, N, C) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,N,S,D", [(2, 128, 32, 8), (1, 96, 3, 40)])
def test_interpolate_backward_matches_pallas_grad(B, N, S, D):
    """d points2 of the Pallas interpolation's custom VJP
    (_interp_bwd_kernel), with repeated neighbour indices."""
    from tumseg.ops.pallas.interpolate import weighted_interpolate

    rng = np.random.default_rng(12)
    idx = rng.integers(0, S, (B, N, 3)).astype(np.int32)
    idx[:, :5, 1] = idx[:, :5, 0]  # one source counted twice
    idx[:, 5:9] = 0                # one source for all three
    w = rng.random((B, N, 3)).astype(np.float32) + 0.01
    w /= w.sum(-1, keepdims=True)
    pts2 = rng.standard_normal((B, S, D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(weighted_interpolate(
        jnp.asarray(idx), jnp.asarray(w), p, fast=False)
        * jnp.asarray(g)))(jnp.asarray(pts2))
    got = core.interpolate_backward(_t(idx), _t(w), _t(g), S)
    assert got.shape == (B, S, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_autograd_functions_pass_gradcheck():
    """The autograd Functions on the plain path, in f64, against central
    finite differences (torch.autograd.gradcheck)."""
    rng = np.random.default_rng(13)
    B, N, S, K = 2, 20, 6, 4
    src = torch.from_numpy(rng.standard_normal((B, N, 5))).requires_grad_()
    new_xyz = torch.from_numpy(rng.standard_normal((B, S, 3)))
    idx = torch.from_numpy(rng.integers(0, N + 1, (B, S, K)).astype(np.int32))
    idx[:, 0] = N
    assert torch.autograd.gradcheck(
        lambda s_: tops.group_points(idx, s_, new_xyz), (src,))

    xyz1 = torch.from_numpy(rng.random((B, 15, 3)))
    xyz2 = torch.from_numpy(rng.random((B, S, 3)))
    pts2 = torch.from_numpy(rng.standard_normal((B, S, 4))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda p: tops.three_nn_interpolate(xyz1, xyz2, p)[2], (pts2,))
    dists, nn_idx, _ = tops.three_nn_interpolate(xyz1, xyz2, pts2)
    assert not dists.requires_grad and not nn_idx.requires_grad


def test_three_nn_needs_three_sources():
    with pytest.raises(ValueError, match="at least 3"):
        core.three_nn(torch.zeros(1, 4, 3), torch.zeros(1, 2, 3))


def test_dispatch_cpu_takes_plain_and_no_kernel_fallback():
    xyz = torch.rand(1, 32, 3)
    np.testing.assert_array_equal(
        _np(tops.farthest_point_sample(xyz, 8)),
        _np(core.farthest_point_sample(xyz, 8)))
    # a kernel wrapper never runs its plain version: CPU input is refused
    for call in (lambda: kernels.farthest_point_sample(xyz, 8),
                 lambda: kernels.query_ball_point(0.1, 4, xyz, xyz),
                 lambda: kernels.query_ball_point_multi(
                     (0.1, 0.2), (4, 8), xyz, xyz),
                 lambda: kernels.group_points(
                     torch.zeros(1, 2, 3, dtype=torch.int32), xyz,
                     torch.zeros(1, 2, 3)),
                 lambda: kernels.three_nn_interpolate(xyz, xyz, xyz),
                 lambda: kernels.group_points_backward(
                     torch.zeros(1, 2, 3, dtype=torch.int32),
                     torch.zeros(1, 2, 3, 4), 32),
                 lambda: kernels.interpolate_backward(
                     torch.zeros(1, 32, 3, dtype=torch.int32),
                     torch.zeros(1, 32, 3), torch.zeros(1, 32, 4), 8)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert all(v == 0 for v in kernels.launches.values())
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.farthest_point_sample(torch.empty(1, 8, 3, device="meta"), 2)


def test_plain_context_is_scoped():
    assert not getattr(tops._state, "plain", False)
    with tops.plain():
        assert tops._state.plain
        with tops.plain():
            pass
        assert tops._state.plain
    assert not tops._state.plain
