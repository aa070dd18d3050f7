"""The port's z-window 3-NN and its expansion-form fallback against tumseg's
Pallas kernels (``_threenn_window_kernel``, ``_threenn_kernel``) in interpret
mode, on the same numpy inputs, and the dispatch that takes the window.

Tolerance, and why: XLA on the CPU contracts tumseg's cross term into FMAs
(its dot equals an FMA chain bit for bit), while the port rounds every
product, ``(x*x' + y*y') + z*z'``, so that the CUDA kernel, built with
``-fmad=false``, equals the plain version bit for bit. The two roundings of
``(qsq + ssq) - 2*cross`` then differ by a few ulps of ``qsq + ssq``:
distances agree within 4 ulps of the largest ``qsq + ssq`` of the inputs
(1.9e-6 for points in the unit cube, the 2e-6 that tests/test_pallas_ops.py
allows between two 3-NN forms). Indices must be identical; where they are
not, each mismatch must be a rounding tie, its selected distances within the
same tolerance. The windowed plain version must equal the full expansion
form bit for bit: both build each pair's distance with the same arithmetic,
and the guard sends every query whose window could miss a neighbour to the
full form."""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg_torch import ops as tops
from tumseg_torch.ops import core, kernels
from tumseg_torch.ops.autograd import ThreeNNInterpolate


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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops run faster on one thread, and the suite's workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _facade(rng, b, n):
    """[b, n, 3] points of 1 m x 1 m x 10 m columns, 70% on a wall plane."""
    x = rng.uniform(-0.5, 0.5, (b, n))
    y = np.where(rng.random((b, n)) < 0.7, rng.normal(0.0, 0.02, (b, n)),
                 rng.uniform(-0.5, 0.5, (b, n)))
    z = rng.uniform(0.0, 10.0, (b, n))
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def _inputs(case, seed=9):
    """(xyz1 [2, 512, 3], xyz2 [2, 256, 3]) of the shape of
    tests/test_pallas_ops.py's windowed 3-NN tests."""
    rng = np.random.default_rng(seed)
    xyz1 = rng.random((2, 512, 3)).astype(np.float32)
    xyz2 = rng.random((2, 256, 3)).astype(np.float32)
    if case == "constant_z":      # z orders nothing: every query fails
        xyz1[:, :, 2] = 0.25
        xyz2[:, :, 2] = 0.25
    elif case == "mixed":         # half the sources on one z: some tiles fail
        xyz2[:, :128, 2] = 0.5
    return xyz1, xyz2


def _tolerance(xyz1, xyz2):
    """4 ulps of the largest qsq + ssq (see the module docstring)."""
    top = (np.square(xyz1).sum(-1).max() + np.square(xyz2).sum(-1).max())
    return 4 * float(np.spacing(np.float32(top)))


def _assert_same_or_ties(got_d, got_i, want_d, want_i, tol):
    got_d, got_i, want_d, want_i = map(np.asarray,
                                       (got_d, got_i, want_d, want_i))
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=tol)
    mism = got_i != want_i
    assert mism.mean() < 1e-3
    if mism.any():
        assert np.max(np.abs(got_d[mism] - want_d[mism])) <= tol


@pytest.mark.parametrize("B,N,S,ties", [(2, 128, 64, True), (1, 512, 16, False),
                                        (2, 100, 40, True)])
def test_three_nn_expansion_matches_pallas_row_kernel(B, N, S, ties):
    from tumseg.ops.pallas.threenn import _three_nn_impl

    rng = np.random.default_rng(3)
    xyz1 = rng.random((B, N, 3)).astype(np.float32)
    xyz2 = rng.random((B, S, 3)).astype(np.float32)
    if ties:
        xyz2[:, 5] = xyz2[:, 2]   # duplicated sources: exact distance ties
        xyz2[:, 9] = xyz2[:, 2]
        xyz1[:, :4] = xyz2[:, 2:3]
    gd, gi = core.three_nn_expansion(_t(xyz1), _t(xyz2))
    pd, pi = _three_nn_impl(jnp.asarray(xyz1), jnp.asarray(xyz2))
    assert gi.dtype == torch.int32 and gd.shape == (B, N, 3)
    _assert_same_or_ties(gd, gi, pd, pi, _tolerance(xyz1, xyz2))
    if ties:
        np.testing.assert_array_equal(gi.numpy()[:, :4],
                                      np.broadcast_to([2, 5, 9], (B, 4, 3)))


def test_three_nn_expansion_keeps_negative_distances():
    """A query on a source a few metres out cancels to a tiny distance that
    may be negative; tumseg keeps it, and so does the port (no clamp)."""
    from tumseg.ops.pallas.threenn import _three_nn_impl

    rng = np.random.default_rng(4)
    xyz2 = (rng.random((1, 64, 3)) * 8 + 20).astype(np.float32)
    xyz1 = (xyz2 + rng.normal(0, 1e-4, xyz2.shape)).astype(np.float32)
    gd, gi = core.three_nn_expansion(_t(xyz1), _t(xyz2))
    want = core._expansion_sqdist(_t(xyz1), _t(xyz2))
    assert torch.equal(gd[..., 0], want.amin(-1))
    assert (gd[..., 0] < 0).any()  # cancellation below zero, kept
    pd, _ = _three_nn_impl(jnp.asarray(xyz1), jnp.asarray(xyz2))
    np.testing.assert_allclose(gd.numpy(), np.asarray(pd), rtol=0,
                               atol=_tolerance(xyz1, xyz2))


@pytest.mark.parametrize("case,fails", [("random", "some"),
                                        ("constant_z", "all"),
                                        ("mixed", "some")])
def test_three_nn_windowed_matches_pallas(case, fails):
    """(2, 512) x (2, 256), window 128, tiles of 64: against
    _three_nn_windowed_impl, and bitwise against the plain full form."""
    from tumseg.ops.pallas.threenn import _three_nn_windowed_impl

    xyz1, xyz2 = _inputs(case)
    wd, wi = core.three_nn_windowed(_t(xyz1), _t(xyz2), 128, 64)
    pd, pi = _three_nn_windowed_impl(jnp.asarray(xyz1), jnp.asarray(xyz2),
                                     128, 64)
    _assert_same_or_ties(wd, wi, pd, pi, _tolerance(xyz1, xyz2))
    fd, fi = core.three_nn_expansion(_t(xyz1), _t(xyz2))
    assert torch.equal(wi, fi) and torch.equal(wd, fd)
    ok = core.window_guard(_t(xyz1), _t(xyz2), 128, 64)
    assert ok.shape == (2, 512)
    assert {"none": bool(ok.all()), "all": not bool(ok.any()),
            "some": bool(ok.any()) and not bool(ok.all())}[fails]


def test_three_nn_windowed_mixed_input_fails_some_tiles():
    """On the mixed input some query tiles pass the guard entirely and
    others fail it entirely, so tumseg's lax.cond takes the full kernel
    while most of the port's queries keep their window."""
    xyz1, xyz2 = _inputs("mixed")
    ok = core.window_guard(_t(xyz1), _t(xyz2), 128, 64)
    order = core.sort_by_z(_t(xyz1))[1].long()
    per_tile = torch.gather(ok, 1, order).reshape(2, 8, 64)
    assert per_tile.all(-1).any() and (~per_tile).all(-1).any()


def test_three_nn_windowed_at_fp1_shape_on_facade_blocks():
    """One facade block at fp1's shape (4096 queries, 1024 sources, C=384,
    tiles of 256), against the Pallas windowed path."""
    from tumseg.ops.pallas.threenn import _three_nn_windowed_impl

    rng = np.random.default_rng(11)
    xyz1 = _facade(rng, 1, 4096)
    xyz2 = np.ascontiguousarray(xyz1[:, rng.permutation(4096)[:1024]])
    C = tops.three_nn_window(1024)
    assert C == 384
    wd, wi = core.three_nn_windowed(_t(xyz1), _t(xyz2), C, 256)
    pd, pi = _three_nn_windowed_impl(jnp.asarray(xyz1), jnp.asarray(xyz2),
                                     C, 256)
    _assert_same_or_ties(wd, wi, pd, pi, _tolerance(xyz1, xyz2))
    assert core.window_guard(_t(xyz1), _t(xyz2), C, 256).all()
    fd, fi = core.three_nn_expansion(_t(xyz1), _t(xyz2))
    assert torch.equal(wi, fi) and torch.equal(wd, fd)


@pytest.mark.parametrize("N,S,window,n_tile,plan", [
    (512, 256, 128, 64, (128, 64)),
    (4096, 1024, 384, 256, (384, 256)),
    (500, 256, 128, 256, (128, 500)),     # n_tile that does not divide N
    (512, 256, 256, 64, None),            # C == S
    (512, 256, 200, 64, None),            # C % 128 != 0
    (512, 200, 128, 64, None),            # S % 128 != 0
])
def test_window_plan_follows_tumseg(N, S, window, n_tile, plan):
    assert core.window_plan(N, S, window, n_tile) == plan


def test_window_starts_floor_and_clip():
    """Starts are multiples of 128 inside [0, S - C], with the floor of a
    negative centre clipped to 0 (floor division, as jnp's //)."""
    zs = torch.arange(1024, dtype=torch.float32)[None]
    qzs = torch.cat([torch.full((1, 256), -5.0), torch.full((1, 256), 500.0),
                     torch.full((1, 256), 2000.0)], dim=1)
    starts = core.window_starts(zs, qzs, 256, 384)
    assert starts.dtype == torch.int32
    assert starts.tolist() == [[0, 256, 640]]


def test_window_interpolate_is_interpolation_of_windowed():
    rng = np.random.default_rng(5)
    xyz1, xyz2 = _inputs("mixed")
    p2 = _t(rng.standard_normal((2, 256, 16)).astype(np.float32))
    d, i, out = core.three_nn_window_interpolate(_t(xyz1), _t(xyz2), p2, 128,
                                                 64)
    wd, wi = core.three_nn_windowed(_t(xyz1), _t(xyz2), 128, 64)
    assert torch.equal(d, wd) and torch.equal(i, wi)
    assert torch.equal(out, core.interpolate_weighted(wd, wi, p2))


def _spy(monkeypatch):
    calls = []

    def fake(name):
        def run(xyz1, xyz2, points2, *args):
            calls.append((name, args))
            B, N, _ = xyz1.shape
            return (xyz1.new_zeros(B, N, 3),
                    torch.zeros(B, N, 3, dtype=torch.int32),
                    xyz1.new_zeros(B, N, points2.shape[2]))
        return run

    monkeypatch.setattr(core, "three_nn_interpolate", fake("direct"))
    monkeypatch.setattr(core, "three_nn_window_interpolate", fake("window"))
    return calls


@pytest.mark.parametrize("N,S,on,want", [
    (4096, 1024, True, ("window", (384, 256))),
    (4096, 1024, False, ("direct", ())),
    (4095, 1024, True, ("direct", ())),
    (4096, 896, True, ("direct", ())),       # S < 1024
    (4096, 1000, True, ("direct", ())),      # S % 128 != 0
    (8192, 2048, True, ("window", (768, 256))),
])
def test_three_nn_interpolate_takes_window_where_tumseg_does(
        monkeypatch, N, S, on, want):
    calls = _spy(monkeypatch)
    xyz1, xyz2 = torch.zeros(1, N, 3), torch.zeros(1, S, 3)
    with tops.window_enabled(on):
        tops.three_nn_interpolate(xyz1, xyz2, torch.zeros(1, S, 4))
    assert calls == [want]
    calls.clear()
    tops.three_nn_interpolate(xyz1, xyz2, torch.zeros(1, S, 4))
    assert calls == [("direct", ())]  # outside the context: off


def test_window_default_and_context_are_scoped(monkeypatch):
    calls = _spy(monkeypatch)
    xyz1, xyz2, p2 = (torch.zeros(1, 4096, 3), torch.zeros(1, 1024, 3),
                      torch.zeros(1, 1024, 2))
    try:
        tops.set_window(True)
        tops.three_nn_interpolate(xyz1, xyz2, p2)
        with tops.window_enabled(False):
            tops.three_nn_interpolate(xyz1, xyz2, p2)
        seen = []
        worker = threading.Thread(target=lambda: seen.append(
            tops._window_on()))
        with tops.window_enabled(False):
            worker.start()
            worker.join()
        assert seen == [True]  # another thread keeps the process default
    finally:
        tops.set_window(False)
    assert [c[0] for c in calls] == ["window", "direct"]
    assert not tops._window_on()


def test_window_path_gradient_matches_finite_differences():
    """ThreeNNInterpolate with the window, in f64 on the plain path: d
    points2 against central differences (gradcheck's fast mode: one random
    projection of the Jacobian); dists and idx take no gradient."""
    rng = np.random.default_rng(13)
    xyz1, xyz2 = (_t(a.astype(np.float64)) for a in _inputs("mixed"))
    xyz1 = xyz1[:1, :128].contiguous()
    pts2 = _t(rng.standard_normal((1, 256, 3))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda p: ThreeNNInterpolate.apply(xyz1, xyz2[:1], p, core, 128,
                                           64)[2], (pts2,), fast_mode=True)
    d, i, _ = ThreeNNInterpolate.apply(xyz1, xyz2[:1], pts2, core, 128, 64)
    assert not d.requires_grad and not i.requires_grad


def test_window_kernel_wrappers_refuse_cpu_tensors():
    xyz = torch.rand(1, 512, 3)
    before = dict(kernels.launches)
    for call in (lambda: kernels.three_nn_window_interpolate(
                     xyz, xyz[:, :256].contiguous(), torch.zeros(1, 256, 4),
                     128, 64),
                 lambda: kernels.three_nn_expansion(xyz, xyz)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert kernels.launches == before
    assert kernels.launches["three_nn_window"] == 0
