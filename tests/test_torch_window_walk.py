"""The window 3-NN kernel's design on the CPU (csrc/three_nn.cuh in the
expansion form, launched by csrc/three_nn_window.cu; the card tests in
tests/test_torch_cuda.py hold the kernel itself to the plain version).

- ``three_nn_probe.walk_model(..., form="expansion")``, a numpy model of the
  kernel's search: each tile of sources split into z-slabs, each query
  testing its own slab and walking out, a direction stopping at the first
  non-empty slab whose nearest z gives fl(dz*dz) above d2 plus the slack
  ((1 + qsq) + the largest ssq so far) * 2^-19 that three_nn.cuh derives.
  On ``three_nn_probe.window_cases()`` (facade blocks; half the sources on
  one z; one z for all; expansion distances below 0, the third among them;
  coordinates tens of metres out; lattice ties; S past one tile and two):
  indices and distances identical to ``core.three_nn_expansion`` and to the
  plain windowed 3-NN, and to ``tumseg``'s ``_threenn_kernel`` and
  ``_threenn_window_kernel`` in interpret mode (exact on the lattice; on
  floats within 4 ulps of the largest qsq + ssq, where XLA contracts the
  cross term into FMAs, as tests/test_torch_window.py explains).
- The numpy model of the interpolation tail on the walk's answer: ``out``
  bitwise ``core.three_nn_window_interpolate``'s in both modes.
- The slack's cost: the expansion walk tests within 10% of the direct
  walk's candidates on facade blocks, near and far from the origin.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg_torch.ops import core
from tumseg_torch.tools.three_nn_probe import (interpolation_model,
                                               walk_model, window_cases)

CASES = {name: case for name, *case in window_cases()}


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


def _window(S):
    """The window the cases take where the plain version has one (S a
    multiple of 128 above it), with tiles of 64 queries; else S."""
    return 128 if S % 128 == 0 and S > 128 else S


def _tolerance(xyz1, xyz2):
    """4 ulps of the largest qsq + ssq (tests/test_torch_window.py)."""
    top = (np.square(xyz1).sum(-1).max() + np.square(xyz2).sum(-1).max())
    return 4 * float(np.spacing(np.float32(top)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_expansion_walk_matches_plain(name):
    xyz1, xyz2 = CASES[name]
    dists, idx, tested = walk_model(xyz1, xyz2, "expansion")
    want_d, want_i = core.three_nn_expansion(_t(xyz1), _t(xyz2))
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_array_equal(dists, want_d.numpy())
    B, N, _ = xyz1.shape
    S = xyz2.shape[1]
    assert B * N * 3 <= tested <= B * N * S
    wd, wi = core.three_nn_windowed(_t(xyz1), _t(xyz2), _window(S), 64)
    np.testing.assert_array_equal(idx, wi.numpy())
    np.testing.assert_array_equal(dists, wd.numpy())
    if name == "negative":       # a third distance below 0
        assert (dists[..., 2] < 0).any()
    if name == "one_z":          # nothing to stop on: the full scan
        assert tested == B * N * S


@pytest.mark.parametrize("name", sorted(CASES))
def test_expansion_walk_matches_pallas(name):
    """Against ``_three_nn_impl`` (``_threenn_kernel``, the full row) and,
    where the plain version takes a window, ``_three_nn_windowed_impl``
    (``_threenn_window_kernel`` with its guard and fallback)."""
    from tumseg.ops.pallas.threenn import (_three_nn_impl,
                                           _three_nn_windowed_impl)

    xyz1, xyz2 = CASES[name]
    dists, idx, _ = walk_model(xyz1, xyz2, "expansion")
    S = xyz2.shape[1]
    runs = [_three_nn_impl(jnp.asarray(xyz1), jnp.asarray(xyz2))]
    if _window(S) < S:
        runs.append(_three_nn_windowed_impl(jnp.asarray(xyz1),
                                            jnp.asarray(xyz2), _window(S),
                                            64))
    tol = _tolerance(xyz1, xyz2)
    for pd, pi in runs:
        pd, pi = np.asarray(pd), np.asarray(pi)
        if name == "lattice":    # integer products: exact, FMA or not
            np.testing.assert_array_equal(idx, pi)
            np.testing.assert_array_equal(dists, pd)
            continue
        np.testing.assert_allclose(dists, pd, rtol=0, atol=tol)
        # a mismatch is a rounding tie (its distances the same within the
        # bound): ~1e-3 of the slots far out and at S = 1100, none elsewhere
        mism = idx != pi
        assert mism.mean() < 5e-3
        if mism.any():
            assert np.max(np.abs(dists[mism] - pd[mism])) <= tol


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["facade", "negative", "past_tile_1100"])
def test_expansion_interpolation_model_is_bitwise_plain(name, fast):
    xyz1, xyz2 = CASES[name]
    S = xyz2.shape[1]
    rng = np.random.default_rng(5)
    points2 = rng.standard_normal((xyz2.shape[0], S, 24)).astype(np.float32)
    dists, idx, _ = walk_model(xyz1, xyz2, "expansion")
    got = interpolation_model(dists, idx, points2, fast)
    want = core.three_nn_window_interpolate(_t(xyz1), _t(xyz2), _t(points2),
                                            _window(S), 64, fast)[2]
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("name", ["facade", "far", "past_tile_2100"])
def test_expansion_walk_tests_few_more_than_direct(name):
    """The slack widens the walk by a few candidates a query at most: on
    facade blocks, near and far from the origin, the expansion walk tests
    within 10% of the direct walk's candidates and a small share of S."""
    xyz1, xyz2 = CASES[name]
    _, _, expansion = walk_model(xyz1, xyz2, "expansion")
    _, _, direct = walk_model(xyz1, xyz2, "direct")
    B, N, _ = xyz1.shape
    assert direct <= expansion <= 1.1 * direct
    assert expansion < 0.25 * B * N * xyz2.shape[1]


def test_walk_model_rejects_unknown_form():
    xyz1, xyz2 = CASES["lattice"]
    with pytest.raises(ValueError, match="form"):
        walk_model(xyz1, xyz2, "cosine")
