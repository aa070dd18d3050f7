"""What the interpolation-backward kernel's card tests rest on, checked on
the CPU (one test takes a JAX step).

``csrc/interpolate_backward.cu`` sums, for each source row, the products
w[b, n, k] * g[b, n] of the entries r = 3n + k that name it, each product
rounded to f32 and each sum taken in f32 in ascending r from 0.0, with no
atomics, so it is bitwise ``core.interpolate_backward`` run on the CPU: that
holds only while the CPU ``scatter_add_`` is that sequential sum, which is
pinned here against a numpy loop on the adversarial inputs the card tests
and ``chip_smoke.py`` share
(``tumseg_torch.tools.interp_backward_probe.adversarial_cases``). The tiles
the wrapper hands the kernel (``kernels.interpolate_backward_tiles``) are
checked against the limits the kernel assumes, and the plain version
against ``tumseg``'s Pallas ``_interp_bwd_kernel`` in interpret mode."""

import numpy as np
import pytest
import torch

from tumseg_torch.ops import core, kernels
from tumseg_torch.tools import interp_backward_probe as probe

CASES = probe.adversarial_cases()


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), as f32, by its bits."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _sequential(idx, w, g, S, fast):
    """dp2[b, idx[b, n, k]] += w[b, n, k] * g[b, n] for r = 3n + k = 0, 1,
    ... in f32 from 0.0, each product rounded before it is added."""
    if fast:
        w, g = _bf16_round(w), _bf16_round(g)
    B, N, _ = idx.shape
    out = np.zeros((B, S, g.shape[-1]), np.float32)
    for b in range(B):
        for n in range(N):
            for k in range(3):
                s = idx[b, n, k]
                out[b, s] = out[b, s] + w[b, n, k] * g[b, n]
    return out


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_interpolate_backward_is_the_ascending_sequential_sum(name,
                                                                  fast):
    idx, w, g, S = CASES[name]
    args = (torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(g),
            S)
    got = core.interpolate_backward(*args, fast=fast)
    assert got.dtype == torch.float32 and got.shape == (idx.shape[0], S,
                                                        g.shape[-1])
    want = _sequential(idx, w, g, S, fast)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # with one thread, and so with any split of the work across threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = core.interpolate_backward(*args, fast=fast)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(one, got)


def test_adversarial_cases_hold_what_they_name():
    idx, _, _, S = CASES["source in every query D=40"]
    assert (idx[..., 0] == S - 1).all()
    idx = CASES["three on one D=7"][0]
    assert (idx[:, ::3] == idx[:, ::3, :1]).all()
    idx, _, g, S = CASES["batch row on one source fp1"]
    assert (idx[1] == 17).all() and idx.shape[1] * 3 == 12288 and S == 1024
    assert g.shape[-1] == 128
    assert CASES["S=3 D=7"][3] == 3
    assert CASES["ragged N=4099"][0].shape[1] == 4099
    assert CASES["msg fp4 D=1024"][2].shape[-1] == 1024
    for idx, w, g, S in CASES.values():
        assert idx.dtype == np.int32 and w.dtype == g.dtype == np.float32
        assert 0 <= idx.min() and idx.max() < S


@pytest.mark.parametrize("D", [1, 4, 7, 40, 128, 256, 384, 512, 1000, 1024,
                               3000])
def test_interpolate_backward_tiles(D):
    """The block size is one the kernel is built for; T is a power of two
    up to INTERP_BWD_MAX_ROWS; CT is D or a whole number of
    INTERP_BWD_SLICE-column slices (a warp's item is one slice: the kernel
    refuses any other width). 1024-thread blocks where the items fill
    every warp of one block an SM, with whole rows and the smallest T that
    keeps the grid within one block an SM; else 256-thread blocks of at
    most 8 items, one a warp, and exactly 8 where the rows and slices
    allow."""
    slice_, sms = kernels.INTERP_BWD_SLICE, kernels.SMS
    slices = -(-D // slice_)
    for B in (1, 2, 16, 32):
        for S in (3, 16, 64, 130, 256, 1024, 4096):
            threads, T, CT = kernels.interpolate_backward_tiles(B, S, D)
            assert threads in kernels.INTERP_BWD_THREADS
            assert T & (T - 1) == 0
            assert 1 <= T <= kernels.INTERP_BWD_MAX_ROWS
            assert CT == D or (CT % slice_ == 0 and slice_ <= CT < D)
            items = B * S * slices
            if threads == 1024:
                assert items >= 32 * sms and CT == D
                assert T == kernels.INTERP_BWD_MAX_ROWS or (
                    B * -(-S // T) <= sms)
                assert T == 1 or B * -(-S // (T // 2)) > sms
            else:
                assert items < 32 * sms
                per_block = T * -(-CT // slice_)
                assert per_block <= 8
                assert per_block > 4 or (T == 1 and CT == D)


def test_interpolate_backward_tiles_on_the_main_path():
    """fp1-fp4 of the B=16 step, the MSG model's fp4 and small inputs."""
    tiles = kernels.interpolate_backward_tiles
    assert tiles(16, 1024, 128) == (1024, 128, 128)
    assert tiles(16, 256, 256) == (1024, 32, 256)
    assert tiles(16, 64, 256) == (256, 4, 256)
    assert tiles(16, 16, 512) == (256, 2, 512)
    assert tiles(16, 16, 1024) == (256, 1, 1024)
    assert tiles(1, 3, 7) == (256, 8, 7)
    assert tiles(16, 16, 3000) == (1024, 2, 3000)


def test_plain_matches_pallas_on_three_entries_on_one_source():
    """d points2 of the Pallas interpolation's custom VJP
    (``_interp_bwd_kernel``, in interpret mode) on the adversarial case with
    all three entries of every third query on one source and two on one in
    the next, weights normalised as the 3-NN makes them. Pallas sums a
    query's weights for one source before its product, the port takes each
    entry's product on its own: the two agree within a few f32 ulps."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from tumseg.ops.pallas.interpolate import weighted_interpolate

    idx, _, _, S = CASES["three on one D=7"]
    rng = np.random.default_rng(46)
    B, N, _ = idx.shape
    w = rng.random((B, N, 3)).astype(np.float32) + 0.01
    w /= w.sum(-1, keepdims=True)
    g = rng.standard_normal((B, N, 7)).astype(np.float32)
    pts2 = rng.standard_normal((B, S, 7)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda p: jnp.sum(weighted_interpolate(
            jnp.asarray(idx), jnp.asarray(w), p, fast=False)
            * jnp.asarray(g)))(jnp.asarray(pts2))
    got = core.interpolate_backward(torch.from_numpy(idx),
                                    torch.from_numpy(w), torch.from_numpy(g),
                                    S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
