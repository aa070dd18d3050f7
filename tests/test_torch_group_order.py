"""What the group kernels' card tests rest on, checked on the CPU with no
JAX step.

``csrc/group_backward.cu`` sums each source row's cotangent rows in f32 in
ascending row order r = s*K + k, from 0.0, with no atomics, so it is bitwise
``core.group_points_backward`` run on the CPU: that holds only while the CPU
``scatter_add_`` is that sequential sum, which is pinned here against a
numpy loop. The launch geometry the wrappers hand the two kernels
(``kernels.group_geometry``, ``kernels.group_backward_tiles``) is computed
in Python and checked here: the forward's multiply-high division exactly,
over every position of a block's span for every width up to 4096, and the
backward's tiles against the limits the kernel assumes."""

import numpy as np
import pytest
import torch

from tumseg_torch.ops import core, kernels

SMS = kernels.SMS


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), as f32, by its bits."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _sequential(idx: np.ndarray, g: np.ndarray, n: int) -> np.ndarray:
    """dsrc[b, idx[b, r]] += g[b, r] for r = 0, 1, ... in f32 from 0.0;
    indices outside [0, n) add nothing."""
    B, S, K = idx.shape
    flat_idx = idx.reshape(B, S * K)
    flat_g = g.reshape(B, S * K, -1)
    out = np.zeros((B, n, flat_g.shape[-1]), np.float32)
    for b in range(B):
        for r in range(S * K):
            j = flat_idx[b, r]
            if 0 <= j < n:
                out[b, j] = out[b, j] + flat_g[b, r]
    return out


def _sa2_like(rng, B=2, N=256, S=64, K=32, C=67):
    """An sa2-like backward input: sentinels, balls padded with repeats,
    one row that many balls hold, and one batch row on a single source."""
    idx = rng.integers(0, N, (B, S, K)).astype(np.int32)
    idx[:, ::7] = N                    # empty balls
    idx[:, :, 5] = N                   # a sentinel inside every ball
    idx[:, 1::7, 8:] = idx[:, 1::7, :1]  # short balls padded with repeats
    idx[:, 2::3, 0] = 3                # one row that many balls hold
    idx[-1] = N // 2                   # a bucket of length S*K
    g = (rng.standard_normal((B, S, K, C)) * 10.0 ** rng.integers(
        -3, 3, (B, S, K, 1))).astype(np.float32)
    return idx, g, N


@pytest.mark.parametrize("fast,grad_dtype", [
    (False, torch.float32), (True, torch.float32), (True, torch.bfloat16)])
def test_cpu_group_backward_is_the_ascending_sequential_sum(fast,
                                                            grad_dtype):
    idx, g, n = _sa2_like(np.random.default_rng(21))
    grad = torch.from_numpy(g).to(grad_dtype)
    operand = grad.float().numpy()
    if fast:
        operand = _bf16_round(operand)
    got = core.group_points_backward(torch.from_numpy(idx), grad, n,
                                     fast=fast)
    assert got.dtype == torch.float32
    want = _sequential(idx, operand, n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # with one thread, and so with any split of the work across threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = core.group_points_backward(torch.from_numpy(idx), grad, n,
                                         fast=fast)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(one, got)


def test_bf16_round_matches_torch():
    a = np.random.default_rng(22).standard_normal(100_000).astype(np.float32)
    a[:4] = [0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8]  # ties
    want = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(_bf16_round(a).view(np.uint32),
                                  want.view(np.uint32))


def _span_positions(per_block, C):
    return np.arange(per_block * C, dtype=np.uint64)


@pytest.mark.parametrize("widths", [range(3, 1024), range(1024, 4097)],
                         ids=["C<1024", "1024<=C<=4096"])
def test_group_magic_division_is_exact(widths):
    """Every position t of a full block's span splits into (t // C, t % C)
    by the kernel's multiply-high, for every width the model and its
    variants can give a group (sa1 9 to MSG sa4 515, and beyond)."""
    for C in widths:
        per_block, magic = kernels.group_geometry(10 ** 7, C)
        assert magic != 0, C
        t = _span_positions(per_block, C)
        np.testing.assert_array_equal((t * np.uint64(magic)) >> np.uint64(32),
                                      t // np.uint64(C), err_msg=f"C={C}")


@pytest.mark.parametrize("C", [3, 9, 67, 99, 131, 259, 515, 5000, 65535,
                               65536, 70000, 10 ** 6])
def test_group_geometry_limits(C):
    """A block stages at most GROUP_MAX_ROWS rows and aims at
    GROUP_BLOCK_ELEMENTS outputs; the multiply-high is used only where its
    largest t meets t * C < 2^32 (past that the kernel divides)."""
    for rows in (1, 7, 512, 32 * 1024 * 32, 10 ** 7):
        per_block, magic = kernels.group_geometry(rows, C)
        assert 1 <= per_block <= kernels.GROUP_MAX_ROWS
        assert per_block <= max(1, -(-kernels.GROUP_BLOCK_ELEMENTS // C))
        blocks = -(-rows // per_block)
        assert per_block == 1 or blocks >= 2 * SMS
        last = per_block * C - 1
        if magic:
            assert magic == 2 ** 32 // C + 1 and last * C < 2 ** 32
            assert (last * magic) >> 32 == last // C
        else:
            assert last * C >= 2 ** 32


def test_group_geometry_rejects_narrow_rows():
    with pytest.raises(ValueError, match="C >= 3"):
        kernels.group_geometry(100, 2)


@pytest.mark.parametrize("C", [1, 3, 9, 67, 131, 259, 1100, 6144, 9000,
                               20000])
def test_group_backward_tiles(C):
    """T is a power of two up to GROUP_BWD_MAX_ROWS, the accumulator T x CT
    fits GROUP_BWD_MAX_ACC, CT is C or the widest slice that fits, and T is
    the largest such that still gives each SM two blocks and is below 2N."""
    for B in (1, 2, 16, 32):
        for N in (1, 3, 64, 77, 256, 1000, 1024, 4096):
            T, CT = kernels.group_backward_tiles(B, N, C)
            assert CT == min(C, kernels.GROUP_BWD_MAX_ACC)
            assert T & (T - 1) == 0 and 1 <= T <= kernels.GROUP_BWD_MAX_ROWS
            assert T * CT <= kernels.GROUP_BWD_MAX_ACC

            def fits(t):
                return (t * CT <= kernels.GROUP_BWD_MAX_ACC and t < 2 * N
                        and B * -(-N // t) * -(-C // CT) >= 2 * SMS)

            assert T == 1 or fits(T), (B, N, T)
            assert T == kernels.GROUP_BWD_MAX_ROWS or not fits(2 * T), (B, N)


def test_group_backward_tiles_on_the_main_path():
    """The B=16 step's sa2-sa4 and the wide path."""
    assert kernels.group_backward_tiles(16, 1024, 67) == (32, 67)
    assert kernels.group_backward_tiles(16, 256, 131) == (8, 131)
    assert kernels.group_backward_tiles(16, 64, 259) == (2, 259)
    assert kernels.group_backward_tiles(16, 1000, 1100) == (4, 1100)
    assert kernels.group_backward_tiles(1, 40, 9000) == (1, 6144)
