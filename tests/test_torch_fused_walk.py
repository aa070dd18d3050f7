"""The fused ball query + group kernel's design on the CPU
(csrc/fused_ball_group.cu: the ball-query walk of csrc/ball_query.cuh with
a grouping epilogue; the card tests in tests/test_torch_cuda.py hold the
kernel itself to the split pair and the plain version).

- A model of the kernel: ``ball_query_probe.walk_model`` (z-slabs, stop
  rule, index-order extraction, fill) then ``core.group_points`` of the
  same mode. Equal, indices and grouped tensor bit for bit, to
  ``core.fused_ball_group`` and to ``tumseg``'s ``_make_fused`` in interpret
  mode (both kernel structures at N = 256, one k a grid step at N = 2048,
  where tumseg's cumsum runs in two chunks), exact and fast, on inputs with
  an empty ball, short balls and full ones; and to the plain fused op on
  the ball queries' single-radius adversarial inputs.
- The epilogue's layout: for the geometries ``kernels.fused_geometry``
  gives at sa1-sa4 of the B=32 forward and at ragged shapes, the block's
  [nq, K, C] region is staged in chunks of ``kernels.fused_chunk`` rows
  that fit the shared memory the tile and the masks held, and written as
  16-byte vectors and ragged scalars that cover every element exactly once
  (the span split of csrc/common.cuh's write_grouped_span), each vector
  16-byte aligned; the multiply-high ``magic`` gives t // C for every t of
  a chunk's span where it is not 0.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg_torch.ops import core, kernels
from tumseg_torch.tools.ball_query_probe import adversarial_cases, walk_model

# (N, radius): about 15 candidates a ball, so with K=16 some balls fill and
# some are short (tests/test_torch_fused.py's cases)
CASES = {256: 0.25, 2048: 0.12}
BALL_CASES = {name: case for name, *case in adversarial_cases()
              if len(case[2]) == 1}


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
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(N, S=64, C=7, seed=40):
    """xyz [1, N, 3] in the unit cube, its first query far from every
    point (an empty ball), the others points of the cloud, and src with
    C - 3 feature channels."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((1, N, 3)).astype(np.float32)
    new_xyz = xyz[:, rng.choice(N, S, replace=False)].copy()
    new_xyz[:, 0] = 5.0
    src = np.concatenate([xyz, rng.standard_normal(
        (1, N, C - 3)).astype(np.float32)], axis=-1)
    return xyz, new_xyz, src


def model(r, K, xyz, new_xyz, src, fast):
    """The fused kernel in numpy and the plain group: (grouped, idx)."""
    (idx,), _ = walk_model(xyz, new_xyz, (r,), (K,))
    idx = _t(idx)
    return core.group_points(idx, _t(src), _t(new_xyz), fast), idx


@pytest.mark.parametrize("N,structure", [(256, "gridk"), (256, "unroll"),
                                         (2048, "gridk")])
@pytest.mark.parametrize("fast", [False, True])
def test_model_matches_plain_and_pallas(N, structure, fast):
    from tumseg.ops.pallas.fusedgroup import _make_fused

    K, r = 16, CASES[N]
    xyz, new_xyz, src = _inputs(N)
    grouped, idx = model(r, K, xyz, new_xyz, src, fast)
    pg, pi = core.fused_ball_group(r, K, _t(xyz), _t(new_xyz), _t(src), fast)
    assert torch.equal(idx, pi) and torch.equal(grouped, pg)
    jg, ji = _make_fused(r, K, not fast, structure)(
        jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(src))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_np(grouped), _np(jg))
    idx = idx.numpy()[0]
    assert (idx[0] == N).all()                          # the empty ball
    np.testing.assert_array_equal(_np(grouped)[0, 0, :, :3],
                                  np.broadcast_to(-new_xyz[0, 0], (K, 3)))
    short = (idx[:, -1] == idx[:, 0]) & (idx[:, 0] != N)
    assert short.any() and (idx[:, -1] != idx[:, 0]).any()


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", sorted(BALL_CASES))
def test_model_on_adversarial_inputs(name, fast):
    """|dz| = r and an ulp either side, one z, duplicates, an empty ball,
    overfull balls, N past a tile and at FPS_MAX_N, few queries."""
    xyz, new_xyz, radii, ks = BALL_CASES[name]
    rng = np.random.default_rng(7)
    src = np.concatenate([xyz, rng.standard_normal(
        (*xyz.shape[:2], 4)).astype(np.float32)], axis=-1)
    grouped, idx = model(radii[0], ks[0], xyz, new_xyz, src, fast)
    pg, pi = core.fused_ball_group(radii[0], ks[0], _t(xyz), _t(new_xyz),
                                   _t(src), fast)
    assert torch.equal(idx, pi) and torch.equal(grouped, pg)


def span_cover(base, length, V):
    """csrc/common.cuh's write_grouped_span split of elements [0, length)
    at element ``base`` of the output: -> (the vectors' first elements,
    the scalars)."""
    head = min((V - base % V) % V, length)
    nvec = (length - head) // V
    tail = head + nvec * V
    vectors = head + V * np.arange(nvec)
    scalars = np.concatenate([np.arange(head), np.arange(tail, length)])
    return vectors, scalars


# (B, N, S, K) of sa1-sa4 of the B=32 forward, and ragged shapes
GEOMETRY_CASES = [(32, 4096, 1024, 32), (32, 1024, 256, 32),
                  (32, 256, 64, 32), (32, 64, 16, 32), (2, 500, 130, 32),
                  (1, 77, 5, 40), (3, 5000, 97, 16), (1, 16384, 48, 64)]


@pytest.mark.parametrize("B,N,S,K", GEOMETRY_CASES)
def test_epilogue_covers_each_element_once(B, N, S, K):
    for C in (3, 7, 9, 67, 131, 259, 515):
        Q, L, tile, walk, magic = kernels.fused_geometry(B, N, S, C)
        assert (Q, L, tile, walk) == kernels.ball_query_geometry(B, N, S, 1)
        chunk = kernels.fused_chunk(tile, Q, L)
        # two ints a staged row, in the tile's and the masks' bytes
        assert 8 * chunk <= (kernels.ball_query_smem(tile, Q, L, 1)
                             - 16 * Q)
        assert chunk >= 1
        t = np.arange(chunk * C, dtype=np.uint64)
        if magic:
            np.testing.assert_array_equal((t * np.uint64(magic)) >> 32,
                                          t // C)
        for V in (4, 8):                      # f32, bf16
            for block in range(-(-S // Q)):
                nq = min(Q, S - block * Q)
                first = (B - 1) * S + block * Q      # the last row's
                rows = nq * K
                written = np.zeros(rows * C, np.int64)
                for r0 in range(0, rows, chunk):
                    nr = min(chunk, rows - r0)
                    base = (first * K + r0) * C
                    vectors, scalars = span_cover(base, nr * C, V)
                    assert ((base + vectors) % V == 0).all()
                    for e in range(V):
                        np.add.at(written, r0 * C + vectors + e, 1)
                    np.add.at(written, r0 * C + scalars, 1)
                assert (written == 1).all(), (C, V, block)
