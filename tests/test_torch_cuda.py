"""The CUDA kernels against their plain PyTorch versions on the card, at
small and ragged shapes (chip_smoke.py covers the model's full shapes).
They need an NVIDIA GPU and skip without one; this file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q

Indices and grouping must be identical (the z-window 3-NN's distances and
exact interpolation too, bit for bit, also on
``tumseg_torch.tools.three_nn_probe.window_cases()``; the ball queries also
on tests/test_torch_ball_query.py's inputs, walked and scanned, and at B=32
at every stage, and the fused ball query + group there too, in both
modes); the interpolation agrees within rtol 1e-5 / atol 1e-6. The
group backward sums each source row in ascending row order with no atomics,
so in both modes it is bitwise the plain version run on the CPU (what
tests/test_torch_group_order.py pins that to) and bitwise itself across
runs. So is the interpolation backward, which sums each source row in
ascending entry order 3n + k with no atomics
(tests/test_torch_interp_backward.py pins the CPU version to that sum), in
both modes, on the adversarial inputs of
``tumseg_torch.tools.interp_backward_probe`` at several tiles and at
fp1-fp4 of a B=16 step.

The fast (single-pass bf16) modes: the group's bf16 output and the fused
ball query + group (against the split kernels and its plain version, both
modes) bit for bit; the interpolations within rtol 1e-5 / atol 1e-6 (their
operands are bf16, so the products are exact and the f32 sums rarely
round).

BatchNorm + ReLU (csrc/batch_norm.cu): the apply bitwise the eager chain
at every (M, C) of the SSG, MSG and PointNet forwards at B=32 and B=16,
ReLU on and off, f32 and bf16 stores; ``BatchNormReLU``'s output, running
stats and gradients bitwise the eager chain's and autograd's; two runs and
a captured training step bitwise their eager calls; the launches of a
forward and of a step."""

import contextlib

import numpy as np
import pytest
import torch

from tumseg_torch import ops
from tumseg_torch.ops import core, kernels
from tumseg_torch.tools import ball_query_probe as bq_probe
from tumseg_torch.tools import interp_backward_probe as ib_probe
from tumseg_torch.tools import three_nn_probe as tn_probe


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(rng, shape, device):
    return torch.as_tensor(rng.random(shape).astype(np.float32),
                           device=device)


def _fps_points(kind, rng, B, N):
    """[B, N, 3] f32: "random" in the unit cube; "lattice" a 4 x 4 x 4
    integer lattice drawn with repeats (exact distances, ties everywhere);
    "equal" one point N times; "dup_far" random with the farthest corner
    at three indices; "facade" 1 m x 1 m x 10 m columns, 70% on a wall."""
    if kind == "lattice":
        return rng.integers(0, 4, (B, N, 3)).astype(np.float32)
    if kind == "equal":
        return np.full((B, N, 3), 0.375, dtype=np.float32)
    if kind == "facade":
        wall = rng.random((B, N)) < 0.7
        return np.stack([rng.uniform(-0.5, 0.5, (B, N)),
                         np.where(wall, rng.normal(0.0, 0.02, (B, N)),
                                  rng.uniform(-0.5, 0.5, (B, N))),
                         rng.uniform(0.0, 10.0, (B, N))], -1).astype(
                             np.float32)
    xyz = rng.random((B, N, 3)).astype(np.float32)
    if kind == "dup_far":
        xyz[:, [N // 3, N // 2, N - 1]] = 4.0
    return xyz


def _fps_key(n):
    threads, points = kernels.fps_geometry(n)
    return points, threads > 512   # past 512 threads, coordinates in smem


def _fps_boundaries():
    """Each N at which kernels.fps_geometry changes the points a thread
    owns or the kernel's instance, with N - 1 and N + 1."""
    found, prev = set(), _fps_key(1)
    for n in range(2, kernels.FPS_MAX_N + 1):
        cur = _fps_key(n)
        if cur != prev:
            found |= {n - 1, n, n + 1}
        prev = cur
    return sorted(n for n in found if 1 <= n <= kernels.FPS_MAX_N)


FPS_CASES = (
    [("random", B, N, npoint) for B, N, npoint in
     [(2, 500, 130), (3, 100, 130), (1, 4100, 37), (2, 31, 8)]]
    + [("lattice", 2, 500, 130), ("lattice", 3, 4096, 300),
       ("equal", 2, 100, 20), ("dup_far", 2, 300, 50),
       ("dup_far", 2, 4096, 64),
       ("random", 2, 40, 64), ("lattice", 1, 20, 50),       # npoint > N
       ("random", 3, 1, 5), ("random", 1, kernels.FPS_MAX_N, 40),
       ("lattice", 1, kernels.FPS_MAX_N, 40), ("random", 64, 1000, 64),
       ("facade", 32, 4096, 1024), ("facade", 32, 1024, 256),  # sa1-sa4
       ("facade", 32, 256, 64), ("facade", 32, 64, 16)]
    + [("random", 2, n, 40) for n in _fps_boundaries()])


@pytest.mark.parametrize("kind,B,N,npoint", FPS_CASES)
def test_fps(cuda, kind, B, N, npoint):
    """Bitwise the plain version run on CPU copies, with start 0, random
    starts and start N - 1, and the same over three runs of one call."""
    rng = np.random.default_rng(0)
    xyz = torch.as_tensor(_fps_points(kind, rng, B, N), device=cuda)
    for start in (None, rng.integers(0, N, B), np.full(B, N - 1)):
        if start is not None:
            start = torch.as_tensor(start.astype(np.int32), device=cuda)
        want = core.farthest_point_sample(
            xyz.cpu(), npoint, None if start is None else start.cpu())
        for _ in range(3):
            got = kernels.farthest_point_sample(xyz, npoint, start)
            assert got.dtype == torch.int32 and got.shape == (B, npoint)
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("B,N,S,K,r", [(2, 500, 130, 32, 0.15),
                                       (1, 77, 5, 40, 0.5),
                                       (2, 1000, 64, 8, 0.05)])
def test_ball_query_and_group(cuda, B, N, S, K, r):
    rng = np.random.default_rng(1)
    xyz = _rand(rng, (B, N, 3), cuda)
    new_xyz = _rand(rng, (B, S, 3), cuda)
    new_xyz[:, 0] = 50.0  # an empty ball
    idx = kernels.query_ball_point(r, K, xyz, new_xyz)
    assert torch.equal(idx, core.query_ball_point(r, K, xyz, new_xyz))
    assert (idx[:, 0] == N).all()
    src = torch.cat([xyz, _rand(rng, (B, N, 5), cuda)], dim=-1)
    assert torch.equal(kernels.group_points(idx, src, new_xyz),
                       core.group_points(idx, src, new_xyz))


@pytest.mark.parametrize("B,N,S,radii,Ks", [
    (2, 500, 130, (0.1, 0.2), (16, 32)),
    (1, 77, 5, (0.5, 0.05, 0.3, 0.2), (40, 3, 8, 1)),  # unsorted, K > N
    (2, 1000, 64, (0.2, 0.05), (8, 16))])
def test_ball_query_multi(cuda, B, N, S, radii, Ks):
    """One launch for all radii; each output equals the plain multi-radius
    query and the single-radius kernel of its radius."""
    rng = np.random.default_rng(6)
    xyz = _rand(rng, (B, N, 3), cuda)
    new_xyz = _rand(rng, (B, S, 3), cuda)
    new_xyz[:, 0] = 50.0  # an empty ball
    kernels.reset_launches()
    got = kernels.query_ball_point_multi(radii, Ks, xyz, new_xyz)
    assert kernels.launches["ball_query_multi"] == 1
    want = core.query_ball_point_multi(radii, Ks, xyz, new_xyz)
    for r, k, g, w in zip(radii, Ks, got, want):
        assert g.shape == (B, S, k) and g.dtype == torch.int32
        assert torch.equal(g, w)
        assert torch.equal(g, kernels.query_ball_point(r, k, xyz, new_xyz))
        assert (g[:, 0] == N).all()


BALL_CASES = {name: case for name, *case in bq_probe.adversarial_cases()}


def _ball_query_all_ways(xyz, new_xyz, radii, ks):
    """The wrappers, and the kernels at the geometry's Q with the tile
    walked and scanned and with a warp a query, bitwise the plain version
    of each radius."""
    x = torch.as_tensor(xyz, device="cuda")
    q = torch.as_tensor(new_xyz, device="cuda")
    want = core.query_ball_point_multi(radii, ks, x, q)
    for r, k, w in zip(radii, ks, want):
        assert torch.equal(kernels.query_ball_point(r, k, x, q), w), r
    for g, w in zip(kernels.query_ball_point_multi(radii, ks, x, q), want):
        assert torch.equal(g, w)
    Q, L, tile, walk = kernels.ball_query_geometry(*x.shape[:2], q.shape[1],
                                                   len(ks))
    for geometry in ((Q, L, tile, walk), (Q, L, tile, 1 - walk),
                     (Q, 32, tile, walk)):
        for msg in (False, True):
            if not msg and len(radii) > 1:
                continue
            got = bq_probe.query(x, q, radii, ks, geometry, msg)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (geometry, msg)


@pytest.mark.parametrize("name", sorted(BALL_CASES))
def test_ball_query_adversarial(cuda, name):
    """tests/test_torch_ball_query.py's adversarial inputs: |dz| = r and an
    ulp either side, one z, duplicates, empty and overfull balls, N past a
    tile and at FPS_MAX_N, few queries, unsorted radii R = 1-4."""
    _ball_query_all_ways(*BALL_CASES[name])


@pytest.mark.parametrize("msg", [False, True])
@pytest.mark.parametrize("B", [2, 32])
@pytest.mark.parametrize("stage", range(4))
def test_ball_query_stages(cuda, stage, B, msg):
    """sa1-sa4 of the SSG and MSG forwards on facade blocks, at the CPU
    tests' B=2 and the forward's B=32."""
    _ball_query_all_ways(*bq_probe.stage_inputs(B, stage, msg=msg))


def test_ball_query_multi_refuses_bad_inputs(cuda):
    xyz = torch.rand(1, 64, 3, device=cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="1 to 4 radii"):
        kernels.query_ball_point_multi((0.1,) * 5, (4,) * 5, xyz, xyz)
    with pytest.raises(ValueError, match="1 to 4 radii"):
        kernels.query_ball_point_multi((), (), xyz, xyz)
    with pytest.raises(ValueError, match="nsample"):
        kernels.query_ball_point_multi((0.1, 0.2), (4, 0), xyz, xyz)
    with pytest.raises(ValueError, match="nsamples"):
        kernels.query_ball_point_multi((0.1, 0.2), (4,), xyz, xyz)
    with pytest.raises(TypeError):
        kernels.query_ball_point_multi((0.1,), (4,), xyz.double(), xyz)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.query_ball_point_multi((0.1,), (4,), xyz, xyz[:, ::2])
    with pytest.raises(ValueError, match="shape"):
        kernels.query_ball_point_multi((0.1,), (4,), xyz, xyz[None])
    assert sum(kernels.launches.values()) == 0
    # through ops: one launch for any number of radii, none under plain()
    ops.query_ball_point_multi((0.1, 0.2), (4, 8), xyz, xyz)
    ops.query_ball_point_multi((0.1,), (4,), xyz, xyz)
    with ops.plain():
        ops.query_ball_point_multi((0.1, 0.2), (4, 8), xyz, xyz)
    assert kernels.launches["ball_query_multi"] == 2
    assert kernels.launches["ball_query"] == 0


def test_msg_forward_kernels_match_plain(cuda):
    """The MSG forward with the kernels against ops.plain() on the card,
    and the launches of one forward."""
    from tumseg_torch.models.pointnet2_sem_seg_msg import get_model
    from tumseg_torch.nn.layers import calibrate_batch_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(7)
    x = _rand(rng, (2, 2048, 6), cuda)
    torch.manual_seed(0)
    model = get_model(8).to(cuda).eval()
    calibrate_batch_norm(model, x)
    kernels.reset_launches()
    with torch.inference_mode():
        got = model(x)[0]
        counts = dict(kernels.launches)
        with ops.plain():
            want = model(x)[0]
    assert counts == {"fps": 4, "ball_query": 0, "ball_query_multi": 4,
                      "group": 12, "three_nn_interpolate": 4,
                      "group_backward": 0, "interpolate_backward": 0,
                      "three_nn_window": 0, "fused_ball_group": 0,
                      "bn_apply": 34, "bn_backward_terms": 0,
                      "bn_backward_dx": 0}
    assert sum(kernels.launches.values()) == sum(counts.values())
    assert (got - want).abs().max().item() <= 1e-4
    assert (got.argmax(-1) == want.argmax(-1)).float().mean().item() >= 0.999


def _three_nn_inputs(rng, B, N, S, D, kind, misaligned, device):
    """xyz1, xyz2, points2 for the 3-NN kernel: "random" in the unit cube
    with source 2 repeating source 1 (a distance tie), "lattice" a 4 x 4 x 4
    integer lattice drawn with repeats (ties everywhere); ``misaligned``
    stores points2 one float past a 16-byte boundary (contiguous, rows not
    16-byte aligned)."""
    if kind == "lattice":
        xyz1, xyz2 = (torch.as_tensor(rng.integers(0, 4, (B, n, 3)).astype(
            np.float32), device=device) for n in (N, S))
    else:
        xyz1 = _rand(rng, (B, N, 3), device)
        xyz2 = _rand(rng, (B, S, 3), device)
        xyz2[:, 2] = xyz2[:, 1]
    p2 = torch.as_tensor(rng.standard_normal((B, S, D)).astype(np.float32),
                         device=device)
    if misaligned:
        store = torch.empty(B * S * D + 1, device=device)
        p2 = store[1:].view(B, S, D).copy_(p2)
        assert p2.is_contiguous() and p2.data_ptr() % 16 == 4
    return xyz1, xyz2, p2


# (B, N, S, D, kind, misaligned): fp1-fp4 at B=2; N not a multiple of the
# query tile (at B=2 and at fp1's B=32 tile of 256); S = 3; S past the
# kernel's source tile of 1024; D from 1 to 512; misaligned rows; ties
THREE_NN_CASES = [
    (2, 4096, 1024, 128, "random", False), (2, 1024, 256, 256, "random", False),
    (2, 256, 64, 256, "random", False), (2, 64, 16, 512, "random", False),
    (2, 4095, 1024, 128, "lattice", False), (32, 4059, 1024, 128, "random",
                                             False),
    (2, 1001, 256, 256, "random", True), (2, 61, 16, 512, "lattice", True),
    (2, 500, 130, 40, "random", False), (2, 500, 130, 40, "random", True),
    (1, 70, 3, 7, "random", False), (2, 77, 3, 1, "lattice", False),
    (2, 300, 300, 1, "random", False), (2, 255, 64, 128, "lattice", True),
    (2, 300, 2100, 40, "random", False), (1, 129, 1500, 256, "lattice",
                                          True)]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("B,N,S,D,kind,misaligned", THREE_NN_CASES)
def test_three_nn_interpolate(cuda, B, N, S, D, kind, misaligned, fast):
    """Indices and distances identical to the plain version, out within
    rtol 1e-5 / atol 1e-6 (and printed: bitwise or not; the operations and
    their order are the plain version's, so it should be)."""
    rng = np.random.default_rng(2)
    xyz1, xyz2, p2 = _three_nn_inputs(rng, B, N, S, D, kind, misaligned,
                                      cuda)
    dk, ik, ok = kernels.three_nn_interpolate(xyz1, xyz2, p2, fast)
    dp, ip, op = core.three_nn_interpolate(xyz1, xyz2, p2, fast)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-6)
    print(f"three_nn_interpolate B={B} N={N} S={S} D={D} {kind} "
          f"misaligned={misaligned} fast={fast} "
          f"{kernels.three_nn_geometry(B, N, D)}: out bitwise "
          f"{torch.equal(ok, op)}")


def _backward_case(rng, B, N, S, K, C, device):
    """Indices in [0, N] with an all-sentinel ball, a short ball padded with
    repeats, one source row that every group holds and, where B > 1, one
    batch row whose every index is one source row (a bucket of S*K rows);
    cotangents over five decades, so the order of the sums shows."""
    idx = rng.integers(0, N + 1, (B, S, K)).astype(np.int32)
    idx[:, 0] = N
    idx[:, 1, 2:] = idx[:, 1, 1:2]
    idx[:, 1:, 0] = N // 2
    if B > 1:
        idx[-1] = N - 1
    g = (rng.standard_normal((B, S, K, C))
         * 10.0 ** rng.integers(-3, 3, (B, S, K, 1))).astype(np.float32)
    return torch.as_tensor(idx, device=device), torch.as_tensor(g,
                                                                device=device)


def _backward_runs(idx, g, N, fast=False):
    """Three kernel runs, each into memory a NaN-filled tensor of the same
    size left in the caching allocator (the kernel writes every element):
    -> (first run, the plain version on the CPU); raises unless all three
    runs are bitwise equal."""
    runs = []
    for _ in range(3):
        stale = torch.full((g.shape[0], N, g.shape[-1]), float("nan"),
                            device=g.device)
        del stale
        runs.append(kernels.group_points_backward(idx, g, N, fast=fast))
    for again in runs[1:]:
        assert torch.equal(again, runs[0])
    return runs[0], core.group_points_backward(idx.cpu(), g.cpu(), N,
                                               fast=fast)


@pytest.mark.parametrize("B,N,S,K,C", [
    (2, 77, 19, 32, 35), (1, 1000, 64, 8, 1), (3, 31, 5, 40, 67),
    (2, 300, 40, 32, 3), (2, 130, 16, 32, 9), (2, 64, 16, 32, 259),
    (16, 1024, 256, 32, 67),   # sa2 of a B=16 step
    (16, 1000, 20, 8, 1100),   # the narrow tile: 4 rows of 1100 columns
    (2, 40, 6, 8, 9000)])      # wider than the accumulator: column slices
def test_group_backward(cuda, B, N, S, K, C):
    """Bitwise the plain version on the CPU and itself across runs, at
    ragged N, the model's widths and wider ones, with sentinels, repeats,
    one row every group holds and a bucket of length S*K."""
    idx, g = _backward_case(np.random.default_rng(3), B, N, S, K, C, cuda)
    kernels.reset_launches()
    got, want = _backward_runs(idx, g, N)
    assert kernels.launches["group_backward"] == 3
    assert got.dtype == torch.float32 and got.shape == (B, N, C)
    assert torch.equal(got.cpu(), want)


def _interp_backward_bitwise(idx, w, g, S, fast, tiles=None):
    """Three kernel runs (through the wrapper, or at ``tiles``), each into
    memory a NaN-filled tensor of the same size left in the caching
    allocator (the kernel writes every element): all three bitwise equal
    to each other and to the plain version run on the CPU."""
    runs = []
    for _ in range(3):
        stale = torch.full((g.shape[0], S, g.shape[-1]), float("nan"),
                           device=g.device)
        del stale
        runs.append(kernels.interpolate_backward(idx, w, g, S, fast=fast)
                    if tiles is None else
                    ib_probe.backward_at(idx, w, g, S, tiles, fast))
    for again in runs[1:]:
        assert torch.equal(again, runs[0])
    want = core.interpolate_backward(idx.cpu(), w.cpu(), g.cpu(), S,
                                     fast=fast)
    assert runs[0].dtype == torch.float32 and runs[0].shape == want.shape
    assert torch.equal(runs[0].cpu(), want), (tiles, fast)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("B,N,S,D", [(2, 500, 130, 40), (1, 70, 3, 7),
                                     (2, 4099, 1024, 128)])
def test_interpolate_backward(cuda, B, N, S, D, fast):
    """Ragged N, S = 3, and one source among the three of every query:
    bitwise the plain version on the CPU and itself across runs."""
    rng = np.random.default_rng(4)
    idx = rng.integers(0, S, (B, N, 3)).astype(np.int32)
    idx[:, :, 0] = S - 1
    w = rng.random((B, N, 3)).astype(np.float32) + 0.01
    w /= w.sum(-1, keepdims=True)
    idx, w = (torch.as_tensor(a, device=cuda) for a in (idx, w))
    g = torch.as_tensor(rng.standard_normal((B, N, D)).astype(np.float32),
                        device=cuda)
    kernels.reset_launches()
    _interp_backward_bitwise(idx, w, g, S, fast)
    assert kernels.launches["interpolate_backward"] == 3
    assert kernels.fast_launches["interpolate_backward"] == 3 * fast


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", sorted(ib_probe.adversarial_cases()))
def test_interpolate_backward_adversarial(cuda, name, fast):
    """A source in every query, three entries of a query on one source, a
    batch row on one source (12288 entries on one row: the kernel's list
    fills and is summed in rounds), S = 3, ragged N, D of 7, 40 and 1024;
    through the wrapper and at ``interp_backward_probe.adversarial_tiles``
    (T = 128 rows, whose list fills, a ragged T, one-slice column tiles,
    each block size)."""
    idx, w, g, S = ib_probe.adversarial_cases()[name]
    idx, w, g = (torch.as_tensor(a, device=cuda) for a in (idx, w, g))
    _interp_backward_bitwise(idx, w, g, S, fast)
    for tiles in ib_probe.adversarial_tiles(*g.shape[:1], S, g.shape[-1]):
        _interp_backward_bitwise(idx, w, g, S, fast, tiles)


@pytest.mark.parametrize("fast", [False, True])
def test_interpolate_backward_stages(cuda, fast):
    """fp1-fp4 of a B=16 facade step and the MSG model's fp4 (D = 1024)."""
    for _, idx, w, g, S in ib_probe.stage_inputs(cuda):
        _interp_backward_bitwise(idx, w, g, S, fast)


def _grads(cuda, backward_plain):
    """Forward through tumseg_torch.ops on the card, then backward, inside
    ops.plain() or not: -> (d src, d points2)."""
    rng = np.random.default_rng(5)
    xyz = _rand(rng, (2, 300, 3), cuda)
    new_xyz = xyz[:, :50].contiguous()
    src = _rand(rng, (2, 300, 9), cuda).requires_grad_()
    idx = kernels.query_ball_point(0.2, 16, xyz, new_xyz)
    p2 = _rand(rng, (2, 50, 24), cuda).requires_grad_()
    grouped = ops.group_points(idx, src, new_xyz)
    out = ops.three_nn_interpolate(xyz, new_xyz, p2)[2]
    loss = (grouped * grouped).sum() + (out * out).sum()
    if backward_plain:
        with ops.plain():
            loss.backward()
    else:
        loss.backward()
    return src.grad, p2.grad


def test_autograd_functions_on_card(cuda):
    """The autograd Functions run the backward kernels on CUDA tensors and
    agree with the plain path; a backward run inside ops.plain() still
    launches the kernels its forward chose (ctx keeps the choice)."""
    kernels.reset_launches()
    d_src, d_p2 = _grads(cuda, backward_plain=False)
    assert kernels.launches["group_backward"] == 1
    assert kernels.launches["interpolate_backward"] == 1
    d_src2, d_p22 = _grads(cuda, backward_plain=True)
    assert kernels.launches["group_backward"] == 2
    assert kernels.launches["interpolate_backward"] == 2
    with ops.plain():
        p_src, p_p2 = _grads(cuda, backward_plain=False)
    assert kernels.launches["group_backward"] == 2
    for got in (d_src, d_src2):
        torch.testing.assert_close(got, p_src, rtol=1e-5, atol=1e-4)
    for got in (d_p2, d_p22):
        torch.testing.assert_close(got, p_p2, rtol=1e-5, atol=1e-4)


def test_wrappers_refuse_bad_inputs_and_count(cuda):
    xyz = torch.rand(1, 64, 3, device=cuda)
    kernels.reset_launches()
    with pytest.raises(TypeError):
        kernels.farthest_point_sample(xyz.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.query_ball_point(0.1, 4, xyz, xyz[:, ::2])
    with pytest.raises(RuntimeError, match="forward-only"):
        kernels.farthest_point_sample(xyz.clone().requires_grad_(), 8)
    with pytest.raises(RuntimeError, match="forward-only"):
        kernels.group_points_backward(
            torch.zeros(1, 4, 2, dtype=torch.int32, device=cuda),
            torch.zeros(1, 4, 2, 3, device=cuda, requires_grad=True), 64)
    with pytest.raises(ValueError, match="shape"):
        kernels.interpolate_backward(
            torch.zeros(1, 64, 3, dtype=torch.int32, device=cuda),
            torch.zeros(1, 64, 2, device=cuda), xyz, 8)
    assert sum(kernels.launches.values()) == 0
    ops.farthest_point_sample(xyz, 8)
    with ops.plain():
        ops.farthest_point_sample(xyz, 8)
    assert kernels.launches["fps"] == 1


def _window_inputs(rng, case, B, N, S, device):
    """Facade-like columns (z over 10 m); "mixed" puts half the sources on
    one z, so some queries fail the window guard; "constant_z" fails all."""
    xyz1 = rng.random((B, N, 3)).astype(np.float32)
    xyz2 = rng.random((B, S, 3)).astype(np.float32)
    xyz1[..., 2] *= 10.0
    xyz2[..., 2] *= 10.0
    if case == "mixed":
        xyz2[:, : S // 2, 2] = 5.0
    elif case == "constant_z":
        xyz1[..., 2] = 2.5
        xyz2[..., 2] = 2.5
    return (torch.as_tensor(xyz1, device=device),
            torch.as_tensor(xyz2, device=device))


@pytest.mark.parametrize("case", ["column", "mixed", "constant_z"])
@pytest.mark.parametrize("B,N,S,D,window,n_tile", [
    (2, 512, 256, 16, 128, 64),       # several blocks share no tile
    (1, 500, 256, 7, 128, 256),       # n_tile falls back to N (ragged)
    (2, 4096, 1024, 128, 384, 256),   # fp1
])
def test_three_nn_window(cuda, case, B, N, S, D, window, n_tile):
    """The window kernel against the plain windowed 3-NN (indices,
    distances and the fused interpolation bitwise) and against itself run
    as the full row kernel."""
    rng = np.random.default_rng(8)
    xyz1, xyz2 = _window_inputs(rng, case, B, N, S, cuda)
    p2 = torch.as_tensor(rng.standard_normal((B, S, D)).astype(np.float32),
                         device=cuda)
    kernels.reset_launches()
    dk, ik, ok = kernels.three_nn_window_interpolate(xyz1, xyz2, p2, window,
                                                     n_tile)
    assert kernels.launches["three_nn_window"] == 1
    dp, ip, op = core.three_nn_window_interpolate(xyz1, xyz2, p2, window,
                                                  n_tile)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    assert torch.equal(ok, op)
    df, i_full = kernels.three_nn_expansion(xyz1, xyz2)
    assert torch.equal(ik, i_full) and torch.equal(dk, df)
    guard = core.window_guard(xyz1, xyz2, window, n_tile)
    if case == "constant_z":
        assert not guard.any()
    elif case == "mixed":
        assert guard.any() and not guard.all()


WINDOW_CASES = {name: case for name, *case in tn_probe.window_cases()}


def _window_check(xyz1, xyz2, p2, fast):
    """The window kernel at a window of 128 where the plain version takes
    one (S % 128 == 0, tiles of 64 queries), else with none: dists and idx
    bitwise the plain windowed and full expansion forms and the kernel's
    own full row; out bitwise in exact mode, within rtol 1e-5 / atol 1e-6
    in the fast mode (and printed: bitwise or not)."""
    S = xyz2.shape[1]
    window = 128 if S % 128 == 0 and S > 128 else S
    kernels.reset_launches()
    dk, ik, ok = kernels.three_nn_window_interpolate(xyz1, xyz2, p2, window,
                                                     64, fast)
    assert kernels.launches["three_nn_window"] == 1
    assert kernels.fast_launches["three_nn_window"] == int(fast)
    dp, ip, op = core.three_nn_window_interpolate(xyz1, xyz2, p2, window, 64,
                                                  fast)
    de, ie = core.three_nn_expansion(xyz1, xyz2)
    df, i_full = kernels.three_nn_expansion(xyz1, xyz2)
    for d, i in ((dp, ip), (de, ie), (df, i_full)):
        assert torch.equal(ik, i) and torch.equal(dk, d)
    if fast:
        torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(ok, op)
    print(f"three_nn_window B, N, S = {tuple(xyz1.shape[:2])}, {S} "
          f"fast={fast}: out bitwise {torch.equal(ok, op)}")
    return dk


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_three_nn_window_adversarial(cuda, name, fast):
    """``three_nn_probe.window_cases()``: facade, mixed, one z, negative
    distances (a third one too), far from the origin, lattice ties, S past
    one tile and two."""
    xyz1, xyz2 = (torch.as_tensor(a, device=cuda)
                  for a in WINDOW_CASES[name])
    rng = np.random.default_rng(17)
    p2 = torch.as_tensor(rng.standard_normal(
        (xyz2.shape[0], xyz2.shape[1], 40)).astype(np.float32), device=cuda)
    dk = _window_check(xyz1, xyz2, p2, fast)
    if name == "negative":
        assert (dk[..., 2] < 0).any()


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("B,N,S,D", [(32, 4096, 1024, 128),   # fp1
                                     (2, 4096, 2048, 64),      # two tiles
                                     (1, 300, 2100, 33)])
def test_three_nn_window_fp1_and_past_tile(cuda, B, N, S, D, fast):
    """Facade blocks at fp1's shape and with S past one source tile, the
    sources the blocks' own points, as FPS picks them."""
    rng = np.random.default_rng(18)
    n = max(N, S)
    pts = torch.as_tensor(_fps_points("facade", rng, B, n), device=cuda)
    pick = torch.as_tensor(np.stack([rng.permutation(n)[:S]
                                     for _ in range(B)]), device=cuda)
    xyz2 = core.index_points(pts, pick).contiguous()
    xyz1 = pts[:, :N].contiguous()
    p2 = torch.as_tensor(rng.standard_normal((B, S, D)).astype(np.float32),
                         device=cuda)
    _window_check(xyz1, xyz2, p2, fast)


@pytest.mark.parametrize("B,N,S", [(2, 300, 77), (1, 70, 3), (3, 4099, 1024)])
def test_three_nn_expansion_row_kernel(cuda, B, N, S):
    rng = np.random.default_rng(9)
    xyz1 = _rand(rng, (B, N, 3), cuda) * 20
    xyz2 = _rand(rng, (B, S, 3), cuda) * 20
    xyz2[:, 2] = xyz2[:, 1]  # a distance tie
    dk, ik = kernels.three_nn_expansion(xyz1, xyz2)
    dp, ip = core.three_nn_expansion(xyz1, xyz2)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)


def test_window_dispatch_launches(cuda):
    """ops.three_nn_interpolate launches the window kernel exactly where
    tumseg takes the window, and the direct-form kernel elsewhere."""
    rng = np.random.default_rng(10)
    xyz1, xyz2 = _window_inputs(rng, "column", 1, 4096, 1024, cuda)
    p2 = torch.zeros(1, 1024, 8, device=cuda)
    kernels.reset_launches()
    with ops.window_enabled():
        ops.three_nn_interpolate(xyz1, xyz2, p2)
        ops.three_nn_interpolate(xyz1[:, :2048].contiguous(), xyz2, p2)
    ops.three_nn_interpolate(xyz1, xyz2, p2)
    assert kernels.launches["three_nn_window"] == 1
    assert kernels.launches["three_nn_interpolate"] == 2


def test_device_reblock_path_matches_host_featurized_pool(cuda):
    """On a small tile: the device path's vote loop, fed the blocks of a
    host-featurized vote, gives the host path's labels; and the device
    re-blocking path serves with every kernel of the forward launched."""
    import tempfile

    from tumseg_torch.data.dataset import TestGridDataset
    from tumseg_torch.data.las import write_las
    from tumseg_torch.infer.voting import InferenceRunner
    from tumseg_torch.models.pointnet2_sem_seg import get_model
    from tumseg_torch.nn.layers import calibrate_batch_norm

    rng = np.random.default_rng(11)
    n = 30000
    xyz = np.stack([rng.uniform(0, 3, n), rng.uniform(0, 1.5, n),
                    rng.uniform(0, 8, n)], 1)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/tile.las"
        write_las(path, xyz, rng.choice([1, 2, 3, 7], n))

        def dataset():
            return TestGridDataset(las_file_list=[path], num_classes=8,
                                   block_points=1024, class8=True,
                                   color=False, seed=0)

        torch.manual_seed(0)
        model = get_model(8).to(cuda).eval()
        calibrate_batch_norm(model, torch.as_tensor(
            dataset()[0][0][:4].astype(np.float32), device=cuda))
        host = InferenceRunner(model, 8, batch_size=4, device=cuda,
                               device_features=False)
        device = InferenceRunner(model, 8, batch_size=4, device=cuda)
        assert device.device_features and device.device_reblock
        ds_host, ds_dev = dataset(), dataset()
        want = host.infer_scene(ds_host, 0, 1)
        idx, offsets = ds_dev.grid_indices(0)   # the same draws as host
        with torch.inference_mode():
            pool = torch.zeros((n + 1) * 8, device=cuda)
            device._vote(device._scene_tensors(ds_dev, 0),
                         torch.as_tensor(idx.astype(np.int32), device=cuda),
                         torch.as_tensor(offsets, device=cuda), pool, 1.0)
            got = device._finish(ds_dev, 0, pool, True)
        assert len(np.unique(want)) > 1
        assert (got == want).mean() >= 0.9999
        kernels.reset_launches()
        labels = device.infer_scene(dataset(), 0, 2)
        assert labels.shape == (n,)
        assert kernels.launches["three_nn_interpolate"] > 0
        assert kernels.launches["three_nn_window"] == 0


def _group_case(rng, B, N, S, K, C, device):
    idx = rng.integers(0, N, (B, S, K)).astype(np.int32)
    idx[:, 0] = N                    # an empty ball
    idx[:, 1, 2:] = idx[:, 1, 1:2]   # a short ball padded with repeats
    src = rng.standard_normal((B, N, C)).astype(np.float32) * 3
    ctr = rng.standard_normal((B, S, 3)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (idx, src, ctr))


@pytest.mark.parametrize("B,N,S,K,C", [(2, 77, 19, 32, 35),
                                       (1, 1000, 64, 8, 3),
                                       (16, 4096, 1024, 32, 9)])  # sa1
def test_group_fast(cuda, B, N, S, K, C):
    idx, src, ctr = _group_case(np.random.default_rng(12), B, N, S, K, C,
                                cuda)
    kernels.reset_launches()
    got = kernels.group_points(idx, src, ctr, fast=True)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, core.group_points(idx, src, ctr, fast=True))
    assert kernels.fast_launches["group"] == 1
    kernels.group_points(idx, src, ctr)
    assert kernels.launches["group"] == 2
    assert kernels.fast_launches["group"] == 1


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("B,N,S,K,C", [
    (2, 50, 40, 1, 3),       # the centroid gather: K = 1
    (2, 77, 19, 3, 5),       # K x C = 15: no span on a 16-byte boundary
    (3, 10, 7, 5, 3),        # N below the span of a block
    (2, 200, 100, 32, 259),  # sa4's width
    (1, 4100, 1030, 1, 3)])  # ragged rows a block
def test_group_shapes(cuda, fast, B, N, S, K, C):
    """The group kernel bitwise its plain version in both modes where the
    vector stores meet ragged spans, with an empty ball (the sentinel reads
    a zero row) and a short ball padded with repeats; gather_rows is the
    K = 1 group with zero centres."""
    idx, src, ctr = _group_case(np.random.default_rng(15), B, N, S, K, C,
                                cuda)
    got = kernels.group_points(idx, src, ctr, fast=fast)
    assert got.dtype == (torch.bfloat16 if fast else torch.float32)
    assert torch.equal(got, core.group_points(idx, src, ctr, fast=fast))
    want = torch.cat([-ctr, ctr.new_zeros(B, S, C - 3)], dim=-1)
    assert torch.equal(got[:, 0, 0], want[:, 0].to(got.dtype))
    if K == 1 and C == 3 and not fast:
        rows = idx[:, :, 0].contiguous()
        assert torch.equal(ops.gather_rows(src, rows),
                           core.gather_rows(src, rows))


@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,N,S,K,C", [(2, 77, 19, 32, 35),
                                       (1, 1000, 64, 8, 1),
                                       (2, 64, 16, 32, 259),
                                       (16, 1024, 256, 32, 67),  # sa2
                                       (16, 1000, 20, 8, 1100)])
def test_group_backward_fast(cuda, grad_dtype, B, N, S, K, C):
    """A bf16 cotangent, and an f32 one that the kernel itself rounds:
    bitwise the plain fast version on the CPU and itself across runs."""
    idx, g = _backward_case(np.random.default_rng(13), B, N, S, K, C, cuda)
    g = g.to(grad_dtype)
    kernels.reset_launches()
    got, want = _backward_runs(idx, g, N, fast=True)
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu(), want)
    assert kernels.fast_launches["group_backward"] == 3
    if grad_dtype == torch.float32:
        exact = kernels.group_points_backward(idx, g, N)
        assert not torch.equal(exact, got)
    else:
        with pytest.raises(TypeError):
            kernels.group_points_backward(idx, g, N)


@pytest.mark.parametrize(
    "B,N,S,D,kind,misaligned",
    [(2, 500, 130, 40, "random", False), (1, 70, 3, 7, "random", False),
     (16, 4096, 1024, 128, "random", False)]  # fp1 of a B=16 step
    + [c for c in THREE_NN_CASES if c[0] == 2 and c[1] in (4096, 1024, 256,
                                                           64, 4095, 61)])
def test_interpolation_fast(cuda, B, N, S, D, kind, misaligned):
    """Both 3-NN kernels' fused interpolation and the backward kernel."""
    rng = np.random.default_rng(14)
    xyz1, xyz2, p2 = _three_nn_inputs(rng, B, N, S, D, kind, misaligned,
                                      cuda)
    g = torch.as_tensor(rng.standard_normal((B, N, D)).astype(np.float32),
                        device=cuda)
    kernels.reset_launches()
    dk, ik, ok = kernels.three_nn_interpolate(xyz1, xyz2, p2, fast=True)
    dp, ip, op = core.three_nn_interpolate(xyz1, xyz2, p2, fast=True)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-6)
    assert (ok - core.three_nn_interpolate(xyz1, xyz2, p2)[2]).abs().max() \
        > 1e-4
    window = S if S % 128 else min(S, 384)
    wk = kernels.three_nn_window_interpolate(xyz1, xyz2, p2, window,
                                             fast=True)[2]
    wp = core.three_nn_window_interpolate(xyz1, xyz2, p2, window,
                                          fast=True)[2]
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-6)
    w = core.interpolation_weights(dk)
    got = kernels.interpolate_backward(ik, w, g, S, fast=True)
    assert torch.equal(got.cpu(), core.interpolate_backward(
        ik.cpu(), w.cpu(), g.cpu(), S, fast=True))
    assert all(kernels.fast_launches[k] == 1 for k in (
        "three_nn_interpolate", "three_nn_window", "interpolate_backward"))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("B,N,S,K,C,r", [(2, 500, 130, 32, 7, 0.15),
                                         (1, 77, 5, 40, 3, 0.5),
                                         (32, 4096, 1024, 32, 9, 0.1)])
def test_fused_ball_group(cuda, fast, B, N, S, K, C, r):
    """Bit for bit the ball-query kernel then the group kernel of the same
    mode, and the plain fused op; with an empty ball and short balls."""
    rng = np.random.default_rng(15)
    xyz = _rand(rng, (B, N, 3), cuda)
    new_xyz = xyz[:, :S].clone()
    new_xyz[:, 0] = 50.0
    src = torch.cat([xyz, torch.as_tensor(rng.standard_normal(
        (B, N, C - 3)).astype(np.float32), device=cuda)], -1)
    kernels.reset_launches()
    grouped, idx = kernels.fused_ball_group(r, K, xyz, new_xyz, src, fast)
    assert kernels.launches["fused_ball_group"] == 1
    assert kernels.fast_launches["fused_ball_group"] == int(fast)
    want_idx = kernels.query_ball_point(r, K, xyz, new_xyz)
    assert torch.equal(idx, want_idx)
    assert torch.equal(grouped, kernels.group_points(want_idx, src, new_xyz,
                                                     fast))
    pg, pi = core.fused_ball_group(r, K, xyz, new_xyz, src, fast)
    assert torch.equal(idx, pi) and torch.equal(grouped, pg)
    assert (idx[:, 0] == N).all()
    short = (idx[..., -1] == idx[..., 0]) & (idx[..., 0] != N)
    assert short.any()


def _fused_check(xyz, new_xyz, r, K, C, fast, seed=0):
    """The fused kernel bitwise the ball-query kernel then the group kernel
    of the same mode, and the plain fused op; -> idx."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(xyz, device="cuda")
    q = torch.as_tensor(new_xyz, device="cuda")
    src = torch.cat([x, torch.as_tensor(rng.standard_normal(
        (x.shape[0], x.shape[1], C - 3)).astype(np.float32),
        device="cuda")], -1)
    kernels.reset_launches()
    grouped, idx = kernels.fused_ball_group(r, K, x, q, src, fast)
    assert kernels.launches["fused_ball_group"] == 1
    want_idx = kernels.query_ball_point(r, K, x, q)
    assert torch.equal(idx, want_idx)
    assert torch.equal(grouped, kernels.group_points(want_idx, src, q, fast))
    pg, pi = core.fused_ball_group(r, K, x, q, src, fast)
    assert torch.equal(idx, pi) and torch.equal(grouped, pg)
    return idx


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("stage", range(4))
def test_fused_ball_group_stages(cuda, stage, fast):
    """sa1-sa4 of the B=32 forward on facade blocks, at the model's widths
    C = 9, 67, 131, 259."""
    xyz, new_xyz, radii, ks = bq_probe.stage_inputs(32, stage)
    _fused_check(xyz, new_xyz, radii[0], ks[0], (9, 67, 131, 259)[stage],
                 fast)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", sorted(
    name for name, case in BALL_CASES.items() if len(case[2]) == 1))
def test_fused_ball_group_adversarial(cuda, name, fast):
    """The single-radius adversarial inputs of the ball queries (ragged N,
    N past a tile and at FPS_MAX_N, empty and overfull balls, |dz| = r and
    an ulp either side), at widths 3, 7 and 35."""
    xyz, new_xyz, radii, ks = BALL_CASES[name]
    for C in (3, 7, 35):
        idx = _fused_check(xyz, new_xyz, radii[0], ks[0], C, fast, seed=C)
    if name == "empty":
        assert (idx[0, 0] == xyz.shape[1]).all()


def test_fused_switch_on_card(cuda):
    """An SSG forward under the fused switch: 4 fused launches, 4 fewer
    ball-query launches, the same log-probs bit for bit."""
    from tumseg_torch.models.pointnet2_sem_seg import get_model

    torch.manual_seed(0)
    model = get_model(8).to(cuda).eval()
    x = _rand(np.random.default_rng(16), (2, 1024, 6), cuda)
    with torch.inference_mode():
        kernels.reset_launches()
        off = model(x)[0]
        split = dict(kernels.launches)
        kernels.reset_launches()
        with ops.fused_group_enabled():
            on = model(x)[0]
    assert torch.equal(on, off)
    assert kernels.launches["fused_ball_group"] == 4
    assert kernels.launches["ball_query"] == split["ball_query"] - 4
    assert kernels.launches["group"] == split["group"] - 4


def test_bench_replay_holds_what_its_program_reads(cuda):
    """``benchutil.captured``'s replay holds the tensors that its program's
    closure reads: once the caller drops them, their memory does not go to
    the next tensors of that size while the replay still reads it."""
    from tumseg_torch.tools import benchutil

    n = 1 << 16
    out = torch.zeros(n, device=cuda)
    x = torch.arange(n, dtype=torch.float32, device=cuda)
    replay = benchutil.captured(cuda, lambda x=x: (out.copy_(x * 2),))
    expected = x * 2
    del x
    others = [torch.full((n,), 7.0, device=cuda) for _ in range(4)]
    out.zero_()
    replay()
    torch.cuda.synchronize()
    assert torch.equal(out, expected)
    assert all(bool((o == 7.0).all()) for o in others)


def test_serving_spans_match_the_graph_counters(cuda, tmp_path):
    """One traced vote run of two scenes on the device re-blocking path:
    one ``tumseg.graphs.drop`` a new scene; as many warm-up, capture and
    replay spans as ``warmups``, ``captures`` and ``replays``; a lock wait
    for each warm-up, capture and upload; one gate upload and one readback
    a scene; an untraced scene records nothing."""
    from tumseg_torch.data.dataset import TestGridDataset
    from tumseg_torch.data.las import write_las
    from tumseg_torch.infer.voting import InferenceRunner
    from tumseg_torch.models.pointnet2_sem_seg import get_model
    from tumseg_torch.utils import profiling as P

    rng = np.random.default_rng(4)
    paths = []
    for i in range(2):
        n = 1200
        xyz = np.stack([2.0 * rng.random(n), rng.uniform(0, 1.0, n),
                        rng.uniform(0, 4.0, n)], 1)
        paths.append(str(tmp_path / f"scene{i}.las"))
        write_las(paths[-1], xyz, rng.choice([1, 2, 3, 7], n))
    ds = TestGridDataset(las_file_list=paths, num_classes=8, block_points=256,
                         class8=True, color=False, seed=0)
    torch.manual_seed(0)
    runner = InferenceRunner(get_model(8), 8, batch_size=4, device=cuda,
                             device_features=True, device_reblock=True)
    P.reset_spans()
    g = runner.graphs
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for scene in (0, 1):
                runner.infer_scene(ds, scene, 2)
        traced = P.span_records()
        warmups, captures, replays = g.warmups, g.captures, g.replays
        runner.infer_scene(ds, 0, 1)
        assert P.span_records() == traced and g.replays > replays
    finally:
        P.reset_spans()
    count = {}
    for r in traced:
        count[r.name] = count.get(r.name, 0) + 1
    assert [r.request for r in traced if r.name == "tumseg.graphs.drop"] \
        == [0, 1]
    assert count["tumseg.graphs.warmup"] == warmups > 0
    assert count["tumseg.graphs.capture"] == captures > 0
    assert count["tumseg.graphs.replay"] == replays > 0
    assert count["tumseg.graphs.run"] == warmups + replays
    assert count["tumseg.lock.wait"] == warmups + captures + 2 * 2
    assert count["tumseg.serve.scene"] == count["tumseg.serve.finish"] == 2
    assert count["tumseg.upload"] == count["tumseg.readback"] == 2



# -------------------------------------------------------- BatchNorm + ReLU

def _bn_shapes(cuda, name, B, N=4096):
    """The (M, C) of every BatchNorm input of model ``name``'s eval forward
    of B blocks of N points, in order, from a forward on the card."""
    import importlib

    from tumseg_torch.nn.layers import BatchNorm

    mod = importlib.import_module(f"tumseg_torch.models.{name}")
    model = mod.get_model(8).to(cuda).eval()
    shapes = []

    def hook(bn, args):
        shapes.append((args[0].numel() // args[0].shape[-1],
                       args[0].shape[-1]))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    x = _rand(np.random.default_rng(0), (B, N, 6), cuda)
    with torch.inference_mode():
        model(x)
    for h in handles:
        h.remove()
    return shapes


BN_LAYERS = {"pointnet2_sem_seg": 22, "pointnet2_sem_seg_msg": 34,
             "pointnet_sem_seg": 16}
BN_KERNELS = ("bn_apply", "bn_backward_terms", "bn_backward_dx")


def _bn_inputs(rng, M, C, cuda):
    """x [M, C] around a channel offset, with exact zeros after the
    normalisation at some entries (x == mean, bias 0), and its constants."""
    x = rng.normal(0.5, 2.0, (M, C)).astype(np.float32)
    mean = rng.normal(0.5, 0.5, C).astype(np.float32)
    inv = rng.uniform(0.2, 2.0, C).astype(np.float32)
    bias = rng.normal(0.0, 0.5, C).astype(np.float32)
    bias[: C // 4] = 0.0
    x[::7, : C // 4] = mean[: C // 4]
    return tuple(torch.as_tensor(a, device=cuda) for a in (x, mean, inv,
                                                           bias))


@pytest.mark.parametrize("B", [32, 16])
@pytest.mark.parametrize("name", sorted(BN_LAYERS))
def test_bn_apply_bitwise_at_model_shapes(cuda, name, B):
    """At every BatchNorm's (M, C) of the forward, ReLU on and off, f32 and
    bf16 stores: bitwise ((x - mean) * inv + bias), relu, .to(dtype)."""
    shapes = _bn_shapes(cuda, name, B)
    assert len(shapes) == BN_LAYERS[name]
    rng = np.random.default_rng(B)
    for M, C in sorted(set(shapes)):
        x, mean, inv, bias = _bn_inputs(rng, M, C, cuda)
        z = (x - mean) * inv + bias
        for relu in (True, False):
            want = torch.relu(z) if relu else z
            for dtype in (torch.float32, torch.bfloat16):
                got = kernels.bn_apply(x, mean, inv, bias, relu, dtype)
                assert got.dtype == dtype
                assert torch.equal(got, want.to(dtype)), (M, C, relu, dtype)


def _bn_both(cuda, shape, relu, train, dtype, misaligned, seed=0):
    """y, the gradients of x, weight and bias and the running stats through
    ops.batch_norm on the card (kernels) and inside ops.plain() (the eager
    chain and autograd), from the same inputs, cotangent and running stats:
    -> (kernels, plain)."""
    rng = np.random.default_rng(seed)
    C, size = shape[-1], int(np.prod(shape))
    base = torch.as_tensor(rng.normal(0.7, 1.5, (size + 1,))
                           .astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(0.0, 1.0, shape).astype(np.float32),
                        device=cuda).to(dtype)
    w, b, rm0, rv0 = (torch.as_tensor(a.astype(np.float32), device=cuda)
                      for a in (rng.uniform(0.5, 1.5, C),
                                rng.normal(0.0, 0.3, C),
                                rng.normal(0.5, 0.2, C),
                                rng.uniform(1.0, 3.0, C)))
    mom = torch.tensor(0.1, dtype=torch.float64, device=cuda)
    keep = torch.tensor(0.9, dtype=torch.float64, device=cuda)
    out = []
    for plain in (False, True):
        x = (base[1:] if misaligned else base[:-1]).view(shape)
        x = x.detach().requires_grad_()
        wp, bp = w.clone().requires_grad_(), b.clone().requires_grad_()
        rm, rv = rm0.clone(), rv0.clone()
        with ops.plain() if plain else contextlib.nullcontext():
            y = ops.batch_norm(x, wp, bp, rm, rv, mom, keep, 1e-5, train,
                               relu=relu, dtype=dtype)
        out.append((y,) + torch.autograd.grad(y, (x, wp, bp), g) + (rm, rv))
    return out


BN_CASES = [(1, 32), (7, 3), (33, 196), (4097, 32), (1000, 1030),
            (300, 1040), (65536, 64), (16, 512), (2, 64, 32, 64),
            (16, 256, 32, 128), (4, 1024, 128), (16, 16, 32, 512)]


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("shape", BN_CASES)
def test_batch_norm_relu_bitwise_autograd(cuda, shape, misaligned):
    """``BatchNormReLU`` in train and eval, ReLU on and off, f32 and bf16
    outputs (a bf16 cotangent then), on ragged and model shapes and a
    misaligned x (the single-channel path): y, the running stats and the
    gradients of x, weight and bias bitwise the eager chain's and
    autograd's (``ops.plain()``)."""
    for train in (True, False):
        for relu in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                got, want = _bn_both(cuda, shape, relu, train, dtype,
                                     misaligned)
                what = f"{shape} train={train} relu={relu} {dtype}"
                for name, a, b in zip(("y", "dx", "dweight", "dbias",
                                       "running_mean", "running_var"),
                                      got, want):
                    assert a.dtype == b.dtype and torch.equal(a, b), \
                        f"{what} {name}"


def test_batch_norm_runs_repeat_bitwise(cuda):
    """Two training forwards and backwards at sa1's widest BatchNorm of a
    B=16 step give the same bits."""
    runs = [_bn_both(cuda, (16, 1024, 32, 64), True, True, torch.float32,
                     False)[0] for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _step(model, x, target, weight):
    """Loss and parameter gradients of one training forward and backward."""
    loss = model.loss(model(x)[0], target, None, weight)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return (loss,) + tuple(grads)


def test_batch_norm_captured_step_bitwise_eager(cuda):
    """An SSG training step (forward, loss, backward) captured as a CUDA
    graph and replayed gives the eager step's loss and gradients bit for
    bit (the running stats move each call and feed nothing of the step);
    the graph's tally holds 22 launches of each BatchNorm kernel."""
    from tumseg_torch.models.pointnet2_sem_seg import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = get_model(8).to(cuda).train()
    rng = np.random.default_rng(3)
    x = _rand(rng, (2, 1024, 6), cuda)
    target = torch.as_tensor(rng.integers(0, 8, (2, 1024)), device=cuda)
    weight = torch.ones(8, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            _step(model, x, target, weight)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with kernels.capturing() as tally, torch.cuda.graph(graph):
        captured = _step(model, x, target, weight)
    eager = _step(model, x, target, weight)
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)
    assert {k: tally[0][k] for k in BN_KERNELS} == dict.fromkeys(
        BN_KERNELS, 22)
    assert tally[2]["batch_norm_plain"] == 0


@pytest.mark.parametrize("name", sorted(BN_LAYERS))
def test_batch_norm_launches_per_forward_and_step(cuda, name):
    """One BatchNorm layer, one launch of each kernel: an eval forward
    launches bn_apply once a layer and nothing else; a training step each
    of the three once a layer; under ops.plain() none, and every layer
    counts in ``plain_calls``."""
    import importlib

    mod = importlib.import_module(f"tumseg_torch.models.{name}")
    torch.manual_seed(0)
    model = mod.get_model(8).to(cuda)
    x = _rand(np.random.default_rng(2), (2, 1024, 6), cuda)
    n = BN_LAYERS[name]
    kernels.reset_launches()
    with torch.inference_mode():
        model.eval()(x)
    assert {k: kernels.launches[k] for k in BN_KERNELS} == {
        "bn_apply": n, "bn_backward_terms": 0, "bn_backward_dx": 0}
    kernels.reset_launches()
    model.train()(x)[0].square().mean().backward()
    assert {k: kernels.launches[k] for k in BN_KERNELS} == dict.fromkeys(
        BN_KERNELS, n)
    assert kernels.plain_calls["batch_norm_plain"] == 0
    kernels.reset_launches()
    with ops.plain(), torch.inference_mode():
        model.eval()(x)
    assert not any(kernels.launches[k] for k in BN_KERNELS)
    assert kernels.plain_calls["batch_norm_plain"] == n


def test_batch_norm_refuses_what_it_does_not_take(cuda):
    """A CUDA input of another dtype raises in ops.batch_norm; the kernel
    wrappers refuse a wrong dtype, shape, layout or an input that requires
    grad, and count nothing."""
    x = torch.rand(64, 8, device=cuda)
    c = torch.rand(8, device=cuda)
    mom = torch.tensor(0.1, dtype=torch.float64, device=cuda)
    kernels.reset_launches()
    for dtype in (torch.float64, torch.bfloat16, torch.float16):
        with pytest.raises(TypeError, match="f32"):
            ops.batch_norm(x.to(dtype), c, c, c.clone(), c.clone(), mom,
                           1 - mom, 1e-5, True)
    with pytest.raises(TypeError):
        kernels.bn_apply(x.double(), c, c, c, True)
    with pytest.raises(TypeError):
        kernels.bn_apply(x, c, c, c, True, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.bn_apply(x.t(), c, c, c, True)
    with pytest.raises(ValueError, match="shape"):
        kernels.bn_apply(x, c[:4], c, c, True)
    with pytest.raises(RuntimeError, match="forward-only"):
        kernels.bn_backward_terms(x, x.clone().requires_grad_(), c, c, c,
                                  True)
    with pytest.raises(TypeError):
        kernels.bn_backward_terms(x.half(), x, c, c, c, True)
    with pytest.raises(ValueError, match="shape"):
        kernels.bn_backward_dx(x, x, c, c[:4])
    assert sum(kernels.launches.values()) == 0
    assert kernels.plain_calls["batch_norm_plain"] == 0
