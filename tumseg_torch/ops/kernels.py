"""Python wrappers of the hand-written CUDA kernels (``tumseg_torch/csrc``).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else; rejects inputs that require grad (a wrapper is one forward or
one backward pass: gradients go through the ``torch.autograd.Function``s of
``tumseg_torch.ops.autograd``, which hand the wrappers detached tensors);
allocates its outputs with ``torch.empty`` (every kernel writes each
element of its outputs); launches on the current stream of the input's
device; raises if the launcher returns a CUDA error; and adds one to its
entry of ``launches`` per launch, and a launch in
the fast (single-pass bf16) mode to its entry of ``fast_launches`` as well.
A launch made while a CUDA graph is captured (inside :func:`capturing`)
only records the kernel in the graph: it counts in the graph's own tally,
which :func:`replayed` adds to ``launches`` each time the graph runs, so
the counts are the kernels' runs on the card either way. There is no
fallback: a CUDA tensor either runs the kernel or raises. The
plain versions with the same contracts are in ``tumseg_torch.ops.core``.

``plain_calls["batch_norm_plain"]`` counts the BatchNorms on a CUDA tensor
that ran the plain formula (inside ``ops.plain()`` or on a mesh), through
the same tallies, so that a run shows the main path took the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from tumseg_torch.ops import build

KERNELS = ("fps", "ball_query", "ball_query_multi", "group",
           "three_nn_interpolate", "group_backward", "interpolate_backward",
           "three_nn_window", "fused_ball_group", "bn_apply",
           "bn_backward_terms", "bn_backward_dx")
launches = dict.fromkeys(KERNELS, 0)
# the kernels with a fast mode; its launches also count here
FAST_KERNELS = ("group", "three_nn_interpolate", "group_backward",
                "interpolate_backward", "three_nn_window", "fused_ball_group")
fast_launches = dict.fromkeys(FAST_KERNELS, 0)
PLAIN_CALLS = ("batch_norm_plain",)
plain_calls = dict.fromkeys(PLAIN_CALLS, 0)
_LIVE = (launches, fast_launches, plain_calls)
# the tallies (_LIVE's three) of the CUDA graph being captured, else None
_captured = None

# csrc/fps.cu: one CTA a batch row of at most 1024 threads, each owning up
# to 16 points; the CTA keeps the row's 12-byte coordinates in shared memory
FPS_MAX_N = 16 * 1024
# csrc/ball_query.cuh: radii of one multi-radius launch (kMaxRadii),
# threads a block (kThreads), the sources a block stages at a time (kTile),
# the most z-slabs of a tile (kMaxSlabs) and the sources a slab aims at
# (kSlabSources), the dynamic shared memory a block may take (the 227 KB a
# block may opt in to, less the kernel's static tables); rows of at least
# BALL_QUERY_WALK_N sources are walked through z-slabs, shorter ones
# scanned (retune from tumseg_torch/tools/ball_query_probe.py)
BALL_QUERY_MAX_RADII = 4
BALL_QUERY_THREADS = 1024
BALL_QUERY_TILE = 4096
BALL_QUERY_MAX_SLABS = 512
BALL_QUERY_SLAB_SOURCES = 8
BALL_QUERY_SMEM = 232_448 - (4 * (4 * BALL_QUERY_MAX_SLABS + 1)
                             + 8 * BALL_QUERY_THREADS // 32)
BALL_QUERY_WALK_N = 512
# the card's streaming multiprocessors: the group kernels size their grids
# to give each at least two blocks
SMS = 132
# csrc/group.cu: rows (b, s, k) a block stages in shared memory (kMaxRows),
# and the output elements a block aims at
GROUP_MAX_ROWS = 1024
GROUP_BLOCK_ELEMENTS = 4096
# csrc/group_backward.cu: floats of a block's accumulator tile (kMaxAcc),
# and its most source rows (kMaxTileRows)
GROUP_BWD_MAX_ACC = 6144
GROUP_BWD_MAX_ROWS = 64
# csrc/interpolate_backward.cu: the block sizes it is built for, the most
# source rows a block sums (kMaxTileRows) and the columns a warp sums
# (kSlice)
INTERP_BWD_THREADS = (256, 1024)
INTERP_BWD_MAX_ROWS = 128
INTERP_BWD_SLICE = 128
# csrc/three_nn_interpolate.cu: threads a block (kThreads), most queries a
# block (kMaxQueries), the sources it stages at a time (kTile), the most
# z-slabs of a tile (kMaxSlabs) and the sources a slab aims at
# (kSlabSources)
THREE_NN_THREADS = 256
THREE_NN_MAX_QUERIES = 256
THREE_NN_TILE = 1024
THREE_NN_MAX_SLABS = 128
THREE_NN_SLAB_SOURCES = 8
# csrc/batch_norm.cu: threads a block (kThreads) and the rows a thread
# loads before it stores (kUnroll)
BN_THREADS = 256
BN_UNROLL = 4


class _MultiRadii(ctypes.Structure):
    """``tumseg::MultiRadii`` of csrc/ball_query.cuh, field for field."""
    _fields_ = [("R", ctypes.c_int),
                ("r2", ctypes.c_float * BALL_QUERY_MAX_RADII),
                ("K", ctypes.c_int * BALL_QUERY_MAX_RADII),
                ("out", ctypes.c_void_p * BALL_QUERY_MAX_RADII)]


def reset_launches() -> None:
    for counts in _LIVE:
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def capturing():
    """Counts the launches made inside this block, a CUDA graph's capture
    (the autograd thread's backward launches included), apart from
    ``launches``: yields the graph's (launches, fast_launches, plain_calls)
    tallies."""
    global _captured
    tally = (dict.fromkeys(KERNELS, 0), dict.fromkeys(FAST_KERNELS, 0),
             dict.fromkeys(PLAIN_CALLS, 0))
    prev, _captured = _captured, tally
    try:
        yield tally
    finally:
        _captured = prev


def replayed(tally) -> None:
    """Adds a captured graph's tallies to the counts: one replay runs every
    launch that its capture recorded."""
    for counts, graph in zip(_LIVE, tally):
        for name, n in graph.items():
            counts[name] += n


def count_plain(name: str) -> None:
    """One more call of ``name`` (of ``PLAIN_CALLS``) on the plain path of a
    CUDA tensor, in the tally of the graph being captured if there is one."""
    (_captured or _LIVE)[2][name] += 1


def group_geometry(rows: int, C: int) -> Tuple[int, int]:
    """-> (rows a block of csrc/group.cu gathers, magic) for ``rows`` =
    B*S*K rows of C channels. A block's R rows are ~``GROUP_BLOCK_ELEMENTS``
    outputs, at most ``GROUP_MAX_ROWS``, and fewer where the grid would
    not give each SM two blocks. The kernel splits a position t < R*C of
    its span into (row, c) as ``row = (t * magic) >> 32``: with magic =
    2^32 // C + 1 that equals t // C while t * C < 2^32, which the largest
    t must meet, else magic is 0 and the kernel divides."""
    if C < 3:
        raise ValueError(f"group needs C >= 3, got {C}")
    per_block = max(1, min(-(-GROUP_BLOCK_ELEMENTS // C), GROUP_MAX_ROWS,
                           rows // (2 * SMS)))
    magic = 2 ** 32 // C + 1 if (per_block * C - 1) * C < 2 ** 32 else 0
    return per_block, magic


def fps_geometry(N: int) -> Tuple[int, int]:
    """-> (threads, points) of csrc/fps.cu for a row of N points: a CTA of
    ``threads`` threads (a multiple of 32), thread t owning points j *
    threads + t for j < ``points``, threads x points >= N with less than a
    warp's worth of padding. From the card's sweep
    (tumseg_torch/tools/fps_probe.py): one warp, with no barrier, up to
    N = 128; up to 512 threads of 1 or 2 points up to 1024; 8 points a
    thread up to 4096 (512 threads at sa1) and 16 above, where past 512
    threads the kernel keeps the coordinates in shared memory."""
    if not 1 <= N <= FPS_MAX_N:
        raise ValueError(f"fps takes 1 <= N <= {FPS_MAX_N}, got {N}")
    if N <= 128:
        points = 1 if N <= 32 else 2 if N <= 64 else 4
    elif N <= 1024:
        points = 1 if N <= 512 else 2
    else:
        points = 8 if N <= 4096 else 16
    threads = -(-N // points)
    return -(-threads // 32) * 32, points


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


@functools.lru_cache(maxsize=None)
def three_nn_geometry(B: int, N: int, D: int) -> Tuple[int, int]:
    """-> (Q, R) of csrc/three_nn_interpolate.cu for B rows of N queries
    interpolating D channels: a block of ``THREE_NN_THREADS``
    threads searches Q queries of one row, one a thread, Q the largest
    power of two up to ``THREE_NN_MAX_QUERIES`` that gives each SM at
    least two blocks (Q = 1 where even that does not); R lanes own an
    output row, enough that a lane holds at most four float4 columns and,
    where Q is small, that every thread holds a column, but no more lanes
    than columns."""
    Q = THREE_NN_MAX_QUERIES
    while Q > 1 and B * -(-N // Q) < 2 * SMS:
        Q //= 2
    cols = -(-D // 4)
    R = max(_pow2_at_least(-(-cols // 4)), THREE_NN_THREADS // Q)
    return Q, min(R, _pow2_at_least(cols), THREE_NN_THREADS)


def ball_query_smem(tile: int, Q: int, L: int, R: int) -> int:
    """Dynamic shared memory of a block of csrc/ball_query.cuh
    (``smem_bytes``): the staged tile (16 bytes a source), each of the
    block's groups of L lanes R masks of the tile's bits (whole uint4s)
    behind a 128-bit summary, Q queries' counts and coordinates."""
    radius_words = 4 + -(-(-(-tile // 32)) // 4) * 4
    return (16 * tile + 4 * (BALL_QUERY_THREADS // L) * R * radius_words
            + 4 * Q * (R + 3))


@functools.lru_cache(maxsize=None)
def ball_query_geometry(B: int, N: int, S: int,
                        R: int) -> Tuple[int, int, int, int]:
    """-> (Q, L, tile, walk) of csrc/ball_query.cuh for B rows of S queries
    over N sources and R radii: a block of ``BALL_QUERY_THREADS`` threads
    (one an SM) owns Q queries of one row, Q the smallest power of two that
    puts the batch in one block an SM at most (each block stages its row,
    so fewer, fuller blocks sort less); groups of L lanes take a query each,
    L the power of two that puts all Q queries in flight at once, but from
    8 (the card's sweep: 4 lanes a query lose at sa1) to a warp, and more
    where the groups' masks would not fit. The sources are staged in tiles
    of ``tile`` = min(N, ``BALL_QUERY_TILE``), walked through z-slabs
    (``walk`` = 1) where N is at least ``BALL_QUERY_WALK_N`` and scanned in
    index order below."""
    tile = max(1, min(N, BALL_QUERY_TILE))
    Q = 1
    while Q < BALL_QUERY_THREADS and B * -(-S // Q) > SMS:
        Q *= 2
    L = max(8, min(32, BALL_QUERY_THREADS // Q))
    while L < 32 and ball_query_smem(tile, Q, L, R) > BALL_QUERY_SMEM:
        L *= 2
    return Q, L, tile, int(N >= BALL_QUERY_WALK_N)


def fused_chunk(tile: int, Q: int, L: int) -> int:
    """Rows (b, s, k) the grouping epilogue of csrc/fused_ball_group.cu
    stages at a time (``group_chunk`` of csrc/ball_query.cuh): a source
    row and a query, 8 bytes each, in the shared memory that the tile and
    the groups' masks held (the block's dynamic shared memory less its Q
    queries' counts and coordinates)."""
    return (ball_query_smem(tile, Q, L, 1) - 16 * Q) // 8


@functools.lru_cache(maxsize=None)
def fused_geometry(B: int, N: int, S: int,
                   C: int) -> Tuple[int, int, int, int, int]:
    """-> (Q, L, tile, walk, magic) of csrc/fused_ball_group.cu for B rows
    of S queries over N sources grouping C channels: the single-radius ball
    query's geometry (:func:`ball_query_geometry`), and the multiply-high
    constant that splits a position t < chunk * C of the grouping
    epilogue's span into (row, c), chunk the block's :func:`fused_chunk`
    (2^32 // C + 1 where (chunk * C - 1) * C < 2^32, as
    :func:`group_geometry`'s, else 0: the kernel divides). Retune from
    ``tumseg_torch/tools/ball_query_probe.py --fused``."""
    Q, L, tile, walk = ball_query_geometry(B, N, S, 1)
    chunk = fused_chunk(tile, Q, L)
    magic = 2 ** 32 // C + 1 if (chunk * C - 1) * C < 2 ** 32 else 0
    return Q, L, tile, walk, magic


def group_backward_tiles(B: int, N: int, C: int) -> Tuple[int, int]:
    """-> (T, CT): the source rows and columns a block of
    csrc/group_backward.cu sums. CT is C, or ``GROUP_BWD_MAX_ACC`` where C
    is wider; T is the largest power of two up to ``GROUP_BWD_MAX_ROWS``
    with T * CT within ``GROUP_BWD_MAX_ACC``, T < 2N, and at least two
    blocks an SM (each block rereads its batch row's indices, so a larger T
    reads fewer)."""
    cols = min(C, GROUP_BWD_MAX_ACC)
    col_tiles = -(-C // cols)
    rows = GROUP_BWD_MAX_ROWS
    while rows > 1 and (rows * cols > GROUP_BWD_MAX_ACC or rows >= 2 * N
                        or B * -(-N // rows) * col_tiles < 2 * SMS):
        rows //= 2
    return rows, cols


@functools.lru_cache(maxsize=None)
def interpolate_backward_tiles(B: int, S: int,
                               D: int) -> Tuple[int, int, int]:
    """-> (threads, T, CT): the block size of csrc/interpolate_backward.cu
    and the source rows and columns a block sums. Each block rescans its
    batch row's 3N indices, so the fewer blocks the better, but a warp sums
    its (row, 128-column slice) items one after another. From the card's
    sweep (tumseg_torch/tools/interp_backward_probe.py): where the items
    give every warp of one 1024-thread block an SM at least one, blocks of
    1024 threads take whole rows, T the smallest power of two (up to
    ``INTERP_BWD_MAX_ROWS``) that keeps the grid within one block an SM;
    below that, blocks of 256 threads take one item a warp, T rows of CT
    columns with T x (CT / 128) = 8."""
    slices = -(-D // INTERP_BWD_SLICE)
    if B * S * slices >= 32 * SMS:
        rows = 1
        while rows < INTERP_BWD_MAX_ROWS and B * -(-S // rows) > SMS:
            rows *= 2
        return 1024, rows, D
    if slices >= 8:
        return 256, 1, 8 * INTERP_BWD_SLICE if slices > 8 else D
    return 256, 8 // _pow2_at_least(slices), D


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    """``dtype`` is one dtype or a tuple of those accepted."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be "
                        f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad:
        raise RuntimeError(f"{name} requires grad, but the kernel wrappers "
                           "are forward-only: differentiate through "
                           "tumseg_torch.ops")


def _same_device(*tensors: torch.Tensor) -> torch.device:
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise ValueError(f"inputs on {device} and {t.device}")
    return device


def _launch(kernel: str, fn_name: str, device: torch.device, *args,
            fast: Optional[bool] = None) -> None:
    """Launches ``fn_name`` on the current stream of ``device``; a kernel
    with a fast mode is given ``fast`` as its last argument before the
    stream. The stream comes from ``torch._C._cuda_getCurrentRawStream``
    (the handle ``torch.cuda.current_stream().cuda_stream`` gives, without
    building a Stream object), and the device is switched only when it is
    not the current one: at the centroid gathers the wrapper's host time is
    the whole call."""
    fn = getattr(build.library(), fn_name)
    if fast is not None:
        args = (*args, int(fast))
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    counts, fast_counts, _ = _captured or _LIVE
    counts[kernel] += 1
    if fast:
        fast_counts[kernel] += 1


def _ptr(t: torch.Tensor) -> int:
    """The address of ``t``'s data; the launchers' ``argtypes`` turn an int
    into a pointer, in less host time than a ``ctypes.c_void_p`` built
    here."""
    return t.data_ptr()


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """xyz [B, N, 3] f32 -> [B, npoint] int32; ``start`` [B] int32."""
    _check("xyz", xyz, torch.float32, (None, None, 3))
    B, N, _ = xyz.shape
    if start is None:
        start = torch.zeros(B, dtype=torch.int32, device=xyz.device)
    _check("start", start, torch.int32, (B,))
    if npoint < 0:
        raise ValueError(f"fps needs npoint >= 0, got {npoint}")
    geometry = fps_geometry(N)
    device = _same_device(xyz, start)
    out = torch.empty((B, npoint), dtype=torch.int32, device=device)
    _launch("fps", "tumseg_fps", device, _ptr(xyz), _ptr(start), _ptr(out),
            B, N, npoint, *geometry)
    return out


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz [B, N, 3], new_xyz [B, S, 3] f32 -> [B, S, nsample] int32."""
    _check("xyz", xyz, torch.float32, (None, None, 3))
    B, N, _ = xyz.shape
    _check("new_xyz", new_xyz, torch.float32, (B, None, 3))
    S = new_xyz.shape[1]
    if nsample < 1:
        raise ValueError(f"nsample must be >= 1, got {nsample}")
    device = _same_device(xyz, new_xyz)
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=device)
    r2 = float(radius) * float(radius)  # rounded to f32 by ctypes
    _launch("ball_query", "tumseg_ball_query", device, _ptr(xyz),
            _ptr(new_xyz), _ptr(out), B, N, S, nsample, r2,
            *ball_query_geometry(B, N, S, 1))
    return out


def query_ball_point_multi(radii: Sequence[float], nsamples: Sequence[int],
                           xyz: torch.Tensor, new_xyz: torch.Tensor
                           ) -> Tuple[torch.Tensor, ...]:
    """xyz [B, N, 3], new_xyz [B, S, 3] f32 -> one [B, S, nsamples[i]]
    int32 per radius, from one launch for up to ``BALL_QUERY_MAX_RADII``
    radii; each equals :func:`query_ball_point` of its radius."""
    _check("xyz", xyz, torch.float32, (None, None, 3))
    B, N, _ = xyz.shape
    _check("new_xyz", new_xyz, torch.float32, (B, None, 3))
    S = new_xyz.shape[1]
    R = len(radii)
    if len(nsamples) != R:
        raise ValueError(f"{R} radii but {len(nsamples)} nsamples")
    if not 1 <= R <= BALL_QUERY_MAX_RADII:
        raise ValueError(f"ball_query_multi takes 1 to {BALL_QUERY_MAX_RADII} "
                         f"radii, got {R}")
    if any(k < 1 for k in nsamples):
        raise ValueError(f"every nsample must be >= 1, got {tuple(nsamples)}")
    device = _same_device(xyz, new_xyz)
    outs = tuple(torch.empty((B, S, int(k)), dtype=torch.int32, device=device)
                 for k in nsamples)
    params = _MultiRadii(R)
    for i, (r, k, out) in enumerate(zip(radii, nsamples, outs)):
        params.r2[i] = float(r) * float(r)  # rounded to f32 by ctypes
        params.K[i] = int(k)
        params.out[i] = out.data_ptr()
    _launch("ball_query_multi", "tumseg_ball_query_multi", device, _ptr(xyz),
            _ptr(new_xyz), ctypes.c_void_p(ctypes.addressof(params)), B, N,
            S, *ball_query_geometry(B, N, S, R))
    return outs


def group_points(idx: torch.Tensor, src: torch.Tensor,
                 new_xyz: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """idx [B, S, K] int32 in [0, N], src [B, N, C] f32 (C >= 3, xyz first),
    new_xyz [B, S, 3] f32 -> [B, S, K, C] f32, channels 0-2 centred; bf16
    with ``fast`` (``core.group_points``)."""
    _check("idx", idx, torch.int32, (None, None, None))
    B, S, K = idx.shape
    _check("src", src, torch.float32, (B, None, None))
    _check("new_xyz", new_xyz, torch.float32, (B, S, 3))
    N, C = src.shape[1], src.shape[2]
    if C < 3:
        raise ValueError(f"src needs xyz in channels 0-2, got C={C}")
    device = _same_device(idx, src, new_xyz)
    out = torch.empty((B, S, K, C), device=device,
                      dtype=torch.bfloat16 if fast else torch.float32)
    _launch("group", "tumseg_group", device, _ptr(idx), _ptr(src),
            _ptr(new_xyz), _ptr(out), B, N, S, K, C,
            *group_geometry(B * S * K, C), fast=fast)
    return out


def fused_ball_group(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, src: torch.Tensor,
                     fast: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xyz [B, N, 3], new_xyz [B, S, 3], src [B, N, C] f32 (C >= 3, xyz
    first) -> (grouped [B, S, nsample, C] f32, or bf16 with ``fast``;
    idx [B, S, nsample] int32): :func:`query_ball_point` and
    :func:`group_points` of the same mode in one launch, bit for bit
    (csrc/fused_ball_group.cu: the ball-query walk of csrc/ball_query.cuh
    with a grouping epilogue)."""
    _check("xyz", xyz, torch.float32, (None, None, 3))
    B, N, _ = xyz.shape
    _check("new_xyz", new_xyz, torch.float32, (B, None, 3))
    _check("src", src, torch.float32, (B, N, None))
    S, C = new_xyz.shape[1], src.shape[2]
    if nsample < 1:
        raise ValueError(f"nsample must be >= 1, got {nsample}")
    if C < 3:
        raise ValueError(f"src needs xyz in channels 0-2, got C={C}")
    device = _same_device(xyz, new_xyz, src)
    grouped = torch.empty((B, S, nsample, C), device=device,
                          dtype=torch.bfloat16 if fast else torch.float32)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=device)
    r2 = float(radius) * float(radius)  # rounded to f32 by ctypes
    _launch("fused_ball_group", "tumseg_fused_ball_group", device, _ptr(xyz),
            _ptr(new_xyz), _ptr(src), _ptr(grouped), _ptr(idx), B, N, S,
            nsample, C, r2, *fused_geometry(B, N, S, C), fast=fast)
    return grouped, idx


def three_nn_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                         points2: torch.Tensor, fast: bool = False):
    """xyz1 [B, N, 3], xyz2 [B, S, 3], points2 [B, S, D] f32 ->
    (dists [B, N, 3] f32, idx [B, N, 3] int32, out [B, N, D] f32); ``fast``
    rounds the weights and points2 to bf16 before the f32 products."""
    _check("xyz1", xyz1, torch.float32, (None, None, 3))
    B, N, _ = xyz1.shape
    _check("xyz2", xyz2, torch.float32, (B, None, 3))
    S = xyz2.shape[1]
    _check("points2", points2, torch.float32, (B, S, None))
    D = points2.shape[2]
    if S < 3:
        raise ValueError(f"three_nn needs at least 3 sources, got S={S}")
    device = _same_device(xyz1, xyz2, points2)
    dists = torch.empty((B, N, 3), dtype=torch.float32, device=device)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=device)
    out = torch.empty((B, N, D), dtype=torch.float32, device=device)
    _launch("three_nn_interpolate", "tumseg_three_nn_interpolate", device,
            _ptr(xyz1), _ptr(xyz2), _ptr(points2), _ptr(dists), _ptr(idx),
            _ptr(out), B, N, S, D, *three_nn_geometry(B, N, D),
            fast=fast)
    return dists, idx, out


def three_nn_window_interpolate(xyz1: torch.Tensor, xyz2: torch.Tensor,
                                points2: torch.Tensor, window: int,
                                n_tile: int = 256, fast: bool = False):
    """xyz1 [B, N, 3], xyz2 [B, S, 3], points2 [B, S, D] f32 -> (dists
    [B, N, 3] f32, idx [B, N, 3] int32, out [B, N, D] f32): the z-window
    3-NN of ``core.three_nn_windowed`` and the interpolation, one launch of
    csrc/three_nn_window.cu and no torch op besides the outputs. The
    windowed answer is the full expansion-form row's for every query (the
    guard sends the queries a window could miss to the full form), so the
    kernel searches the row by three_nn.cuh's z-slab walk in the expansion
    form; ``window`` and ``n_tile`` shape only the plain version, not the
    launch. ``fast`` as in :func:`three_nn_interpolate`."""
    _check("xyz1", xyz1, torch.float32, (None, None, 3))
    B, N, _ = xyz1.shape
    _check("xyz2", xyz2, torch.float32, (B, None, 3))
    S = xyz2.shape[1]
    _check("points2", points2, torch.float32, (B, S, None))
    D = points2.shape[2]
    if S < 3:
        raise ValueError(f"three_nn needs at least 3 sources, got S={S}")
    device = _same_device(xyz1, xyz2, points2)
    dists = torch.empty((B, N, 3), dtype=torch.float32, device=device)
    idx = torch.empty((B, N, 3), dtype=torch.int32, device=device)
    out = torch.empty((B, N, D), dtype=torch.float32, device=device)
    _launch("three_nn_window", "tumseg_three_nn_window", device, _ptr(xyz1),
            _ptr(xyz2), _ptr(points2), _ptr(dists), _ptr(idx), _ptr(out), B,
            N, S, D, *three_nn_geometry(B, N, D), fast=fast)
    return dists, idx, out


def three_nn_expansion(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """xyz1 [B, N, 3], xyz2 [B, S, 3] f32 -> (dists [B, N, 3] f32, idx
    [B, N, 3] int32) of ``core.three_nn_expansion``: the window kernel
    with nothing to interpolate (D = 0)."""
    _check("xyz2", xyz2, torch.float32, (None, None, 3))
    empty = xyz2.new_empty(xyz2.shape[0], xyz2.shape[1], 0)
    dists, idx, _ = three_nn_window_interpolate(xyz1, xyz2, empty,
                                                xyz2.shape[1])
    return dists, idx


def group_points_backward(idx: torch.Tensor, grad: torch.Tensor,
                          n: int, fast: bool = False) -> torch.Tensor:
    """idx [B, S, K] int32 in [0, n], grad [B, S, K, C] f32 -> dsrc
    [B, n, C] f32: the scatter-add backward of :func:`group_points`, each
    sum in ascending row s*K + k, so bitwise ``core.group_points_backward``
    on the CPU and the same from run to run; the sentinel ``idx == n`` adds
    nothing. ``fast`` takes a bf16 or an f32 cotangent and rounds it to
    bf16 in the kernel before the f32 sum."""
    _check("idx", idx, torch.int32, (None, None, None))
    B, S, K = idx.shape
    _check("grad", grad,
           (torch.bfloat16, torch.float32) if fast else torch.float32,
           (B, S, K, None))
    C = grad.shape[3]
    if n < 1:
        raise ValueError(f"group backward needs n >= 1 source rows, got {n}")
    device = _same_device(idx, grad)
    out = torch.empty((B, n, C), dtype=torch.float32, device=device)
    _launch("group_backward", "tumseg_group_backward", device, _ptr(idx),
            _ptr(grad), _ptr(out), B, n, S, K, C,
            *group_backward_tiles(B, n, C),
            int(grad.dtype == torch.bfloat16), fast=fast)
    return out


def interpolate_backward(idx: torch.Tensor, weight: torch.Tensor,
                         grad: torch.Tensor, s: int, fast: bool = False
                         ) -> torch.Tensor:
    """idx [B, N, 3] int32 in [0, s), weight [B, N, 3] f32, grad [B, N, D]
    f32 -> dpoints2 [B, s, D] f32 = W^T g, each sum in ascending entry
    3n + k, so bitwise ``core.interpolate_backward`` on the CPU and the same
    from run to run; ``fast`` rounds the weights and the cotangent to bf16
    in the kernel before the f32 products."""
    _check("idx", idx, torch.int32, (None, None, 3))
    B, N, _ = idx.shape
    _check("weight", weight, torch.float32, (B, N, 3))
    _check("grad", grad, torch.float32, (B, N, None))
    D = grad.shape[2]
    if s < 3:
        raise ValueError(f"interpolation needs at least 3 sources, got s={s}")
    device = _same_device(idx, weight, grad)
    out = torch.empty((B, s, D), dtype=torch.float32, device=device)
    _launch("interpolate_backward", "tumseg_interpolate_backward", device,
            _ptr(idx), _ptr(weight), _ptr(grad), _ptr(out), B, N, s, D,
            *interpolate_backward_tiles(B, s, D), fast=fast)
    return out


def bn_layout(C: int, vec: bool) -> Tuple[int, int, int]:
    """-> (V, tiles, R) of csrc/batch_norm.cu for C channels: V channels a
    thread's column vector (4 with ``vec``, else 1), the column tiles of at
    most ``BN_THREADS`` vectors (the grid's y), and R, the rows a block of
    ``BN_THREADS`` threads steps, one a thread of a tile."""
    V = 4 if vec else 1
    cols = C // V
    tile = min(cols, BN_THREADS)
    return V, -(-cols // tile), BN_THREADS // tile


def bn_blocks(M: int, C: int, vec: bool) -> int:
    """Blocks (the grid's x) of csrc/batch_norm.cu's kernels: enough that
    each thread has ``BN_UNROLL`` rows at least once, at most 8 of
    ``BN_THREADS`` threads an SM (its 2048)."""
    _, tiles, R = bn_layout(C, vec)
    return max(1, min(-(-M // (R * BN_UNROLL)), 8 * SMS // tiles))


def _bn_vec(C: int, *tensors: torch.Tensor) -> bool:
    """16-byte column vectors: C a multiple of 4 and every [M, C] tensor
    16-byte aligned."""
    return C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _bn_check(x: torch.Tensor, *channels: Tuple[str, torch.Tensor]):
    """x [M, C] f32 and each named [C] f32 tensor -> (M, C, device)."""
    _check("x", x, torch.float32, (None, None))
    M, C = x.shape
    if M >= 2 ** 31 or C < 1:
        raise ValueError(f"batch norm takes 1 <= C and M < 2^31, got "
                         f"{tuple(x.shape)}")
    for name, t in channels:
        _check(name, t, torch.float32, (C,))
    return M, C, _same_device(x, *(t for _, t in channels))


def bn_apply(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
             bias: torch.Tensor, relu: bool,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [M, C] f32, mean, inv, bias [C] f32 -> y [M, C] = relu?((x - mean)
    * inv + bias) in ``dtype`` (f32 or bf16), each operation rounded in
    that order, so bitwise the eager ops of ``core.batch_norm``."""
    M, C, device = _bn_check(x, ("mean", mean), ("inv", inv),
                             ("bias", bias))
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bn_apply stores f32 or bf16, not {dtype}")
    y = torch.empty((M, C), dtype=dtype, device=device)
    vec = _bn_vec(C, x, y)
    _launch("bn_apply", "tumseg_bn_apply", device, _ptr(x), _ptr(mean),
            _ptr(inv), _ptr(bias), _ptr(y), M, C, int(relu),
            int(dtype == torch.bfloat16), int(vec), bn_blocks(M, C, vec))
    return y


def bn_backward_terms(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      inv: torch.Tensor, bias: torch.Tensor, relu: bool):
    """The [M, C] terms of :func:`bn_apply`'s backward, as autograd forms
    them (``core.batch_norm_terms``): g [M, C] f32 or bf16, x [M, C] f32,
    the forward's mean, inv, bias [C] f32 -> (gz, gz * (x - mean), gz *
    inv), each [M, C] f32, gz = g where the recomputed ReLU passed (g
    without ``relu``)."""
    M, C, device = _bn_check(x, ("mean", mean), ("inv", inv),
                             ("bias", bias))
    _check("g", g, (torch.float32, torch.bfloat16), (M, C))
    _same_device(x, g)
    gz, gzd, gzi = (torch.empty((M, C), dtype=torch.float32, device=device)
                    for _ in range(3))
    vec = _bn_vec(C, g, x, gz, gzd, gzi)
    _launch("bn_backward_terms", "tumseg_bn_backward_terms", device, _ptr(g),
            _ptr(x), _ptr(mean), _ptr(inv), _ptr(bias), _ptr(gz), _ptr(gzd),
            _ptr(gzi), M, C, int(relu), int(g.dtype == torch.bfloat16),
            int(vec), bn_blocks(M, C, vec))
    return gz, gzd, gzi


def bn_backward_dx(gzi: torch.Tensor, x: torch.Tensor, ks: torch.Tensor,
                   kmu: torch.Tensor) -> torch.Tensor:
    """dx [M, C] f32 = ((gzi + ks * x) + ks * x) + kmu, each operation
    rounded in that order (``core.batch_norm_dx``): gzi [M, C] from
    :func:`bn_backward_terms`, x [M, C], ks and kmu [C] f32."""
    M, C, device = _bn_check(x, ("ks", ks), ("kmu", kmu))
    _check("gzi", gzi, torch.float32, (M, C))
    _same_device(x, gzi)
    dx = torch.empty((M, C), dtype=torch.float32, device=device)
    vec = _bn_vec(C, gzi, x, dx)
    _launch("bn_backward_dx", "tumseg_bn_backward_dx", device, _ptr(gzi),
            _ptr(x), _ptr(ks), _ptr(kmu), _ptr(dx), M, C, int(vec),
            bn_blocks(M, C, vec))
    return dx
