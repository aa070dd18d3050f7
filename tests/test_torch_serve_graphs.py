"""The serving runner's device programs, made ready for CUDA graphs, on the
CPU.

On the card ``InferenceRunner`` runs its B-block forward, each chunk of a
vote and each vote's re-blocking as CUDA graphs
(``tumseg_torch/utils/graphs.py``); ``chip_smoke.py`` [sg] holds them bit
for bit against ``cuda_graphs=False`` there. Here, where the runner has no
graphs, a stand-in with ``StepGraphs``' interface runs each program eagerly
and records its key and the bindings it was called with, and the tests
check what a capture needs:

- called chunk by chunk, the chunk programs give the pool of the eager
  chunk loop (the vote loop as it was before the programs) bit for bit, on
  the device paths and on the host path, whose padded rows cast no vote;
- one vote of the chunk programs agrees with ``tumseg``'s ``_vote_scan_fn``
  on the same blocks;
- the runner's one vote generator, re-seeded each vote, draws what a fresh
  generator so seeded draws, and ``tumseg``'s ``_reblock_on_device`` fed
  those draws gives the re-blocking program's blocks;
- the bindings stay put over a scene's votes (a mesh's increment included)
  and move when the scene cache replaces the scene; the compute dtype, the
  ops switches, the batch shape and the program key different graphs;
- ``StepGraphs`` holds its lock through a warm-up and a capture, and the
  prefetch's uploads wait for it.

JAX compiles one program here (``tumseg``'s vote scan at B=3, N=256)."""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg.data.dataset import TestGridDataset as JaxGridDataset
from tumseg.infer import voting as JV
from tumseg_torch import ops
from tumseg_torch.data.dataset import TestGridDataset
from tumseg_torch.data.las import write_las
from tumseg_torch.infer import voting as TV
from tumseg_torch.utils import graphs as G

C, BP = 8, 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Programs:
    """``StepGraphs``' interface on the CPU: each program runs eagerly, as
    its warm-up does, and its key, bindings, generators and whether it ran
    under inference mode are recorded."""

    def __init__(self):
        self.calls = []

    def run(self, key, fn, inputs, generators, bindings):
        self.calls.append(SimpleNamespace(
            key=key, bindings=bindings(), generators=tuple(generators),
            inference=torch.is_inference_mode_enabled()))
        return fn(*inputs)

    def keys(self, kind=None):
        return [c.key for c in self.calls if kind in (None, c.key[0])]


class OneRankMesh:
    """A one-process stand-in for ``parallel.mesh.Mesh``: every collective
    is the identity. It stands for a mesh whose collectives can be
    captured, so a vote's all-reduce is a program of its own."""

    size, rank, device = 1, 0, torch.device("cpu")
    capturable = True

    def rows(self, n):
        return slice(0, n)

    def all_reduce_(self, t):
        return t

    def broadcast_array(self, a, dtype):
        return a


def _write_tile(path, rng, n, extent=(2.0, 1.0, 4.0)):
    """A facade-like tile, denser towards x = 0, four classes."""
    xyz = np.stack([extent[0] * rng.random(n) ** 2,
                    rng.uniform(0, extent[1], n),
                    rng.uniform(0, extent[2], n)], 1)
    write_las(str(path), xyz, rng.choice([1, 2, 3, 7], n))
    return str(path)


def _dataset(paths, cls=TestGridDataset):
    return cls(las_file_list=list(paths), num_classes=C, block_points=BP,
               class8=True, color=False, seed=0)


def _model(seed=0):
    from tumseg_torch.models.pointnet2_sem_seg import get_model

    torch.manual_seed(seed)
    return get_model(C).eval()


def _runner(model, **kw):
    runner = TV.InferenceRunner(model, C, batch_size=kw.pop("batch_size", 4),
                                device="cpu", **kw)
    runner.graphs = Programs()
    return runner


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(3)
    return [_write_tile(d / f"scene{i}.las", rng, 1200) for i in range(2)]


@pytest.fixture(scope="module")
def calibrated(tiles):
    """The SSG with BN statistics of the tile's blocks, so its labels
    depend on its input."""
    from tumseg_torch.nn.layers import calibrate_batch_norm

    model = _model()
    calibrate_batch_norm(model, torch.from_numpy(
        _dataset(tiles[:1])[0][0][:8].astype(np.float32)))
    return model


def _eager_vote(runner, scene, idx_blocks, offsets, pool_flat, block_size):
    """The chunk loop of ``InferenceRunner._vote`` as it ran before its
    chunks became programs: featurize, forward, argmax and ``index_add_``
    of each B-block chunk, the short last one padded with the dump row."""
    n = scene[0].shape[0]
    bs = runner.batch_size
    for s in range(0, idx_blocks.shape[0], bs):
        idx, offs = idx_blocks[s:s + bs], offsets[s:s + bs]
        if idx.shape[0] < bs:
            pad = bs - idx.shape[0]
            idx = torch.cat([idx, idx.new_full((pad, idx.shape[1]), n)])
            offs = torch.cat([offs, offs.new_zeros(pad, 2)])
        points = TV.featurize(*scene, idx.clamp(max=n - 1), offs, block_size)
        pred = runner._labels(points)
        flat = idx.reshape(-1).long() * C + pred.reshape(-1)
        pool_flat.index_add_(0, flat, torch.ones_like(flat,
                                                      dtype=pool_flat.dtype))


# -- the programs against the eager loops ------------------------------------

def test_runner_on_the_cpu_has_no_graphs():
    model = _model()
    assert TV.InferenceRunner(model, C, device="cpu").graphs is None
    assert TV.InferenceRunner(model, C, device="cpu",
                              cuda_graphs=False).graphs is None


@pytest.mark.parametrize("window", [False, True])
def test_vote_chunk_programs_give_the_eager_pool(tiles, calibrated, window):
    """One vote's blocks (5 at B=2: the last chunk short) through the chunk
    programs and through the eager loop: pools bitwise equal, one program
    call a chunk, one key, every call under inference mode."""
    ds = _dataset(tiles[:1])
    runner = _runner(calibrated, batch_size=2, device_features=True,
                     window_ops=window)
    scene = runner._scene_tensors(ds, 0)
    n = scene[0].shape[0]
    idx, offsets = ds.grid_indices(0)
    idx = torch.from_numpy(idx[:5].astype(np.int32))
    offsets = torch.from_numpy(offsets[:5])
    want = torch.zeros((n + 1) * C)
    with torch.inference_mode(), ops.window_enabled(window):
        _eager_vote(runner, scene, idx, offsets, want, 1.0)
    got = torch.zeros((n + 1) * C)   # not an inference tensor
    with ops.window_enabled(window):
        runner._vote(scene, idx, offsets, got, 1.0)
    assert torch.equal(got, want)
    assert got.sum() == 6 * BP and got[n * C:].sum() == BP   # one pad block
    calls = runner.graphs.calls
    assert len(calls) == 3 and len({c.key for c in calls}) == 1
    assert all(c.inference for c in calls)
    assert calls[0].key[0] == "vote_chunk"
    assert calls[0].key[-1] == (False, window, False)


def test_device_paths_give_the_eager_pool(tiles, calibrated, monkeypatch):
    """Both device paths over 2 votes: the pool of the programs bitwise the
    eager loop's, fed the same blocks."""
    for reblock in (True, False):
        pools = []
        for vote in (TV.InferenceRunner._vote, _eager_vote):
            monkeypatch.setattr(TV.InferenceRunner, "_vote", vote)
            runner = _runner(calibrated, device_features=True,
                             device_reblock=reblock)
            runner.infer_scene(_dataset(tiles[:1]), 0, 2)
            pools.append(runner._buffers["pool"])
        monkeypatch.undo()
        assert torch.equal(*pools) and pools[0].sum() > 0


def test_host_chunk_programs_give_the_eager_pool(tiles, calibrated):
    """The host path's chunk program (forward, argmax and
    ``_scatter_votes``) against the eager loop that votes only each chunk's
    real rows: pools bitwise equal; the padded rows of the short last chunk
    repeat its last block, so a vote from them would show."""
    ds = _dataset(tiles[:1])
    scene_data, _, _, scene_index = ds[0]
    nb = 7                                      # 2 chunks of 4, one short
    assert scene_data.shape[0] >= nb
    scene_data, scene_index = scene_data[:nb], scene_index[:nb]
    keep = np.ones(scene_index.shape, bool)
    keep[:, ::3] = False
    runner = _runner(calibrated)
    n = ds.semantic_labels_list[0].shape[0]
    want = torch.zeros(n, C)
    with torch.inference_mode():
        for ci, (pred, real) in enumerate(runner._predict_chunks(
                scene_data)):
            s = ci * 4
            TV._scatter_votes(want, torch.from_numpy(scene_index[s:s + real]),
                              pred[:real], torch.from_numpy(keep[s:s + real]))
    runner.graphs = Programs()
    got = torch.zeros(n, C)
    runner._host_chunks(scene_data, scene_index, keep, got, 4)
    assert torch.equal(got, want)
    assert int(got.sum()) == int(keep.sum())
    assert runner.graphs.keys() == [("host_chunk", 4, (BP, 6), (n, C),
                                      None, (False, False, False))] * 2
    # the whole host path: its pool counts exactly the real blocks' votes
    runner = _runner(calibrated, batch_size=3)
    labels = runner.infer_scene(_dataset(tiles[:1]), 0, 2,
                                gt_weight_gate=False)
    blocks = _dataset(tiles[:1])[0][0].shape[0]
    assert blocks % 3 and int(runner._buffers["pool"].sum()) == \
        2 * blocks * BP
    assert labels.shape == (n,)


def test_predict_blocks_is_one_forward_program_a_chunk(calibrated):
    runner = _runner(calibrated)
    data = np.random.default_rng(2).random((6, 128, 6)).astype(np.float32)
    preds = runner.predict_blocks(data)
    assert preds.shape == (6, 128)
    assert runner.graphs.keys() == [("forward", (4, 128, 6), None,
                                     (False, False, False))] * 2
    eager = TV.InferenceRunner(calibrated, C, batch_size=4, device="cpu")
    np.testing.assert_array_equal(preds, eager.predict_blocks(data))


# -- against tumseg's vote scan ----------------------------------------------

@pytest.fixture(scope="module")
def vote_case(tmp_path_factory):
    """A 1 m x 1 m column of 900 points (4 blocks of 256, a 2-block chunk
    short of B=3 at the end), tumseg's model with BN calibrated on the
    blocks, the same weights in the port, one vote's blocks and tumseg's
    vote scan over them (padded to a multiple of B with the dump row)."""
    from tumseg.models import pointnet2_sem_seg as jmodel
    from tumseg_torch.models.convert import (state_dict_from_variables,
                                             variables_from_state_dict)
    from tumseg_torch.nn.layers import calibrate_batch_norm

    rng = np.random.default_rng(5)
    n = 900
    on_wall = rng.random(n) < 0.7
    xyz = np.stack([rng.uniform(0, 0.99, n),
                    np.where(on_wall, 0.5 + rng.normal(0, 0.02, n),
                             rng.uniform(0, 0.99, n)),
                    rng.uniform(0, 4, n)], 1)
    path = str(tmp_path_factory.mktemp("vote") / "column.las")
    write_las(path, xyz, rng.choice([1, 2, 3, 7], n))
    ds = _dataset([path])
    idx, offsets = ds.grid_indices(0)
    assert idx.shape == (4, BP)

    model = _model()
    var = jmodel.init(jax.random.PRNGKey(0), C, 0)
    model.load_state_dict(state_dict_from_variables(
        jax.tree_util.tree_map(np.asarray, var)), strict=True)
    calibrate_batch_norm(model, torch.from_numpy(
        _dataset([path])[0][0].astype(np.float32)))
    var = jax.tree_util.tree_map(
        jnp.asarray, variables_from_state_dict(model.state_dict()))

    jrunner = JV.InferenceRunner(jmodel, var, C, batch_size=3,
                                 device_features=True, device_reblock=True)
    scene = jrunner._scene_tensors(_dataset([path], JaxGridDataset), 0)
    n_pad = int(scene[0].shape[0])
    jidx = np.concatenate([idx, np.full((2, BP), n_pad)]).astype(np.int32)
    joffs = np.concatenate([offsets, np.zeros((2, 2))]).astype(np.float32)
    pool = jrunner._vote_scan_fn(1.0, 0)(
        var, *scene, jnp.asarray(jidx), jnp.asarray(joffs),
        jnp.zeros(((n_pad + 1) * C,), jnp.float32))
    want = np.asarray(pool).reshape(n_pad + 1, C)[:n]
    return dict(ds=ds, model=model, idx=idx, offsets=offsets, want=want, n=n)


def test_vote_programs_match_tumseg_vote_scan(vote_case):
    """One vote through the chunk programs (B=3: a full chunk and one padded
    with the dump row) against tumseg's ``_vote_scan_fn``: labels equal on
    >= 99.9% of points (the ball queries' forms differ at rounding ties,
    see tests/test_torch_vote_device.py) and the votes' total exactly equal.
    The scene goes in as f32, as tumseg featurizes."""
    case = vote_case
    runner = _runner(case["model"], batch_size=3, device_features=True)
    n = case["n"]
    pool = torch.zeros((n + 1) * C)
    scene = [t.float() if t.is_floating_point() else t
             for t in runner._scene_tensors(case["ds"], 0)]
    runner._vote(scene, torch.from_numpy(case["idx"].astype(np.int32)),
                 torch.from_numpy(case["offsets"].astype(np.float32)),
                 pool, 1.0)
    got = pool.reshape(n + 1, C)[:n].numpy()
    want = case["want"]
    assert len(runner.graphs.calls) == 2
    assert got.sum() == want.sum() == 4 * BP
    assert len(np.unique(want.argmax(1))) > 1
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.999


# -- the vote generator and the re-blocking program --------------------------

def _fresh_draws(seed, scene, vote, length):
    """``vote_draws`` as it drew before the runner kept one generator: a
    new generator a vote, seeded from ``SeedSequence([seed, scene,
    vote])``."""
    state = np.random.SeedSequence([seed, scene, vote])
    gen = torch.Generator()
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    u = torch.rand(length, generator=gen)
    keys = torch.randint(0, 2 ** 32, (length,), generator=gen,
                         dtype=torch.int64)
    return u, keys


def test_reseeded_vote_generator_draws_what_fresh_ones_draw(calibrated):
    runner = _runner(calibrated, seed=11)
    for scene, vote in ((0, 0), (0, 1), (3, 0), (0, 0), (1, 7), (3, 0)):
        got = runner.vote_draws(scene, vote, 1000)
        want = _fresh_draws(11, scene, vote, 1000)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert runner._generator is runner._vote_generator(0, 0)


@pytest.mark.parametrize("scene_idx,vote", [(0, 0), (0, 1), (1, 0), (1, 2)])
def test_reblock_program_equals_tumseg_fed_the_same_draws(
        tiles, calibrated, monkeypatch, scene_idx, vote):
    """The re-blocking program of (scene, vote) against tumseg's
    ``_reblock_on_device`` run eagerly (``jax.disable_jit``) with its
    ``jax.random`` draws replaced by the port's: blocks equal. The program
    draws from the runner's one generator, which it registers."""
    ds = _dataset(tiles)
    runner = _runner(calibrated, device_features=True, seed=5)
    grid = runner._grid_tensors(ds, scene_idx)
    got = runner._reblock(grid, scene_idx, vote, BP)
    (call,) = runner.graphs.calls
    assert call.key[:4] == ("reblock", grid[0].shape[0], grid[5], BP)
    assert call.generators == (runner._generator,)

    u, keys = _fresh_draws(5, scene_idx, vote, grid[0].shape[0])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(u.numpy()))
    monkeypatch.setattr(jax.random, "bits",
                        lambda *a, **k: jnp.asarray(
                            keys.numpy().astype(np.uint32)))
    flat_base, starts_pos, counts_pos = (t.numpy() for t in grid[:3])
    with jax.disable_jit():
        want = JV._reblock_on_device(
            jax.random.PRNGKey(0), jnp.asarray(flat_base),
            jnp.asarray(starts_pos), jnp.asarray(counts_pos), None, BP,
            grid[5])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- bindings and keys -------------------------------------------------------

@pytest.mark.parametrize("path", ["device_reblock", "device_features", "host"])
def test_bindings_stable_over_votes_and_moved_by_another_scene(
        tiles, calibrated, path):
    """Every program call of a scene's votes sees one binding, the mesh's
    increment included; voting the scene again keeps it; the scene cache
    replacing the scene moves it (its tensors, so every graph drops)."""
    kw = dict(device_features=path != "host",
              device_reblock=path == "device_reblock")
    runner = _runner(calibrated, mesh=OneRankMesh(), **kw)
    ds = _dataset(tiles[:1])
    runner.infer_scene(ds, 0, 3)
    calls = runner.graphs.calls
    bound = {c.bindings for c in calls}
    assert len(bound) == 1
    (bindings,) = bound
    roles = dict(b for b in bindings if isinstance(b, tuple)
                 and isinstance(b[0], str))
    assert roles["increment"] and roles["pool"]
    assert roles["increment"] != roles["pool"]
    kinds = [c.key[0] for c in calls]
    if path == "device_reblock":
        assert kinds.count("reblock") == 3
    runner.graphs.calls.clear()
    runner.infer_scene(ds, 0, 1)
    assert {c.bindings for c in runner.graphs.calls} == bound
    if path == "host":
        return
    # the scene replaced; its old tensors still held, so that the new ones
    # cannot take their addresses (a graph of a scene at the same addresses
    # and shapes reads the new scene, and is kept)
    old = runner._scene_tensors(ds, 0)
    ds.scene_points_list[0] = ds.scene_points_list[0] + 0.0
    runner.graphs.calls.clear()
    runner.infer_scene(ds, 0, 1)
    moved = {c.bindings for c in runner.graphs.calls}
    assert len(moved) == 1 and moved != bound
    assert runner._scene_tensors(ds, 0) is not old


def test_mesh_increment_is_zeroed_in_place_each_vote(tiles, calibrated):
    """On a mesh every vote votes into one increment buffer, zeroed in
    place, and the pool adds each vote's increment once."""
    ds = _dataset(tiles[:1])
    mesh_runner = _runner(calibrated, mesh=OneRankMesh(),
                          device_features=True)
    want = _runner(calibrated, device_features=True)
    labels = [r.infer_scene(ds, 0, 2) for r in (mesh_runner, want)]
    inc = mesh_runner._buffers["increment"]
    np.testing.assert_array_equal(*labels)
    assert torch.equal(mesh_runner._buffers["pool"], want._buffers["pool"])
    mesh_runner.infer_scene(ds, 0, 1)
    assert mesh_runner._buffers["increment"] is inc


def test_dtype_switches_shape_and_program_key_different_graphs(
        tiles, calibrated):
    runner = _runner(calibrated, device_features=True)
    x4, x2 = torch.rand(4, 128, 6), torch.rand(2, 128, 6)
    runner._forward(x4)
    runner._forward(x2)
    with ops.fused_group_enabled():
        runner._forward(x4)
    with ops.window_enabled():
        runner._forward(x4)
    runner.compute_dtype = torch.bfloat16
    runner._forward(x4)
    runner.compute_dtype = None
    ds = _dataset(tiles[:1])
    runner.infer_scene(ds, 0, 1)
    host = _runner(calibrated)
    host.infer_scene(ds, 0, 1)
    keys = runner.graphs.keys() + host.graphs.keys()
    forwards = keys[:5]
    assert len(set(forwards)) == 5
    kinds = {k[0] for k in set(keys)}
    assert kinds == {"forward", "reblock", "vote_chunk", "host_chunk"}
    assert len(set(keys)) == 5 + 3


# -- the lock ----------------------------------------------------------------

def test_step_graphs_hold_the_lock_through_warm_up_and_capture(monkeypatch):
    """``StepGraphs.run``'s control flow on the CPU, its warm-up and capture
    stood in: the first call warms up, the second captures and replays,
    the third replays; the lock is held through the warm-up and the
    capture and free during a replay; new bindings drop the graphs."""
    lock = threading.Lock()
    graphs = G.StepGraphs("cpu", lock=lock)
    seen = []

    class Graph:
        def replay(self):
            seen.append(("replay", lock.locked()))

    def warm_up(fn, inputs):
        seen.append(("warm-up", lock.locked()))
        return fn(*inputs)

    def capture(key, fn, inputs, generators):
        seen.append(("capture", lock.locked()))
        graphs.captures += 1
        return G._Graph(Graph(), [t.clone() for t in inputs],
                        fn(*inputs), ({}, {}))

    monkeypatch.setattr(graphs, "_warm_up", warm_up)
    monkeypatch.setattr(graphs, "_capture", capture)
    x = torch.ones(3)
    for _ in range(3):
        out = graphs.run("k", lambda t: (t * 2,), (x,), [], lambda: (1,))
        assert torch.equal(out[0], x * 2)
    assert seen == [("warm-up", True), ("capture", True), ("replay", False),
                    ("replay", False)]
    assert (graphs.warmups, graphs.captures, graphs.replays) == (1, 1, 2)
    graphs.run("k", lambda t: (t,), (x,), [], lambda: (2,))
    assert seen[-1] == ("warm-up", True) and graphs.warmups == 2


def test_prefetch_uploads_wait_for_the_device_lock(tiles, calibrated):
    """A held device lock (a warm-up or capture under way) holds the
    prefetch's uploads of the next scene back until it is released."""
    ds = _dataset(tiles)
    ds.grid_structure(1)
    runner = _runner(calibrated, device_features=True)
    thread = threading.Thread(target=runner.prefetch_scene, args=(ds, 1))
    with runner._device_lock:
        thread.start()
        time.sleep(0.3)
        assert thread.is_alive()
        assert not any(e[2].is_set() for e in runner._scene_cache.values())
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert (id(ds), 1) in runner._scene_cache
    assert (id(ds), 1) in runner._grid_cache
