"""The port's device serving path on the CPU, against tumseg's: the host
flats of device re-blocking, the re-blocking itself fed JAX's own draws, the
device featurization, one vote of the chunk loop against tumseg's vote scan
(window on and off), the gt-weight gate, the two-scene caches and their
prefetch, run_testing over two scenes, and the "auto" routing."""

import threading
import time

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


def _write_tile(path, rng, n, extent=(3.0, 1.5, 6.0), rgb=False):
    """A facade-like tile: denser towards x = 0, so grid cells hold
    different numbers of blocks, labelled with four classes."""
    xyz = np.stack([extent[0] * rng.random(n) ** 2,
                    rng.uniform(0, extent[1], n),
                    rng.uniform(0, extent[2], n)], 1)
    colours = (rng.integers(0, 256, (n, 3)).astype(np.uint16) if rgb
               else None)
    write_las(str(path), xyz, rng.choice([1, 2, 3, 7], n), rgb=colours)
    return str(path)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small forwards run faster on one thread, and the suite's workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tile(tmp_path):
    return _write_tile(tmp_path / "tile.las", np.random.default_rng(0), 6000)


def _dataset(path, block_points=256, color=False, cls=TestGridDataset):
    return cls(las_file_list=[path] if isinstance(path, str) else path,
               num_classes=8, block_points=block_points, class8=True,
               color=color, seed=0)


def _flats(ds):
    """The tumseg-side device arrays of tests/test_voting.py."""
    fb, st, ct, sz, offs, segments, order = TV._build_reblock_arrays(
        ds.grid_structure(0), ds.block_points)
    return (fb, np.repeat(st, sz), np.repeat(ct, sz),
            np.repeat(np.arange(len(sz), dtype=np.int32), sz), offs,
            segments, order, sz)


def _model(seed=0):
    from tumseg_torch.models.pointnet2_sem_seg import get_model

    torch.manual_seed(seed)
    return get_model(8).eval()


def test_build_reblock_arrays_matches_tumseg(tile):
    cells = _dataset(tile).grid_structure(0)
    got = TV._build_reblock_arrays(cells, 256)
    want = JV._build_reblock_arrays(cells, 256)
    assert got[5] == want[5] and len(got[5]) > 1  # several segments
    for g, w in zip(got[:4] + got[6:], want[:4] + want[6:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # block offsets stay in the cells' f64; tumseg rounds them to f32
    assert got[4].dtype == np.float64
    np.testing.assert_array_equal(got[4].astype(np.float32), want[4])
    with pytest.raises(ValueError, match="empty grid cell"):
        TV._build_reblock_arrays([(np.zeros(0, np.int64), 0.0, 0.0)], 256)


@pytest.mark.parametrize("mode", ["segments", "global"])
def test_reblock_on_device_matches_tumseg(tile, mode):
    """Fed the draws tumseg makes for a key (split, uniform, bits), the
    port's re-blocking equals tumseg's exactly."""
    fb, sp, cp, cr, _, segments, _, _ = _flats(_dataset(tile))
    key = jax.random.PRNGKey(7)
    segs = segments if mode == "segments" else None
    want = np.asarray(JV._reblock_on_device(
        key, jnp.asarray(fb), jnp.asarray(sp), jnp.asarray(cp),
        jnp.asarray(cr), 256, segs))
    kf, ks = jax.random.split(key)
    L = fb.shape[0]
    u = np.array(jax.random.uniform(kf, (L,), jnp.float32))
    bits = np.asarray(jax.random.bits(ks, (L,), jnp.uint32)).astype(np.int64)
    got = TV.reblock_on_device(
        torch.from_numpy(u), torch.from_numpy(bits), torch.from_numpy(fb),
        torch.from_numpy(sp), torch.from_numpy(cp), 256, segs,
        torch.from_numpy(cr) if segs is None else None)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_reblock_cell_membership_and_coverage(tile):
    """With the runner's own generator (tests/test_voting.py:224-262): every
    region holds only its cell's candidates and all of them, the global
    fallback gives the same membership, a vote is reproducible, and two
    votes shuffle differently."""
    ds = _dataset(tile)
    cells = ds.grid_structure(0)
    fb, sp, cp, cr, _, segments, order, sz = _flats(ds)
    runner = TV.InferenceRunner(_model(), 8, batch_size=4, device="cpu",
                                seed=3)
    args = [torch.from_numpy(a) for a in (fb, sp, cp)]

    def flat(vote, segs=segments):
        u, keys = runner.vote_draws(0, vote, fb.shape[0])
        assert u.dtype == torch.float32 and keys.dtype == torch.int64
        assert 0 <= keys.min() and keys.max() < 2 ** 32
        return TV.reblock_on_device(
            u, keys, *args, 256, segs,
            torch.from_numpy(cr) if segs is None else None).reshape(-1)

    got, got_global = flat(0).numpy(), flat(0, None).numpy()
    pos = 0
    for (cand, _, _), s in zip([cells[i] for i in order], sz):
        region = set(got[pos:pos + s].tolist())
        assert region == set(got_global[pos:pos + s].tolist())
        assert region == set(cand.tolist())  # in-cell fills, all present
        pos += s
    assert torch.equal(flat(0), flat(0))
    assert not torch.equal(flat(0), flat(1))


def test_featurize_matches_tumseg_and_host_channels(tmp_path):
    """featurize against TestGridDataset.__getitem__'s channels (computed in
    f64 and rounded to f32 once, as the host path hands them to the model:
    bitwise) and against the channels tumseg's forward_featurized hands its
    model (computed in f32: within 1e-6), colour channels scaled by 1/255."""
    path = _write_tile(tmp_path / "rgb.las", np.random.default_rng(1), 3000,
                       rgb=True)
    ds = _dataset(path, color=True)
    assert ds.num_extra_features == 3
    idx, offsets = ds.grid_indices(0)
    idx, offsets = idx[:4].astype(np.int32), offsets[:4]
    runner = TV.InferenceRunner(_model(), 8, batch_size=4, device="cpu",
                                device_features=True)
    scene = runner._scene_tensors(ds, 0)
    got = TV.featurize(*scene, torch.from_numpy(idx),
                       torch.from_numpy(offsets), 1.0)
    assert got.shape == (4, 256, 9) and got.dtype == torch.float32
    host = _dataset(path, color=True)[0][0][:4]               # f64
    np.testing.assert_array_equal(got.numpy(), host.astype(np.float32))

    seen = []

    class Probe:
        @staticmethod
        def apply(variables, points, training, compute_dtype):
            seen.append(np.asarray(points))
            return points, None, None

    jds = _dataset(path, color=True, cls=JaxGridDataset)
    jrunner = JV.InferenceRunner(Probe, {}, 8, batch_size=4,
                                 device_features=False, device_reblock=False)
    jrunner._forward_featurized_fn({}, *jrunner._scene_tensors(jds, 0),
                                   jnp.asarray(idx),
                                   jnp.asarray(offsets.astype(np.float32)),
                                   1.0)
    np.testing.assert_allclose(got.numpy(), seen[0], rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def vote_case(tmp_path_factory):
    """One 1 m x 1 m column of 6000 points at block_points 4096 (2 blocks,
    one B=2 chunk, so fp1 meets the window's N >= 4096, S >= 1024), tumseg's
    model with BN calibrated on its blocks, the same weights in the port,
    one vote's blocks, and tumseg's vote scan over them (computed once)."""
    from tumseg.models import pointnet2_sem_seg as jmodel
    from tumseg_torch.models.convert import (state_dict_from_variables,
                                             variables_from_state_dict)
    from tumseg_torch.nn.layers import calibrate_batch_norm

    rng = np.random.default_rng(5)
    n = 6000
    on_wall = rng.random(n) < 0.7
    xyz = np.stack([rng.uniform(0, 0.99, n),
                    np.where(on_wall, 0.5 + rng.normal(0, 0.02, n),
                             rng.uniform(0, 0.99, n)),
                    rng.uniform(0, 8, n)], 1)
    path = _write_tile(tmp_path_factory.mktemp("vote") / "column.las", rng, 1)
    write_las(path, xyz, rng.choice([1, 2, 3, 7], n))
    ds = _dataset(path, block_points=4096)
    idx, offsets = ds.grid_indices(0)
    assert idx.shape == (2, 4096)

    model = _model()
    var = jmodel.init(jax.random.PRNGKey(0), 8, 0)
    model.load_state_dict(state_dict_from_variables(
        jax.tree_util.tree_map(np.asarray, var)), strict=True)
    calibrate_batch_norm(model, torch.from_numpy(   # on the vote's blocks
        _dataset(path, block_points=4096)[0][0].astype(np.float32)))
    var = jax.tree_util.tree_map(
        jnp.asarray, variables_from_state_dict(model.state_dict()))

    jds = _dataset(path, block_points=4096, cls=JaxGridDataset)
    jrunner = JV.InferenceRunner(jmodel, var, 8, batch_size=2,
                                 device_features=True, device_reblock=True)
    scene = jrunner._scene_tensors(jds, 0)
    n_pad = int(scene[0].shape[0])
    pool = jrunner._vote_scan_fn(1.0, 0)(
        var, *scene, jnp.asarray(idx.astype(np.int32)),
        jnp.asarray(offsets.astype(np.float32)),
        jnp.zeros(((n_pad + 1) * 8,), jnp.float32))
    want = np.asarray(pool).reshape(n_pad + 1, 8)[:n]
    return dict(ds=ds, model=model, idx=idx, offsets=offsets, want=want, n=n)


@pytest.mark.parametrize("window", [False, True])
def test_vote_matches_tumseg_vote_scan(vote_case, window, monkeypatch):
    """One vote of the port's chunk loop against tumseg's _vote_scan_fn on
    the same blocks and weights: labels equal on >= 99.9% of points and the
    pool's total votes exactly equal. The scene goes in as f32, so featurize
    computes the channels in f32 as tumseg does (the runner's own upload
    keeps the host's f64, which moves FPS at near-ties: see featurize). Why
    not every point: tumseg on the CPU runs its XLA ops, the expansion form
    at every ball query and 3-NN stage, while the port's ball queries and
    fp2-fp4 use the direct form (and fp1 the expansion form with the
    window), so a neighbour at a rounding tie may differ. With the window
    on, fp1 takes the window."""
    calls = []
    monkeypatch.setattr(ops.core, "three_nn_window_interpolate",
                        lambda *a, f=ops.core.three_nn_window_interpolate,
                        **kw: calls.append(a[3:]) or f(*a, **kw))
    case = vote_case
    runner = TV.InferenceRunner(case["model"], 8, batch_size=2, device="cpu",
                                device_features=True, window_ops=window)
    n = case["n"]
    pool = torch.zeros((n + 1) * 8)
    scene = [t.float() if t.is_floating_point() else t
             for t in runner._scene_tensors(case["ds"], 0)]
    with torch.inference_mode(), ops.window_enabled(window):
        runner._vote(scene, torch.from_numpy(case["idx"].astype(np.int32)),
                     torch.from_numpy(case["offsets"].astype(np.float32)),
                     pool, 1.0)
    got = pool.reshape(n + 1, 8)[:n].numpy()
    want = case["want"]
    assert calls == ([(384, 256)] if window else [])
    assert got.sum() == want.sum() == 2 * 4096
    assert len(np.unique(want.argmax(1))) > 1
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.999


def test_gt_gate_zero_and_inf_label_weights(tile):
    """Votes count only where labelweights[gt] is finite and nonzero: the
    gate zeroes those points' rows of the finished pool (tumseg gates the
    pool, not each vote), so they end with label 0, and every other point
    keeps its ungated label."""
    ds = _dataset(tile)
    ds.labelweights = np.ones(8, np.float32)
    ds.labelweights[1] = 0.0
    ds.labelweights[2] = np.inf
    n = ds.semantic_labels_list[0].shape[0]
    runner = TV.InferenceRunner(_model(), 8, device="cpu",
                                device_features=True)
    counts = np.random.default_rng(3).integers(0, 5, (n + 1) * 8)
    pool = torch.from_numpy(counts.astype(np.float32))
    gated = runner._finish(ds, 0, pool, True)
    free = runner._finish(ds, 0, pool, False)
    gt = ds.semantic_labels_list[0].astype(int)
    dropped = np.isin(gt, [1, 2])
    assert dropped.any() and (~dropped).any()
    np.testing.assert_array_equal(gated[dropped], 0)
    np.testing.assert_array_equal(gated[~dropped], free[~dropped])
    np.testing.assert_array_equal(
        free, counts[:n * 8].reshape(n, 8).argmax(1))
    assert (free[dropped] != 0).any()


def test_scene_cache_rebuilds_on_replacement_and_holds_two(tmp_path):
    rng = np.random.default_rng(2)
    paths = [_write_tile(tmp_path / f"s{i}.las", rng, 2000) for i in range(3)]
    ds = _dataset(paths)
    runner = TV.InferenceRunner(_model(), 8, device="cpu",
                                device_features=True)
    first = runner._scene_tensors(ds, 0)
    assert runner._scene_tensors(ds, 0) is first
    grid = runner._grid_tensors(ds, 0)
    ds.scene_points_list[0] = ds.scene_points_list[0] + 1.0  # new array
    again = runner._scene_tensors(ds, 0)
    assert again is not first
    assert torch.allclose(again[0], first[0] + 1.0)
    assert runner._grid_tensors(ds, 0) is not grid
    for i in (1, 2):
        runner._scene_tensors(ds, i)
    assert len(runner._scene_cache) == 2
    assert (id(ds), 2) in runner._scene_cache


def test_concurrent_prefetch_builds_once(tile, monkeypatch):
    """More prefetching threads than cores, switching often: each scene's
    grid is built once, and every thread gets the one entry."""
    import os
    import sys

    built = []
    real = TV._build_reblock_arrays

    def slow(cells, block_points):
        built.append(threading.get_ident())
        time.sleep(0.2)
        return real(cells, block_points)

    monkeypatch.setattr(TV, "_build_reblock_arrays", slow)
    ds = _dataset(tile)
    ds.grid_structure(0)
    runner = TV.InferenceRunner(_model(), 8, device="cpu",
                                device_features=True)
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(runner._grid_tensors(ds, 0)))
        for _ in range(2 * (os.cpu_count() or 4))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        grid = runner._grid_tensors(ds, 0)
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1
    assert len(got) == len(threads) and all(g is grid for g in got)
    runner.prefetch_scene(ds, 0)
    assert len(built) == 1


def test_run_testing_two_scenes_prefetches_the_next(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    paths = [_write_tile(tmp_path / f"scene{i}.las", rng, 3000)
             for i in range(2)]
    ds = _dataset(paths)
    runner = TV.InferenceRunner(_model(), 8, batch_size=4, device="cpu",
                                device_features=True)
    staged = []
    real = runner.prefetch_scene
    monkeypatch.setattr(runner, "prefetch_scene",
                        lambda d, i: staged.append(i) or real(d, i))
    out = TV.run_testing(ds, runner, num_votes=1, visual_dir=tmp_path,
                         log_string=lambda *a: None)
    assert staged == [1]
    assert len(out["per_scene_miou"]) == 2 and out["infer_seconds"] > 0
    assert (tmp_path / "scene0.txt").exists()
    assert (tmp_path / "scene1.txt").exists()
    assert (id(ds), 1) in runner._grid_cache


def test_run_testing_raises_a_failed_prefetch(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    paths = [_write_tile(tmp_path / f"scene{i}.las", rng, 2000)
             for i in range(2)]
    runner = TV.InferenceRunner(_model(), 8, batch_size=4, device="cpu",
                                device_features=True)

    def broken(dataset, scene_idx):
        raise RuntimeError(f"prefetch of scene {scene_idx} failed")

    monkeypatch.setattr(runner, "prefetch_scene", broken)
    with pytest.raises(RuntimeError, match="scene 1 failed"):
        TV.run_testing(_dataset(paths), runner, num_votes=1,
                       log_string=lambda *a: None)


@pytest.mark.parametrize("kwargs,path", [
    ({}, "host"),
    ({"device_features": True}, "device_reblock"),
    ({"device_features": True, "device_reblock": False}, "device_features"),
    ({"device_features": False, "device_reblock": True}, "host"),
])
def test_auto_routing(tile, monkeypatch, kwargs, path):
    """"auto" resolves to the host path on a CPU runner and window_ops to
    off; explicit True takes the device paths on the CPU too."""
    runner = TV.InferenceRunner(_model(), 8, device="cpu", **kwargs)
    assert runner.window_ops is False and runner.seed == 0
    for name in ("host", "device_reblock", "device_features"):
        monkeypatch.setattr(runner, f"_infer_scene_{name}",
                            lambda *a, name=name: name)
    assert runner.infer_scene(_dataset(tile), 0, 1) == path


def test_device_features_path_matches_host_path(tmp_path):
    """Host grid_indices + device featurization against the host path with
    the same dataset seed (so the same blocks): the channels are the host's
    bit for bit, so the labels are equal."""
    from tumseg_torch.nn.layers import calibrate_batch_norm

    path = _write_tile(tmp_path / "small.las", np.random.default_rng(8),
                       1500, extent=(2.0, 1.2, 4.0))
    model = _model()
    calibrate_batch_norm(model, torch.from_numpy(
        _dataset(path)[0][0][:8].astype(np.float32)))
    host = TV.InferenceRunner(model, 8, batch_size=4, device="cpu")
    dev = TV.InferenceRunner(model, 8, batch_size=4, device="cpu",
                             device_features=True, device_reblock=False)
    want = host.infer_scene(_dataset(path), 0, 1)
    got = dev.infer_scene(_dataset(path), 0, 1)
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)
