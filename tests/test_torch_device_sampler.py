"""The port's device training pipeline on the CPU against tumseg's
(``tumseg/data/device_sampler.py``, ``tumseg/train/loop.py``):

- the sampler's tables, candidates and, fed tumseg's own draws, its samples
  (centres, counts, sel, points, labels) are tumseg's bit for bit;
- tumseg's semantic tests of the sampler, on the port's generator path;
- the loader's order, the keyed augmentations and ``summarize_model``;
- the engine's room-id steps: a k-step call is k single steps bit for bit,
  eval calls do not move training, and ``fit(superstep=4)`` logs what
  ``superstep=1`` logs;
- the training CLI on ``--data_pipeline device --gpu cpu``.

JAX compiles one sampler (``sample_batch_aux``) and one vmapped
``_candidates`` in this module."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg.data import augment as jaug
from tumseg.data.device_sampler import DeviceBlockSampler as JaxSampler
from tumseg.data.device_sampler import DeviceSampleLoader as JaxLoader
from tumseg_torch.data import augment as taug
from tumseg_torch.data.dataset import TrainBlockDataset
from tumseg_torch.data.device_sampler import (DeviceBlockSampler,
                                              DeviceSampleLoader, RoomBatch)
from tumseg_torch.data.las import write_las
from tumseg_torch.models.pointnet2_sem_seg import get_model
from tumseg_torch.train import loop as tloop

MIN_PTS = 200  # the reference's 1024, scaled to these small rooms
TABLES = ("_packed", "_px", "_py", "_room_start", "_room_count",
          "_room_cmin", "_room_cmax", "_room_nbx", "_room_nby",
          "_room_bin_off", "_bin_start", "_bin_count")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dense_rooms(seed=0, n0=6000, n1=4000):
    """Two rooms dense enough that 1 m blocks hold > MIN_PTS points, with a
    colour and a plain extra column."""
    r = np.random.default_rng(seed)
    rooms = []
    for n, span in ((n0, (3.0, 2.0)), (n1, (2.0, 2.5))):
        pts = np.stack([r.uniform(0, span[0], n), r.uniform(0, span[1], n),
                        r.uniform(0, 2.0, n)], axis=1)
        labels = (pts[:, 0] * 3).astype(np.int64) % 8
        extra = [r.uniform(0, 255, n), r.uniform(0, 1, n)]
        rooms.append((pts, labels, extra))
    return rooms


def _sparse_room():
    """A room whose densest 0.6 m bin holds far fewer than 4096 / 9."""
    r = np.random.default_rng(3)
    n = 1200
    pts = np.stack([r.uniform(0, 2.0, n), r.uniform(0, 1.0, n),
                    r.uniform(0, 2.0, n)], axis=1)
    return pts, (pts[:, 0] * 3).astype(np.int64) % 8


def _both(config, min_block_points=MIN_PTS, num_point=None):
    """(tumseg's sampler, the port's on the CPU, rooms) of a config."""
    if config == "extras":
        rooms = _dense_rooms()
        args = ([p for p, _, _ in rooms], [l for _, l, _ in rooms],
                [e for _, _, e in rooms])
        kw = dict(color_flags=[True, False], num_point=num_point or 512)
    else:
        pts, labels = _sparse_room()
        rooms = [(pts, labels, [])]
        args = ([pts], [labels], [[]])
        kw = dict(color_flags=[], num_point=num_point or 4096)
    kw.update(block_size=1.0, min_block_points=min_block_points)
    return (JaxSampler(*args, **kw),
            DeviceBlockSampler(*args, device="cpu", **kw), rooms)


@pytest.mark.parametrize("config", ["extras", "sparse"])
def test_tables_match_tumseg(config):
    js, ts, _ = _both(config)
    assert ts.cap == js.cap
    for name in TABLES:
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=name)
    if config == "sparse":  # the cap floor: ceil(4096 / 9) up to 512
        assert ts.cap == 512 and 9 * ts.cap >= 4096


def test_too_small_room_raises_like_tumseg():
    r = np.random.default_rng(3)
    small = r.uniform(0, 1, (150, 3))
    dense = _dense_rooms()[0][0]
    args = ([dense, small], [np.zeros(len(dense), np.int64),
                             np.zeros(150, np.int64)], [[], []])
    kw = dict(color_flags=[], num_point=64, min_block_points=MIN_PTS)
    with pytest.raises(ValueError) as want:
        JaxSampler(*args, **kw)
    with pytest.raises(ValueError) as got:
        DeviceBlockSampler(*args, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "min_block_points" in str(got.value)


@pytest.fixture(scope="module")
def replay_pair():
    """Blocks must hold > 600 points, so some rows take several trials, and
    P = 768 lies inside the counts' range."""
    return _both("extras", min_block_points=600, num_point=768)


def test_candidates_match_tumseg(replay_pair):
    js, ts, _ = replay_pair
    r = np.random.default_rng(1)
    rid = r.integers(0, 2, 20).astype(np.int32)
    cx = r.uniform(-0.5, 3.5, 20).astype(np.float32)
    cy = r.uniform(-0.5, 3.0, 20).astype(np.float32)
    cmin = np.asarray(js._room_cmin)
    # centres on bin edges and at the rooms' corners
    for i in range(0, 20, 3):
        cx[i] = cmin[rid[i], 0] + np.float32(0.6) * np.float32(i % 5)
        cy[i + 1] = cmin[rid[i + 1], 1] + np.float32(0.6) * np.float32(i % 4)
    want_idx, want_inside = jax.jit(jax.vmap(js._candidates))(
        jnp.asarray(rid), jnp.asarray(cx), jnp.asarray(cy))
    idx, inside = ts._candidates(torch.as_tensor(rid).long(),
                                 torch.as_tensor(cx), torch.as_tensor(cy))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(want_inside))
    assert 0 < int(inside.sum()) < inside.numel()


def _tumseg_draws(ts, key, room_ids, trials):
    """tumseg's draws of ``sample_batch_aux(key, room_ids)``, derived as
    ``_sample_one`` derives them: the trial uniforms of ``trials`` trials a
    row, then the selection and replacement uniforms of the key after the
    row's first accepted trial (found with the port's counts)."""
    B = len(room_ids)
    rows = jax.random.split(key, B)
    trial_u = np.zeros((B, trials), np.float32)
    after = []
    for b in range(B):
        k, keys = rows[b], []
        for j in range(trials):
            k, kc = jax.random.split(k)
            trial_u[b, j] = jax.random.uniform(kc, (), jnp.float32)
            keys.append(k)
        after.append(keys)
    rid = torch.as_tensor(room_ids).long()
    _, counts = ts.trial_blocks(rid.repeat_interleave(trials),
                                torch.as_tensor(trial_u).reshape(-1))
    ok = counts.view(B, trials).numpy() > ts.min_block_points
    first = ok.argmax(1)
    assert ok.any(1).all()
    sel_u = np.zeros((B, 9 * ts.cap), np.float32)
    rep_u = np.zeros((B, ts.num_point), np.float32)
    for b in range(B):
        ksel, krep = jax.random.split(after[b][first[b]])
        sel_u[b] = jax.random.uniform(ksel, (9 * ts.cap,), jnp.float32)
        rep_u[b] = jax.random.uniform(krep, (ts.num_point,), jnp.float32)
    return trial_u, sel_u, rep_u, first


def test_replay_of_tumseg_draws(replay_pair):
    js, ts, _ = replay_pair
    room_ids = np.array([0, 1] * 8, np.int32)
    key = jax.random.PRNGKey(7)
    want = jax.tree_util.tree_map(
        np.asarray, jax.jit(js.sample_batch_aux)(key, jnp.asarray(room_ids)))
    trial_u, sel_u, rep_u, first = _tumseg_draws(ts, key, room_ids, 24)
    got = ts.sample_from_draws(room_ids, trial_u, sel_u, rep_u)
    for name, w, g in zip(("points", "labels", "centres", "counts", "sel"),
                          want, got):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w,
                                      err_msg=name)
    counts = want[3]
    assert (counts < ts.num_point).any() and (counts >= ts.num_point).any()
    assert (first > 0).any()  # some rows were redrawn


# -- tumseg's semantic tests (tests/test_device_sampler.py), generator path --

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sampled_blocks_match_host_semantics():
    _, s, rooms = _both("extras")
    room_ids = [0, 1, 0, 1]
    pts, lab, centers, cnts, sel = (
        t.numpy() for t in s.sample_batch_aux(room_ids, _gen(7)))
    assert pts.shape == (4, 512, 8) and lab.shape == (4, 512)
    half = np.float32(0.5)
    xyz = s._xyz.numpy()
    for b, rid in enumerate(room_ids):
        room_pts = rooms[rid][0]
        c = centers[b]
        rp32 = room_pts.astype(np.float32)
        assert np.abs(rp32 - c).max(axis=1).min() == 0.0  # a room point
        inside = ((rp32[:, 0] >= c[0] - half) & (rp32[:, 0] <= c[0] + half)
                  & (rp32[:, 1] >= c[1] - half) & (rp32[:, 1] <= c[1] + half))
        assert cnts[b] == inside.sum() and cnts[b] > MIN_PTS
        sel_xyz = xyz[sel[b]]
        assert ((sel_xyz[:, 0] >= c[0] - half) & (sel_xyz[:, 0] <= c[0] + half)
                & (sel_xyz[:, 1] >= c[1] - half)
                & (sel_xyz[:, 1] <= c[1] + half)).all()
        cmax = room_pts.max(axis=0).astype(np.float32)
        np.testing.assert_array_equal(pts[b, :, 0], sel_xyz[:, 0] - c[0])
        np.testing.assert_array_equal(pts[b, :, 2], sel_xyz[:, 2])
        np.testing.assert_array_equal(pts[b, :, 3:6], sel_xyz / cmax)
        np.testing.assert_array_equal(lab[b], s._labels.numpy()[sel[b]])
        np.testing.assert_array_equal(pts[b, :, 6:8], s._extra.numpy()[sel[b]])
        assert pts[b, :, 6].max() <= 1.0  # colour scaled by 1/255


def test_without_replacement_when_block_is_big_enough():
    _, s, _ = _both("extras")
    _, _, _, cnts, sel = s.sample_batch_aux([0, 0], _gen(3))
    for b in range(2):
        assert cnts[b] >= 512
        assert np.unique(sel[b].numpy()).size == 512


def _thin_room_sampler(min_block_points):
    r = np.random.default_rng(1)
    n = 3000
    pts = np.stack([r.uniform(0, 10.0, n), r.uniform(0, 10.0, n),
                    r.uniform(0, 2.0, n)], axis=1)  # ~30 points / m^2
    return DeviceBlockSampler([pts], [np.zeros(n, np.int64)], [[]],
                              color_flags=[], num_point=256, block_size=1.0,
                              min_block_points=min_block_points, device="cpu")


def test_with_replacement_when_block_is_small():
    s = _thin_room_sampler(10)
    _, _, centers, cnts, sel = (
        t.numpy() for t in s.sample_batch_aux([0, 0], _gen(0)))
    for b in range(2):
        assert 10 < cnts[b] < 256
        assert np.unique(sel[b]).size <= cnts[b]
        sel_xyz = s._xyz.numpy()[sel[b]]
        assert np.all(np.abs(sel_xyz[:, :2] - centers[b][:2]) <= 0.5 + 1e-6)


def test_selection_is_uniform_over_block_members():
    r = np.random.default_rng(2)
    n = 2000
    pts = r.uniform(0, 1.0, (n, 3))  # one room == one block
    s = DeviceBlockSampler([pts], [np.arange(n) % 8], [[]], color_flags=[],
                           num_point=64, block_size=4.0, min_block_points=10,
                           device="cpu")
    B = 64
    sel = s.sample_batch_aux(np.zeros(B, np.int32), _gen(11))[4].numpy()
    counts = np.bincount(sel.reshape(-1), minlength=n)
    assert counts.mean() == pytest.approx(B * 64 / n, rel=0.01)
    assert counts.max() <= 12


def test_center_distribution_matches_host():
    """Label histograms of device-sampled blocks track the host sampler's
    (the same distribution, other random streams)."""
    pts, labels, _ = _dense_rooms(seed=9, n0=8000, n1=1)[0]
    s = DeviceBlockSampler([pts], [labels], [[]], color_flags=[],
                           num_point=256, block_size=1.0,
                           min_block_points=1024, device="cpu")
    B = 96
    lab_dev = s.sample_batch(np.zeros(B, np.int32), _gen(4))[1].numpy()

    ds = TrainBlockDataset()
    ds.room_points, ds.room_labels = [pts], [labels]
    ds.room_coord_min, ds.room_coord_max = [pts.min(0)], [pts.max(0)]
    ds.extra_features_data = [[]]
    ds.num_point = 256
    ds.room_idxs = np.zeros(B, np.int64)
    rng = np.random.default_rng(4)
    host_lab = np.stack([ds.sample(i, rng)[1] for i in range(B)])
    h_dev = np.bincount(lab_dev.reshape(-1), minlength=8) / lab_dev.size
    h_host = np.bincount(host_lab.reshape(-1), minlength=8) / host_lab.size
    np.testing.assert_allclose(h_dev, h_host, atol=0.04)


def test_sparse_room_cap_floor():
    _, s, _ = _both("sparse")
    pts, lab = s.sample_batch(np.zeros(2, np.int32), _gen(0))
    assert pts.shape == (2, 4096, 6) and lab.shape == (2, 4096)
    assert torch.isfinite(pts).all()
    assert (lab >= 0).all() and (lab < 8).all()


def test_batches_equal_single_batches_and_count_rounds():
    """k batches from k generators at once are the k batches drawn alone;
    the sampler counts the rows a first round left pending."""
    _, s, _ = _both("extras", min_block_points=800)
    ids = np.array([[1, 1, 1], [1, 0, 1]], np.int32)
    got = s.sample_batches_aux(ids, [_gen(1), _gen(2)])
    for i, seed in enumerate((1, 2)):
        for g, w in zip(got, s.sample_batch_aux(ids[i], _gen(seed))):
            assert torch.equal(g[i], w)
    assert s.stats["rows"] == 12 and 0 < s.stats["redrawn"] < 12
    assert s.stats["rounds"] > 3


def test_explicit_draws_that_accept_no_block_raise():
    """No block of this room holds more than 1000 points: the generator
    path would loop, as tumseg's does; explicit draws run out and raise."""
    s = _thin_room_sampler(1000)
    with pytest.raises(ValueError, match="accepted none of its 2"):
        s.sample_from_draws([0], np.full((1, 2), 0.5, np.float32),
                            np.zeros((1, 9 * s.cap), np.float32),
                            np.zeros((1, 256), np.float32))


def test_from_dataset_matches_tumseg(tmp_path):
    r = np.random.default_rng(5)
    paths = []
    for i in range(2):
        n = 5000
        xyz = np.stack([r.uniform(0, 2.5, n), r.uniform(0, 2.0, n),
                        r.uniform(0, 2.0, n)], axis=1)
        rgb = r.integers(0, 65535, (n, 3)).astype(np.uint16)
        path = str(tmp_path / f"room{i}.las")
        write_las(path, xyz, np.array([1, 2, 3, 5, 12])[np.arange(n) % 5],
                  rgb=rgb)
        paths.append(path)
    ds = TrainBlockDataset(paths, num_classes=8, num_point=128, color=True,
                           class8=True, seed=0)
    js = JaxSampler.from_dataset(ds, min_block_points=100)
    ts = DeviceBlockSampler.from_dataset(ds, min_block_points=100,
                                         device="cpu")
    assert ts.num_extra_features == 3 and ts.num_point == 128
    for name in TABLES:
        np.testing.assert_array_equal(
            getattr(ts, name).numpy().astype(np.asarray(getattr(js, name))
                                             .dtype),
            np.asarray(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("shuffle,seed", [(True, 3), (False, None)])
def test_loader_order_matches_tumseg(shuffle, seed):
    class Rooms:
        room_idxs = np.arange(23) % 4

    ours = DeviceSampleLoader(Rooms, 4, shuffle=shuffle, seed=seed)
    theirs = JaxLoader(Rooms, 4, shuffle=shuffle, seed=seed)
    assert len(ours) == len(theirs) == 5
    for _ in range(2):  # two epochs: the reshuffle too
        got = list(ours)
        want = [b.room_ids for b in theirs]
        assert all(isinstance(b, RoomBatch) for b in got)
        got = [b.room_ids for b in got]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_augmentations_match_tumseg():
    x = np.random.default_rng(6).standard_normal((3, 40, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(8)
    noise = np.array(jax.random.normal(key, x.shape))
    np.testing.assert_array_equal(
        taug.jitter(torch.from_numpy(x), torch.from_numpy(noise)).numpy(),
        np.asarray(jaug.jjitter(key, jnp.asarray(x))))
    scales = np.array(jax.random.uniform(key, (3,), minval=0.8,
                                         maxval=1.25))
    np.testing.assert_array_equal(
        taug.scale(torch.from_numpy(x), torch.from_numpy(scales)).numpy(),
        np.asarray(jaug.jscale(key, jnp.asarray(x))))
    shifts = np.array(jax.random.uniform(key, (3, 3), minval=-0.1,
                                         maxval=0.1))
    np.testing.assert_array_equal(
        taug.shift(torch.from_numpy(x), torch.from_numpy(shifts)).numpy(),
        np.asarray(jaug.jshift(key, jnp.asarray(x))))


# -- the engine's room-id steps ----------------------------------------------

C, P, B = 8, 128, 2


@pytest.fixture(scope="module")
def engine_sampler():
    return _both("extras", num_point=P)[1]


def _engine(sampler, seed=0):
    torch.manual_seed(0)
    return tloop.TrainEngine(get_model(C, 2), C, np.ones(C), seed=seed,
                             device="cpu", sampler=sampler)


def _state(eng):
    return ([p.detach().clone() for p in eng.model.state_dict().values()],
            [v.clone() for s in eng.optimizer.state.values()
             for v in s.values()])


IDS = np.array([[0, 1], [1, 1]], np.int32)


@pytest.fixture(scope="module")
def single_steps(engine_sampler):
    """One engine's two single room-id steps on IDS, the state after them
    and its next step's loss, which both tests below read."""
    eng = _engine(engine_sampler)
    out = [eng.train_batch_rooms(i, 1e-3, 0.1) for i in IDS]
    state = _state(eng)
    nxt = eng.train_batch_rooms(IDS[0], 1e-3, 0.1)[0]
    return dict(losses=[l for l, _ in out], corrects=[c for _, c in out],
                state=state, nxt=nxt)


def test_superstep_equals_single_steps(engine_sampler, single_steps):
    multi = _engine(engine_sampler)
    losses, corrects = multi.train_batch_rooms_multi(IDS, 1e-3, 0.1)
    assert losses.shape == corrects.shape == (2,)
    for i in range(2):
        assert torch.equal(single_steps["losses"][i], losses[i])
        assert torch.equal(single_steps["corrects"][i], corrects[i])
    for a, b in zip(_state(multi), single_steps["state"]):
        assert len(a) == len(b) and all(map(torch.equal, a, b))
    # and the next call after it
    nxt = multi.train_batch_rooms(IDS[0], 1e-3, 0.1)[0]
    assert torch.equal(nxt, single_steps["nxt"]) and math.isfinite(float(nxt))


def test_eval_does_not_move_training(engine_sampler, single_steps):
    mixed = _engine(engine_sampler)
    got = [mixed.train_batch_rooms(IDS[0], 1e-3, 0.1)[0]]
    losses, tallies = mixed.eval_batch_rooms_multi(IDS)
    # the k-call eval is k single eval calls from the same counters
    mixed._eval_count -= 2
    singles = [mixed.eval_batch_rooms(i) for i in IDS]
    got.append(mixed.train_batch_rooms(IDS[1], 1e-3, 0.1)[0])
    assert all(map(torch.equal, got, single_steps["losses"]))
    assert torch.equal(losses, torch.stack([l for l, _ in singles]))
    for name, t in tallies.items():
        assert torch.equal(t, singles[0][1][name] + singles[1][1][name])
    assert int(tallies["seen"].sum()) == 2 * B * P


def test_fit_superstep_logs_what_single_steps_log(engine_sampler, tmp_path):
    class Loader:
        def __init__(self, ids):
            self.ids = ids

        def __len__(self):
            return len(self.ids)

        def __iter__(self):
            return (RoomBatch(i) for i in self.ids)

    r = np.random.default_rng(0)
    train = Loader(r.integers(0, 2, (6, B)).astype(np.int32))
    evals = Loader(r.integers(0, 2, (5, B)).astype(np.int32))
    logs = {}
    for k in (1, 4):
        lines = []
        (tmp_path / str(k)).mkdir()
        tloop.fit(_engine(engine_sampler), train, evals, start_epoch=0,
                  end_epoch=1, learning_rate=1e-3, lr_decay=0.7, step_size=10,
                  batch_size=B, num_point=P,
                  checkpoints_dir=tmp_path / str(k), model_name="/best.pth",
                  seg_label_to_cat={i: str(i) for i in range(C)},
                  log_string=lines.append, superstep=k)
        logs[k] = [l.replace(str(tmp_path / str(k)), "") for l in lines
                   if "points/sec" not in l]
    assert logs[4] == logs[1]
    assert any(l.startswith("Training mean loss") for l in logs[1])


# -- the training CLI, summarize_model and the debug helpers ------------------

def test_train_cli_device_pipeline(tmp_path, monkeypatch):
    """One epoch of ``--data_pipeline device --gpu cpu`` with a superstep
    that fills once, then the best checkpoint served."""
    from tumseg_torch.cli import test as test_cli
    from tumseg_torch.cli import train as train_cli

    data = tmp_path / "data"
    data.mkdir()
    r = np.random.default_rng(0)
    for name, n in [("building.las", 12000), ("test_tile.las", 6000)]:
        xyz = np.stack([r.uniform(0, 4, n), r.uniform(0, 2, n),
                        r.uniform(0, 5, n)], 1)
        write_las(str(data / name), xyz, r.choice([1, 2, 3, 7], n))
    monkeypatch.chdir(tmp_path)
    common = ["--rootdir", str(data), "--test_area", "test_tile.las",
              "--class8", "--RGB_OFF", "--seed", "0", "--gpu", "cpu"]
    args = train_cli.parse_args(common + [
        "--exp_dir", str(tmp_path / "log"), "--log_dir", "run1", "--npoint",
        "256", "--batch_size", "4", "--epoch", "1", "--data_pipeline",
        "device", "--superstep", "4", "--visualizeModel", "yes"])
    acc, loss, iou = train_cli.main(args)
    assert len(acc) == 1 and math.isfinite(loss[0]) and 0 <= acc[0] <= 1
    run = tmp_path / "log" / "sem_seg" / "run1"
    text = (run / "logs" / "pointnet2_sem_seg.txt").read_text()
    assert "TOTAL" in text and "Training points/sec" in text
    out = test_cli.main(test_cli.parse_args(common + [
        "--exp_dir", str(tmp_path / "log" / "sem_seg") + "/", "--log_dir",
        "run1", "--num_point", "256", "--batch_size", "4", "--num_votes",
        "1"]))
    assert 0.0 <= out["miou"] <= 1.0


def test_data_pipeline_choice():
    from tumseg_torch.cli.train import uses_device_pipeline

    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert not uses_device_pipeline("auto", cpu)
    assert uses_device_pipeline("auto", cuda)
    assert uses_device_pipeline("device", cpu)
    assert not uses_device_pipeline("host", cuda)


def test_summarize_model_prints_tumseg_lines():
    from tumseg.models import pointnet2_sem_seg as jmodel
    from tumseg.utils import debug as jdebug
    from tumseg_torch.models.convert import (state_dict_from_variables,
                                             variables_from_state_dict)
    from tumseg_torch.utils import debug as tdebug

    var = jax.tree_util.tree_map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(0), C, 0))
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(var))
    want, got = [], []
    n_want = jdebug.summarize_model(var, log=want.append)
    n_got = tdebug.summarize_model(
        variables_from_state_dict(model.state_dict()), log=got.append)
    assert got == want and n_got == n_want
    assert n_got == sum(p.numel() for p in model.parameters())


def test_debug_helpers_match_tumseg():
    from tumseg.utils import debug as jdebug
    from tumseg_torch.utils import debug as tdebug

    tree = {"b": [np.ones(2), np.array([1.0, np.nan])],
            "a": {"w": np.zeros(3, np.float32), "n": np.arange(3)}}
    with pytest.raises(FloatingPointError) as want:
        jdebug.assert_finite(tree, "state")
    with pytest.raises(FloatingPointError) as got:
        tdebug.assert_finite(
            {"b": [torch.ones(2), torch.tensor([1.0, math.nan])],
             "a": {"w": torch.zeros(3), "n": torch.arange(3)}}, "state")
    assert str(got.value) == str(want.value)
    tdebug.assert_finite({"a": torch.ones(2)})
    assert tdebug.finite_fraction(torch.tensor([1.0, math.inf, 0.0, 2.0])) \
        == jdebug.finite_fraction(np.array([1.0, np.inf, 0.0, 2.0])) == 0.75

    class Engine:
        def train_batch(self, points, target, lr, momentum):
            return torch.tensor(points), torch.tensor(0)

    guard = tdebug.NanGuard(Engine())
    guard.train_batch(1.0, None, 0, 0)
    with pytest.raises(FloatingPointError, match="at step 2"):
        guard.train_batch(math.nan, None, 0, 0)

    x = torch.tensor([0.0], requires_grad=True)
    with tdebug.anomaly_detection():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).sum().backward()
    assert not torch.is_anomaly_enabled()
