"""The port's own copies of tumseg's framework-free host modules (LAS I/O,
datasets, geometric features, the batch loader, label tables, writers, CLI
plumbing, timing and progress) against their originals: each copy has the
original's code with its ``tumseg.*`` imports pointed at ``tumseg_torch.*``,
and on
the same seeded numpy inputs both give identical results: LAS files and
dataset pickles written by one package read the same in the other, and
blocks, grid cells, features and batches are equal."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from tumseg.data import dataset as jds
from tumseg.data import features as jfeat
from tumseg.data import las as jlas
from tumseg.data import loader as jloader
from tumseg.utils import labels as jlabels
from tumseg_torch.data import dataset as tds
from tumseg_torch.data import features as tfeat
from tumseg_torch.data import las as tlas
from tumseg_torch.data import loader as tloader
from tumseg_torch.utils import labels as tlabels

ROOT = Path(__file__).resolve().parents[1]
COPIES = ["utils/labels.py", "utils/timing.py", "utils/progress.py",
          "data/las.py", "data/dataset.py", "data/features.py",
          "data/loader.py", "viz/writers.py", "cli/common.py",
          "viz/pc_utils.py", "viz/show3d.py", "data/s3dis.py"]
# the viewer's native renderer and its build script, copied beside show3d
NATIVE_COPIES = ["viz/render_balls.cpp", "viz/build.sh"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _code(path: Path, rename: bool) -> str:
    """The module's syntax tree without docstrings, with ``tumseg.*``
    imports read as ``tumseg_torch.*`` when ``rename``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
        if (rename and isinstance(node, ast.ImportFrom) and node.module
                and node.module.startswith("tumseg.")):
            node.module = "tumseg_torch." + node.module[len("tumseg."):]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_original_with_port_imports(rel):
    """Same code as the original but for the imports; docstrings may
    differ."""
    assert _code(ROOT / "tumseg_torch" / rel, False) == \
        _code(ROOT / "tumseg" / rel, True)


@pytest.mark.parametrize("rel", NATIVE_COPIES)
def test_native_copy_is_the_original(rel):
    """The same source but for its ``//`` comments."""
    def code(path):
        return [line.split("//")[0].rstrip()
                for line in path.read_text().splitlines()]

    assert code(ROOT / "tumseg_torch" / rel) == code(ROOT / "tumseg" / rel)


def test_viewer_copy_renders_what_the_original_renders():
    """The copy builds its own renderer beside it and draws the original's
    frame."""
    from tumseg.viz import show3d as jshow
    from tumseg_torch.viz import show3d as tshow

    r = np.random.default_rng(5)
    xyz = r.standard_normal((300, 3)).astype(np.float32)
    colors = r.integers(0, 256, (300, 3)).astype(np.uint8)
    got = tshow.render_frame(xyz, colors, size=120, ballradius=3)
    assert tshow.BASE_DIR == str(ROOT / "tumseg_torch" / "viz")
    np.testing.assert_array_equal(
        got, jshow.render_frame(xyz, colors, size=120, ballradius=3))
    assert got.any()


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """Two tiles with colour, ~1500 points per m^2 (a 1 m block then holds
    the > 1024 points that block sampling waits for)."""
    d = tmp_path_factory.mktemp("tiles")
    r = np.random.default_rng(0)
    paths = []
    for name, n in [("a.las", 9000), ("b.las", 6000)]:
        xyz = np.stack([r.uniform(0, 3, n), r.uniform(0, 2, n),
                        r.uniform(0, 4, n)], 1)
        rgb = r.integers(0, 65536, (n, 3)).astype(np.uint16)
        jlas.write_las(str(d / name), xyz, r.choice([1, 2, 3, 6, 7, 13], n),
                       rgb=rgb)
        paths.append(str(d / name))
    return paths


@pytest.mark.parametrize("writer", ["tumseg", "port"])
def test_las_round_trips_between_packages(tmp_path, writer):
    r = np.random.default_rng(1)
    xyz = r.uniform(-5, 5, (500, 3))
    cls = r.integers(0, 20, 500)
    rgb = r.integers(0, 65536, (500, 3)).astype(np.uint16)
    write = (jlas if writer == "tumseg" else tlas).write_las
    write(str(tmp_path / "w.las"), xyz, cls, rgb=rgb)
    (tlas if writer == "tumseg" else jlas).write_las(
        str(tmp_path / "o.las"), xyz, cls, rgb=rgb)
    assert (tmp_path / "w.las").read_bytes() == \
        (tmp_path / "o.las").read_bytes()
    a, b = jlas.read_las(str(tmp_path / "w.las")), \
        tlas.read_las(str(tmp_path / "w.las"))
    np.testing.assert_array_equal(a.xyz, b.xyz)
    np.testing.assert_array_equal(a.classification, b.classification)
    assert a.point_format_dimensions == b.point_format_dimensions
    for dim in ("red", "green", "blue"):
        np.testing.assert_array_equal(getattr(a, dim), getattr(b, dim))


def test_train_block_sample_matches(tiles):
    kw = dict(num_classes=8, num_point=512, color=True, class8=True, seed=0)
    a = jds.TrainBlockDataset(tiles, [], **kw)
    b = tds.TrainBlockDataset(tiles, [], **kw)
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(a.calculate_labelweights(),
                                  b.calculate_labelweights())
    for idx in range(len(a)):
        pa, la = a.sample(idx, np.random.default_rng(idx))
        pb, lb = b.sample(idx, np.random.default_rng(idx))
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(la, lb)


def test_test_grid_structure_and_blocks_match(tiles):
    kw = dict(las_file_list=tiles, num_classes=8, block_points=512,
              color=False, class8=True, seed=3)
    a, b = jds.TestGridDataset(**kw), tds.TestGridDataset(**kw)
    for scene in range(len(tiles)):
        ca, cb = a.grid_structure(scene), b.grid_structure(scene)
        assert len(ca) == len(cb) > 0
        for (ia, *sa), (ib, *sb) in zip(ca, cb):
            np.testing.assert_array_equal(ia, ib)
            assert sa == sb
        for xa, xb in zip(a[scene], b[scene]):
            np.testing.assert_array_equal(xa, xb)


def test_geofeatures_match(tiles):
    kw = dict(num_classes=8, num_point=512, color=False, class8=True, seed=0)
    a = jds.TrainBlockDataset(tiles[1:], [], **kw)
    b = tds.TrainBlockDataset(tiles[1:], [], **kw)
    names = list(jfeat.GEO_FEATURE_NAMES)
    assert names == list(tfeat.GEO_FEATURE_NAMES)
    jfeat.attach_geofeatures(a, names)
    tfeat.attach_geofeatures(b, names)
    assert a.feature_name == b.feature_name == names
    assert a.num_extra_features == b.num_extra_features == 3
    for fa, fb in zip(a.extra_features_data, b.extra_features_data):
        assert len(fa) == len(fb) == 3
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)


def test_batch_loader_matches(tiles):
    kw = dict(num_classes=8, num_point=256, color=True, class8=True, seed=0)
    a = jds.TrainBlockDataset(tiles, [], **kw)
    b = tds.TrainBlockDataset(tiles, [], **kw)
    la = jloader.BatchLoader(a, batch_size=4, shuffle=True, num_workers=2,
                             seed=7)
    lb = tloader.BatchLoader(b, batch_size=4, shuffle=True, num_workers=2,
                             seed=7)
    assert len(la) == len(lb) > 0
    for (pa, ta), (pb, tb) in zip(la, lb):
        assert pa.shape == (4, 256, 9)
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ta, tb)


def test_label_tables_match():
    for class8 in (True, False):
        assert jlabels.class_tables(class8) == tlabels.class_tables(class8)
        assert jlabels.seg_label_to_cat(class8) == \
            tlabels.seg_label_to_cat(class8)
    assert jlabels.CLASSES_8 == tlabels.CLASSES_8
    assert jlabels.CLASSES_18 == tlabels.CLASSES_18
    raw = np.random.default_rng(2).choice([1, 2, 3, 5, 6, 7, 8, 11, 13,
                                           17], 1000)
    np.testing.assert_array_equal(jlabels.merge_to_8_classes(raw),
                                  tlabels.merge_to_8_classes(raw))
    hist = np.random.default_rng(3).integers(0, 500, 8).astype(np.float64)
    np.testing.assert_array_equal(jlabels.label_weights(hist),
                                  tlabels.label_weights(hist))


@pytest.mark.parametrize("kind", ["TrainBlockDataset", "TestGridDataset"])
@pytest.mark.parametrize("saver", ["tumseg", "port"])
def test_saved_dataset_loads_in_the_other_package(tiles, tmp_path, kind,
                                                  saver):
    if kind == "TrainBlockDataset":
        args = (tiles, [])
        kw = dict(num_classes=8, num_point=512, class8=True, seed=0)
    else:
        args = ()
        kw = dict(las_file_list=tiles, num_classes=8, block_points=512,
                  class8=True, seed=0)
    src, dst = (jds, tds) if saver == "tumseg" else (tds, jds)
    ds = getattr(src, kind)(*args, **kw)
    path = str(tmp_path / "ds.pkl")
    ds.save_data(path)
    back = getattr(dst, kind).load_data(path)
    assert type(back) is getattr(dst, kind)
    assert len(back) == len(ds)
    if kind == "TrainBlockDataset":
        np.testing.assert_array_equal(back.room_idxs, ds.room_idxs)
        for x, y in zip(back.sample(1, np.random.default_rng(4)),
                        ds.sample(1, np.random.default_rng(4))):
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_array_equal(back.labelweights, ds.labelweights)
        for x, y in zip(back.scene_points_list, ds.scene_points_list):
            np.testing.assert_array_equal(x, y)
