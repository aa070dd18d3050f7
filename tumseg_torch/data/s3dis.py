"""S3DIS room utilities (the reference's legacy models/indoor3d_util.py,
reimplemented working).

The reference carries these as dead code inherited from the Pointnet2
codebase — never imported by the live TUM-Facade pipeline, and with a broken
call in the grid path (`collect_point_label(limit[1] - ...)` where
`limit[1] - block_size` was meant, indoor3d_util.py:170, SURVEY §5.1.3).
This module provides the same capability surface, fixed and vectorized:

- annotation collection: per-instance txt -> one XYZRGBL array/file
- room -> overlapping/random blocks of exactly num_point points
- room -> sequential whole-room samples
- the "+normalized" variants appending x/max, y/max, z/max channels
  (the 9-channel S3DIS format the original PointNet++ used)
- instance bounding-box collection and .obj export helpers
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

S3DIS_CLASSES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "table",
    "chair", "sofa", "bookcase", "board", "clutter",
]
CLASS2LABEL = {c: i for i, c in enumerate(S3DIS_CLASSES)}
CLASS2COLOR = {
    "ceiling": [0, 255, 0], "floor": [0, 0, 255], "wall": [0, 255, 255],
    "beam": [255, 255, 0], "column": [255, 0, 255], "window": [100, 100, 255],
    "door": [200, 200, 100], "table": [170, 120, 200], "chair": [255, 0, 0],
    "sofa": [200, 100, 100], "bookcase": [10, 200, 100],
    "board": [200, 200, 200], "clutter": [50, 50, 50],
}
LABEL2COLOR = {i: CLASS2COLOR[c] for i, c in enumerate(S3DIS_CLASSES)}
EASY_VIEW_LABELS = [7, 8, 9, 10, 11, 1]


def collect_point_label(anno_path: str, out_filename: Optional[str] = None,
                        file_format: str = "txt") -> np.ndarray:
    """Aggregate per-instance annotation txts into one [N, 7] XYZRGBL array,
    shifted so the most negative corner is the origin; optionally saved as
    txt or .npy (indoor3d_util.py:34-75)."""
    rows = []
    for f in sorted(glob.glob(os.path.join(anno_path, "*.txt"))):
        cls = os.path.basename(f).split("_")[0]
        if cls not in CLASS2LABEL:  # e.g. the dataset's 'staris' typo
            cls = "clutter"
        points = np.loadtxt(f)
        labels = np.full((points.shape[0], 1), CLASS2LABEL[cls], dtype=np.float64)
        rows.append(np.concatenate([points, labels], axis=1))
    data_label = np.concatenate(rows, axis=0)
    data_label[:, 0:3] -= np.amin(data_label, axis=0)[0:3]

    if out_filename is not None:
        if file_format == "txt":
            np.savetxt(out_filename, data_label,
                       fmt="%f %f %f %d %d %d %d")
        elif file_format == "numpy":
            np.save(out_filename, data_label)
        else:
            raise ValueError(f"unknown file format {file_format}")
    return data_label


def sample_data(data: np.ndarray, num_sample: int,
                rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """Sample exactly num_sample rows, padding by random re-draws when short
    (indoor3d_util.py:118-133); returns (sampled, chosen indices)."""
    rng = rng or np.random
    n = data.shape[0]
    if n == num_sample:
        return data, np.arange(n)
    if n > num_sample:
        idx = rng.choice(n, num_sample, replace=False)
        return data[idx], idx
    makeup = rng.choice(n, num_sample - n)
    idx = np.concatenate([np.arange(n), makeup])
    return data[idx], idx


def sample_data_label(data, label, num_sample, rng=None):
    new_data, idx = sample_data(data, num_sample, rng=rng)
    return new_data, label[idx]


def room2blocks(data: np.ndarray, label: np.ndarray, num_point: int,
                block_size: float = 1.0, stride: float = 1.0,
                random_sample: bool = False, sample_num: Optional[int] = None,
                sample_aug: int = 1, rng=None):
    """Partition a shifted room into blocks of exactly num_point points
    (grid sweep or random corners); blocks with <100 points are discarded
    (indoor3d_util.py:140-209, with the broken grid-count expression fixed
    to `limit[1] - block_size`)."""
    assert stride <= block_size
    rng = rng or np.random
    limit = np.amax(data, axis=0)[0:3]

    xbeg_list, ybeg_list = [], []
    if not random_sample:
        num_block_x = int(np.ceil((limit[0] - block_size) / stride)) + 1
        num_block_y = int(np.ceil((limit[1] - block_size) / stride)) + 1
        for i in range(num_block_x):
            for j in range(num_block_y):
                xbeg_list.append(i * stride)
                ybeg_list.append(j * stride)
    else:
        num_block_x = int(np.ceil(limit[0] / block_size))
        num_block_y = int(np.ceil(limit[1] / block_size))
        if sample_num is None:
            sample_num = num_block_x * num_block_y * sample_aug
        for _ in range(sample_num):
            xbeg_list.append(rng.uniform(-block_size, limit[0]))
            ybeg_list.append(rng.uniform(-block_size, limit[1]))

    block_data_list, block_label_list = [], []
    for xbeg, ybeg in zip(xbeg_list, ybeg_list):
        cond = ((data[:, 0] >= xbeg) & (data[:, 0] <= xbeg + block_size)
                & (data[:, 1] >= ybeg) & (data[:, 1] <= ybeg + block_size))
        if np.sum(cond) < 100:
            continue
        block_data, block_label = sample_data_label(
            data[cond, :], label[cond], num_point, rng=rng)
        block_data_list.append(block_data[None])
        block_label_list.append(block_label[None])
    if not block_data_list:
        return (np.zeros((0, num_point, data.shape[1])),
                np.zeros((0, num_point), dtype=label.dtype))
    return np.concatenate(block_data_list, 0), np.concatenate(block_label_list, 0)


def _append_normalized(data_batch: np.ndarray, num_point: int, maxs,
                       center_xy: Optional[float]) -> np.ndarray:
    new_data_batch = np.zeros((data_batch.shape[0], num_point, 9))
    new_data_batch[:, :, 6] = data_batch[:, :, 0] / maxs[0]
    new_data_batch[:, :, 7] = data_batch[:, :, 1] / maxs[1]
    new_data_batch[:, :, 8] = data_batch[:, :, 2] / maxs[2]
    if center_xy is not None:
        mins = data_batch[:, :, :2].min(axis=1, keepdims=True)
        data_batch = data_batch.copy()
        data_batch[:, :, 0:2] -= mins + center_xy
    new_data_batch[:, :, 0:6] = data_batch[:, :, 0:6]
    return new_data_batch


def room2blocks_plus_normalized(data_label: np.ndarray, num_point: int,
                                block_size: float, stride: float,
                                random_sample: bool = False,
                                sample_num: Optional[int] = None,
                                sample_aug: int = 1, rng=None):
    """room2blocks with RGB/255 and x/max,y/max,z/max channels 6-8, xy
    centered per block (indoor3d_util.py:235-259)."""
    data = data_label[:, 0:6].copy()
    data[:, 3:6] /= 255.0
    label = data_label[:, -1].astype(np.uint8)
    maxs = data[:, 0:3].max(axis=0)
    data_batch, label_batch = room2blocks(
        data, label, num_point, block_size, stride, random_sample,
        sample_num, sample_aug, rng=rng)
    return (_append_normalized(data_batch, num_point, maxs, block_size / 2),
            label_batch)


def room2samples(data: np.ndarray, label: np.ndarray, sample_num_point: int,
                 rng=None):
    """Shuffle the room and cut it into ceil(N / P) samples of exactly P
    points, padding the tail with random re-draws (indoor3d_util.py:274-308)."""
    rng = rng or np.random
    N = data.shape[0]
    order = np.arange(N)
    rng.shuffle(order)
    data, label = data[order], label[order]

    batch_num = int(np.ceil(N / float(sample_num_point)))
    sample_datas = np.zeros((batch_num, sample_num_point, data.shape[1]))
    sample_labels = np.zeros((batch_num, sample_num_point, 1))
    for i in range(batch_num):
        beg, end = i * sample_num_point, min((i + 1) * sample_num_point, N)
        num = end - beg
        sample_datas[i, :num] = data[beg:end]
        sample_labels[i, :num, 0] = label[beg:end]
        if num < sample_num_point:
            makeup = rng.choice(N, sample_num_point - num)
            sample_datas[i, num:] = data[makeup]
            sample_labels[i, num:, 0] = label[makeup]
    return sample_datas, sample_labels


def room2samples_plus_normalized(data_label: np.ndarray, num_point: int,
                                 rng=None):
    data = data_label[:, 0:6].copy()
    data[:, 3:6] /= 255.0
    label = data_label[:, -1].astype(np.uint8)
    maxs = data[:, 0:3].max(axis=0)
    data_batch, label_batch = room2samples(data, label, num_point, rng=rng)
    return _append_normalized(data_batch, num_point, maxs, None), label_batch


def _load_data_label(path: str) -> np.ndarray:
    if path.endswith("txt"):
        return np.loadtxt(path)
    if path.endswith("npy"):
        return np.load(path)
    raise ValueError(f"unknown file type {path}")


def room2blocks_plus(data_label: np.ndarray, num_point: int,
                     block_size: float, stride: float,
                     random_sample: bool = False,
                     sample_num: Optional[int] = None,
                     sample_aug: int = 1, rng=None):
    """room2blocks with RGB scaled to [0,1] but without the normalized-xyz
    channels (indoor3d_util.py:212-221)."""
    data = data_label[:, 0:6].copy()
    data[:, 3:6] /= 255.0
    label = data_label[:, -1].astype(np.uint8)
    return room2blocks(data, label, num_point, block_size, stride,
                       random_sample, sample_num, sample_aug, rng=rng)


def room2blocks_wrapper(data_label_filename: str, num_point: int,
                        block_size: float = 1.0, stride: float = 1.0,
                        random_sample: bool = False,
                        sample_num: Optional[int] = None,
                        sample_aug: int = 1):
    """File-path front end for room2blocks_plus (indoor3d_util.py:223-233)."""
    return room2blocks_plus(_load_data_label(data_label_filename), num_point,
                            block_size, stride, random_sample, sample_num,
                            sample_aug)


def room2blocks_wrapper_normalized(data_label_filename: str, num_point: int,
                                   block_size: float = 1.0, stride: float = 1.0,
                                   random_sample: bool = False,
                                   sample_num: Optional[int] = None,
                                   sample_aug: int = 1):
    return room2blocks_plus_normalized(
        _load_data_label(data_label_filename), num_point, block_size, stride,
        random_sample, sample_num, sample_aug)


def room2samples_wrapper_normalized(data_label_filename: str, num_point: int):
    return room2samples_plus_normalized(_load_data_label(data_label_filename),
                                        num_point)


def collect_bounding_box(anno_path: str, out_filename: str) -> None:
    """Per-instance axis-aligned bboxes -> 'cls x1 y1 z1 x2 y2 z2' lines,
    shifted to the room origin (indoor3d_util.py:351-392)."""
    bboxes = []
    names = []
    for f in sorted(glob.glob(os.path.join(anno_path, "*.txt"))):
        cls = os.path.basename(f).split("_")[0]
        if cls not in CLASS2LABEL:
            cls = "clutter"
        points = np.loadtxt(f)[:, 0:3]
        bboxes.append(np.concatenate([points.min(0), points.max(0)]))
        names.append(cls)
    bboxes = np.array(bboxes)
    room_min = bboxes[:, 0:3].min(axis=0)
    bboxes[:, 0:3] -= room_min
    bboxes[:, 3:6] -= room_min
    with open(out_filename, "w") as f:
        for name, bb in zip(names, bboxes):
            f.write("%s %f %f %f %f %f %f\n" % (name, *bb))


def collect_point_bounding_box(anno_path: str, out_filename: str,
                               file_format: str = "txt") -> np.ndarray:
    """Per-point [XYZRGBL, offset to instance-bbox center, bbox half-dims]
    13-column table for one room, shifted to the room origin
    (indoor3d_util.py:393-458)."""
    rows = []
    for f in sorted(glob.glob(os.path.join(anno_path, "*.txt"))):
        cls = os.path.basename(f).split("_")[0]
        if cls not in CLASS2LABEL:
            cls = "clutter"
        points = np.loadtxt(f)
        xyz = points[:, 0:3]
        lo, hi = xyz.min(axis=0), xyz.max(axis=0)
        center, half = (lo + hi) / 2.0, (hi - lo) / 2.0
        n = points.shape[0]
        rows.append(np.concatenate([
            points,
            np.full((n, 1), CLASS2LABEL[cls], dtype=np.float64),
            center - xyz,                      # offsets to box center
            np.broadcast_to(half, (n, 3)),     # half-dimensions a, b, c
        ], axis=1))
    point_bbox = np.concatenate(rows, axis=0)
    point_bbox[:, 0:3] -= point_bbox[:, 0:3].min(axis=0)

    if file_format == "txt":
        np.savetxt(out_filename, point_bbox,
                   fmt="%f %f %f %d %d %d %d %f %f %f %f %f %f")
    elif file_format == "numpy":
        np.save(out_filename, point_bbox)
    else:
        raise ValueError(f"unknown file format {file_format}")
    return point_bbox


# Cube faces over corner-ordered vertices [(x,y,z+c),(x,y+b,z+c),(x+a,y+b,z+c),
# (x+a,y,z+c),(x,y,z),(x,y+b,z),(x+a,y+b,z),(x+a,y,z)] — the reference's
# exact face winding (indoor3d_util.py:435-441).
_BOX_CORNERS = np.array([
    [0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1],
    [0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0],
], dtype=np.float64)
_BOX_FACES = [(4, 3, 2, 1), (1, 2, 6, 5), (7, 6, 2, 3),
              (4, 8, 7, 3), (5, 8, 4, 1), (5, 6, 7, 8)]


def _write_box(fout_obj, fout_mtl, corner: np.ndarray, dims: np.ndarray,
               color, material: str, v_base: int) -> None:
    fout_obj.write("usemtl %s\n" % material)
    for v in corner + _BOX_CORNERS * dims:
        fout_obj.write("v %f %f %f\n" % tuple(v))
    fout_obj.write("g default\n")
    for face in _BOX_FACES:
        fout_obj.write("f %d %d %d %d\n" % tuple(i + v_base for i in face))
    fout_obj.write("\n")
    fout_mtl.write("newmtl %s\nKd %f %f %f\n\n" % (material, *color))


def bbox_label_to_obj(input_filename: str, out_filename_prefix: str,
                      easy_view: bool = False) -> None:
    """One colored-box .obj + .mtl pair per instance from 'x1 y1 z1 x2 y2 z2
    label' lines (indoor3d_util.py:393-460)."""
    bbox_label = np.atleast_2d(np.loadtxt(input_filename))
    labels = bbox_label[:, -1].astype(int)
    ins_cnt = 0
    for bb, label in zip(bbox_label[:, 0:6], labels):
        if easy_view and label not in EASY_VIEW_LABELS:
            continue
        stem = f"{out_filename_prefix}_{S3DIS_CLASSES[label]}_{ins_cnt}"
        color = np.array(LABEL2COLOR[label], dtype=float) / 255.0
        with open(stem + ".obj", "w") as fo, open(stem + ".mtl", "w") as fm:
            fo.write("mtllib %s\n" % os.path.basename(stem + ".mtl"))
            _write_box(fo, fm, bb[0:3], bb[3:6] - bb[0:3], color,
                       f"material{ins_cnt}", v_base=0)
        ins_cnt += 1


def bbox_label_to_obj_room(input_filename: str, out_filename_prefix: str,
                           easy_view: bool = False, permute=None,
                           center: bool = False,
                           exclude_table: bool = False) -> None:
    """All instance boxes of a room in one .obj + .mtl, with optional axis
    permutation and unit-centering (indoor3d_util.py:462-539)."""
    bbox_label = np.atleast_2d(np.loadtxt(input_filename))
    bbox = bbox_label[:, 0:6].copy()
    if permute is not None:
        assert len(permute) == 3
        permute = np.asarray(permute)
        bbox[:, 0:3] = bbox[:, permute]
        bbox[:, 3:6] = bbox[:, permute + 3]
    if center:
        xyz_max = bbox[:, 3:6].max(axis=0)
        bbox[:, 0:3] -= xyz_max / 2.0
        bbox[:, 3:6] -= xyz_max / 2.0
        bbox /= np.max(xyz_max / 2.0)
    labels = bbox_label[:, -1].astype(int)
    table_label = CLASS2LABEL["table"]
    with open(out_filename_prefix + ".obj", "w") as fo, \
            open(out_filename_prefix + ".mtl", "w") as fm:
        fo.write("mtllib %s\n"
                 % os.path.basename(out_filename_prefix + ".mtl"))
        v_cnt = ins_cnt = 0
        for bb, label in zip(bbox, labels):
            if easy_view and label not in EASY_VIEW_LABELS:
                continue
            if exclude_table and label == table_label:
                continue
            color = np.array(LABEL2COLOR[label], dtype=float) / 255.0
            _write_box(fo, fm, bb[0:3], bb[3:6] - bb[0:3], color,
                       f"material{ins_cnt}", v_base=v_cnt)
            v_cnt += 8
            ins_cnt += 1


def data_to_obj(data: np.ndarray, name: str = "example.obj",
                no_wall: bool = True) -> None:
    """XYZRGBL array -> .obj vertex dump with the points' own RGB, optionally
    skipping ceiling(0)/wall(2) (indoor3d_util.py:77-85)."""
    data = np.asarray(data)
    label = data[:, -1].astype(int)
    keep = np.ones(data.shape[0], dtype=bool)
    if no_wall:
        keep = (label != 2) & (label != 0)
    with open(name, "w") as fout:
        for row in data[keep]:
            fout.write("v %f %f %f %d %d %d\n" % tuple(row[0:6]))


def point_label_to_obj(input_filename: str, out_filename: str,
                       label_color: bool = True, easy_view: bool = False,
                       no_wall: bool = False) -> None:
    """XYZRGBL txt -> colored .obj vertex dump (indoor3d_util.py:87-116)."""
    data_label = _load_data_label(input_filename)
    data = data_label[:, 0:6]
    label = data_label[:, -1].astype(int)
    with open(out_filename, "w") as fout:
        for i in range(data.shape[0]):
            if easy_view and label[i] not in EASY_VIEW_LABELS:
                continue
            if no_wall and label[i] == 2:
                continue
            color = LABEL2COLOR[label[i]] if label_color else data[i, 3:6]
            fout.write("v %f %f %f %d %d %d\n"
                       % (data[i, 0], data[i, 1], data[i, 2],
                          color[0], color[1], color[2]))
