"""Host-side datasets: random-block training sampler and whole-scene
sliding-grid test blocker.

Behavior parity:
- TrainBlockDataset mirrors TrainCustomDataset
  (the reference's sem_seg_training.py:92-324): LAS ingest, optional 18->8
  class merge, point-count-proportional room sampling, rejection-sampled
  1 m x 1 m blocks of exactly ``num_point`` points, the 6 base channels
  [x-cx, y-cy, z, x/max_x, y/max_y, z/max_z] (z is NOT centered and the
  normalized channels divide by the room max only — bit-for-bit with
  reference :224-231), extra named features (RGB scaled by /255), pickleable,
  ``copy(indices)``, cube-root label weights.
- TestGridDataset mirrors TestCustomDataset (sem_seg_testing.py:87-345):
  stride-0.5 overlapping grid with 0.001 padding, per-block point-count
  padded to a multiple of ``block_points`` by random re-draws, shuffled fill,
  ground-truth label weights as the vote gate (kept for CLI parity; see
  infer.voting for the GT-leak discussion).
- ``filtered_update`` is implemented as the evidently-intended
  ``index_update(filtered_indices())`` — the reference calls a method it
  never defined (sem_seg_training.py:470, SURVEY §5.1.1).

This layer is deliberately NumPy-on-host: block extraction is irregular
gather work; devices only ever see fixed-shape [B, num_point, C] batches.
"""

from __future__ import annotations

import pickle
import threading
from typing import List, Optional, Sequence

import numpy as np

from tumseg_torch.data.las import read_las
from tumseg_torch.utils.labels import label_weights, merge_to_8_classes

_COLOR_FEATURES = ("red", "blue", "green")


def _load_rooms(las_file_list: Sequence[str], feature_names: List[str],
                class8: bool):
    """Read LAS tiles -> (points, labels, extra feature columns) per room."""
    room_points, room_labels, room_features = [], [], []
    for path in las_file_list:
        print("Reading = " + str(path))
        las = read_las(path)
        coords = las.xyz
        labels = np.array(las.classification, dtype=np.int64)
        feats = [np.asarray(getattr(las, name), dtype=np.float64)
                 for name in feature_names]
        if class8:
            labels = merge_to_8_classes(labels)
        room_points.append(coords)
        room_labels.append(labels.astype(np.int64))
        room_features.append(feats)
    return room_points, room_labels, room_features


def _resolve_features(feature_list: Optional[List[str]], color: bool):
    """Reference semantics: RGB names are appended to the user list when
    color is on (sem_seg_training.py:125-128)."""
    names = list(feature_list or [])
    if color:
        names += list(_COLOR_FEATURES)
    return names


class TrainBlockDataset:
    """Random 1 m x 1 m block sampler over multiple LAS rooms."""

    def __init__(self, las_file_list=None, feature_list=None, num_classes=8,
                 num_point=4096, block_size=1.0, sample_rate=1.0,
                 transform=None, indices=None, color=True, class8=True,
                 seed: Optional[int] = None):
        self.num_point = num_point
        self.block_size = block_size
        self.transform = transform
        self.num_classes = num_classes
        self.room_points: List[np.ndarray] = []
        self.room_labels: List[np.ndarray] = []
        self.room_coord_min: List[np.ndarray] = []
        self.room_coord_max: List[np.ndarray] = []
        self.extra_features_data: List[List[np.ndarray]] = []
        self.feature_name: List[str] = []
        self.num_extra_features = 0
        self.non_index: List[int] = []
        self._rng = np.random.default_rng(seed)

        if las_file_list is None:
            self.room_idxs = np.array([], dtype=np.int64)
            return

        self.feature_name = _resolve_features(feature_list, color)
        self.num_extra_features = len(self.feature_name)

        rooms = sorted(str(p) for p in las_file_list)
        self.room_points, self.room_labels, self.extra_features_data = (
            _load_rooms(rooms, self.feature_name, class8))

        num_point_all = []
        for pts, labels in zip(self.room_points, self.room_labels):
            self.room_coord_min.append(np.amin(pts, axis=0))
            self.room_coord_max.append(np.amax(pts, axis=0))
            num_point_all.append(labels.size)

        sample_prob = np.asarray(num_point_all) / np.sum(num_point_all)
        num_iter = int(np.sum(num_point_all) * sample_rate / num_point)
        room_idxs = []
        for index in range(len(rooms)):
            room_idxs.extend([index] * int(round(sample_prob[index] * num_iter)))
        self.room_idxs = np.array(room_idxs, dtype=np.int64)
        if indices is not None:
            self.room_idxs = self.room_idxs[np.asarray(indices)]

        print("Extra features to be included = %d" % self.num_extra_features)
        print("Totally {} samples in dataset.".format(len(self.room_idxs)))

    def __len__(self):
        return len(self.room_idxs)

    def __getitem__(self, idx):
        return self.sample(idx, self._rng)

    def sample(self, idx, rng: np.random.Generator):
        """__getitem__ with an explicit Generator, so multi-worker loaders
        can derive a per-(seed, epoch, idx) stream and stay deterministic
        regardless of thread scheduling."""
        room_idx = int(self.room_idxs[idx])
        points = self.room_points[room_idx]
        labels = self.room_labels[room_idx]
        n_points = points.shape[0]
        half = self.block_size / 2.0

        # rejection-sample a block center until >1024 points fall inside
        # (reference sem_seg_training.py:207-216)
        while True:
            center = points[int(rng.integers(n_points))][:3]
            block_min = center[:2] - half
            block_max = center[:2] + half
            inside = ((points[:, 0] >= block_min[0]) & (points[:, 0] <= block_max[0])
                      & (points[:, 1] >= block_min[1]) & (points[:, 1] <= block_max[1]))
            point_idxs = np.flatnonzero(inside)
            if point_idxs.size > 1024:
                break

        replace = point_idxs.size < self.num_point
        selected = rng.choice(point_idxs, self.num_point, replace=replace)

        sel_pts = points[selected]
        cmax = self.room_coord_max[room_idx]
        feats = np.zeros((self.num_point, 6 + self.num_extra_features),
                         dtype=np.float64)
        feats[:, 0] = sel_pts[:, 0] - center[0]
        feats[:, 1] = sel_pts[:, 1] - center[1]
        feats[:, 2] = sel_pts[:, 2]
        feats[:, 3] = sel_pts[:, 0] / cmax[0]
        feats[:, 4] = sel_pts[:, 1] / cmax[1]
        feats[:, 5] = sel_pts[:, 2] / cmax[2]

        for i, name in enumerate(self.feature_name):
            col = self.extra_features_data[room_idx][i][selected]
            if name in _COLOR_FEATURES:
                col = col / 255.0
            feats[:, 6 + i] = col

        cur_labels = labels[selected]
        if self.transform is not None:
            feats, cur_labels = self.transform(feats, cur_labels)
        return feats, cur_labels

    def calculate_labelweights(self) -> np.ndarray:
        print("Calculate Weights")
        hist = np.zeros(self.num_classes)
        for labels in self.room_labels:
            tmp, _ = np.histogram(labels, range(self.num_classes + 1))
            hist += tmp
        print(hist)
        weights = label_weights(hist)
        print(weights)
        return weights

    def filtered_indices(self):
        total = set(range(len(self.room_points)))
        return sorted(total - set(self.non_index))

    def index_update(self, new_indices):
        self.room_idxs = np.asarray(new_indices, dtype=np.int64)

    def filtered_update(self, new_indices=None):
        """The reference calls this without defining it
        (sem_seg_training.py:470); intended behavior: drop samples whose room
        is in ``non_index``."""
        keep_rooms = set(self.filtered_indices())
        mask = np.isin(self.room_idxs, sorted(keep_rooms))
        self.room_idxs = self.room_idxs[mask]

    def copy(self, indices=None) -> "TrainBlockDataset":
        out = TrainBlockDataset()
        out.num_point = self.num_point
        out.block_size = self.block_size
        out.transform = self.transform
        out.num_classes = self.num_classes
        out.room_points = list(self.room_points)
        out.room_labels = list(self.room_labels)
        out.room_coord_min = list(self.room_coord_min)
        out.room_coord_max = list(self.room_coord_max)
        out.num_extra_features = self.num_extra_features
        # fresh list containers so later per-split feature attachment
        # (attach_geofeatures) cannot cross-pollute the other split
        out.extra_features_data = [list(f) for f in self.extra_features_data]
        out.feature_name = list(self.feature_name)
        if indices is not None:
            out.room_idxs = self.room_idxs[np.asarray(indices)]
        else:
            out.room_idxs = self.room_idxs.copy()
        print("Totally {} samples in dataset.".format(len(out.room_idxs)))
        return out

    def save_data(self, file_path):
        state = self.__dict__.copy()
        state.pop("_rng", None)
        with open(file_path, "wb") as f:
            pickle.dump(state, f)

    @staticmethod
    def load_data(file_path) -> "TrainBlockDataset":
        with open(file_path, "rb") as f:
            state = pickle.load(f)
        out = TrainBlockDataset()
        out.__dict__.update(state)
        out._rng = np.random.default_rng()
        print("Extra features to be included = %d" % out.num_extra_features)
        print("Number of Classes in dataset = %d" % out.num_classes)
        print("Totally {} samples in dataset.".format(len(out.room_idxs)))
        return out


class TestGridDataset:
    """Whole-scene sliding-window blocker for voting inference."""

    __test__ = False  # not a pytest class despite the name

    def __init__(self, root=None, las_file_list=None, feature_list=None,
                 num_classes=8, block_points=4096, stride=0.5, block_size=1.0,
                 padding=0.001, color=True, class8=True,
                 seed: Optional[int] = None):
        self.block_points = block_points
        self.block_size = block_size
        self.padding = padding
        self.stride = stride
        self.num_classes = num_classes
        self.file_list = list(las_file_list or [])
        self.scene_points_list: List[np.ndarray] = []
        self.semantic_labels_list: List[np.ndarray] = []
        self.scene_points_num: List[int] = []
        self.room_coord_min: List[np.ndarray] = []
        self.room_coord_max: List[np.ndarray] = []
        self.extra_features_data: List[List[np.ndarray]] = []
        self.feature_name: List[str] = []
        self.num_extra_features = 0
        self.non_index: List[int] = []
        self._rng = np.random.default_rng(seed)

        if not self.file_list:
            self.labelweights = np.ones(num_classes, dtype=np.float32)
            return

        import os

        paths = [os.path.join(root, f) if root and not os.path.isabs(str(f))
                 and not os.path.exists(str(f)) else str(f)
                 for f in self.file_list]
        self.feature_name = _resolve_features(feature_list, color)
        self.num_extra_features = len(self.feature_name)
        self.scene_points_list, self.semantic_labels_list, \
            self.extra_features_data = _load_rooms(paths, self.feature_name,
                                                   class8)
        for pts in self.scene_points_list:
            self.room_coord_min.append(np.amin(pts, axis=0)[:3])
            self.room_coord_max.append(np.amax(pts, axis=0)[:3])
        assert len(self.scene_points_list) == len(self.semantic_labels_list)

        hist = np.zeros(num_classes)
        for seg in self.semantic_labels_list:
            tmp, _ = np.histogram(seg, range(num_classes + 1))
            self.scene_points_num.append(seg.shape[0])
            hist += tmp
        self.labelweights = label_weights(hist)

    def __len__(self):
        return len(self.scene_points_list)

    def grid_structure(self, index):
        """The DETERMINISTIC part of the sliding-grid blocking, cached per
        scene: a list of (point_idxs sorted-ascending, s_x, s_y) per
        non-empty grid cell. Only the shortfall fill + shuffle are stochastic
        per vote (grid_indices), so re-blocking every vote no longer re-pays
        the binning/argsort/inside tests. The cache keys on the scene array's
        identity, so index_update/copy (which rebuild the lists) invalidate
        naturally."""
        # setdefault: atomic under the GIL — run_testing's prefetch thread
        # may call this concurrently with the main thread for different
        # scenes, and a check-then-assign lazy init could orphan whichever
        # dict lost the race (recomputing the ~0.7 s/1M-pt gridding the
        # prefetch exists to hide)
        cache = self.__dict__.setdefault("_grid_cache", {})
        hit = cache.get(index)
        if hit is not None and hit[0] is self.scene_points_list[index]:
            return hit[1]

        points = self.scene_points_list[index][:, :3]
        coord_min = np.amin(points, axis=0)[:3]
        coord_max = np.amax(points, axis=0)[:3]
        grid_x = int(np.ceil((coord_max[0] - coord_min[0] - self.block_size)
                             / self.stride) + 1)
        grid_y = int(np.ceil((coord_max[1] - coord_min[1] - self.block_size)
                             / self.stride) + 1)

        # stride-sized spatial bins so each cell tests only its candidate
        # superset instead of the whole scene: the naive per-cell masks are
        # O(cells x N) and dominated whole-scene serving (~5 s/vote at 1M
        # points). Bin membership is a superset by construction; the exact
        # inside test below reproduces the original point_idxs bit-for-bit.
        nbx = int(np.floor((coord_max[0] - coord_min[0]) / self.stride)) + 1
        nby = int(np.floor((coord_max[1] - coord_min[1]) / self.stride)) + 1
        bx = np.minimum((points[:, 0] - coord_min[0]) // self.stride,
                        nbx - 1).astype(np.int64)
        by = np.minimum((points[:, 1] - coord_min[1]) // self.stride,
                        nby - 1).astype(np.int64)
        bin_ids = bx * nby + by
        order = np.argsort(bin_ids, kind="stable")  # ascending idx per bin
        sorted_ids = bin_ids[order]
        bounds = np.searchsorted(sorted_ids, np.arange(nbx * nby + 1))

        def candidates(s_x, e_x, s_y, e_y):
            bx0 = max(int((s_x - self.padding - coord_min[0]) // self.stride), 0)
            bx1 = min(int((e_x + self.padding - coord_min[0]) // self.stride),
                      nbx - 1)
            by0 = max(int((s_y - self.padding - coord_min[1]) // self.stride), 0)
            by1 = min(int((e_y + self.padding - coord_min[1]) // self.stride),
                      nby - 1)
            parts = [order[bounds[b * nby + by0]:bounds[b * nby + by1 + 1]]
                     for b in range(bx0, bx1 + 1)]
            return np.sort(np.concatenate(parts)) if parts else order[:0]

        cells = []
        for index_y in range(grid_y):
            for index_x in range(grid_x):
                s_x = coord_min[0] + index_x * self.stride
                e_x = min(s_x + self.block_size, coord_max[0])
                s_x = e_x - self.block_size
                s_y = coord_min[1] + index_y * self.stride
                e_y = min(s_y + self.block_size, coord_max[1])
                s_y = e_y - self.block_size
                cand = candidates(s_x, e_x, s_y, e_y)
                px, py = points[cand, 0], points[cand, 1]
                inside = ((px >= s_x - self.padding) & (px <= e_x + self.padding)
                          & (py >= s_y - self.padding) & (py <= e_y + self.padding))
                point_idxs = cand[inside]
                if point_idxs.size == 0:
                    continue
                cells.append((point_idxs, s_x, s_y))

        # bounded cache: scenes are processed sequentially and run_testing
        # prefetches scene N+1 while N is voting, so keep only the inserted
        # scene's immediate neighbours — per-cell index lists duplicate
        # overlapping stride cells (several bytes/point/overlap) and an
        # unbounded dict would grow with dataset size. Neighbour keys are
        # never evicted by each other, so the prefetch win is preserved.
        # Lock: the prefetch thread builds scene N+1 while the main thread
        # builds N; an insert during the eviction list-comp's iteration
        # would raise "dictionary changed size during iteration", so
        # insert+evict are one critical section (reads stay lockless).
        lock = self.__dict__.setdefault("_grid_cache_lock", threading.Lock())
        with lock:
            cache[index] = (self.scene_points_list[index], cells)
            for stale in [k for k in cache if abs(k - index) > 1]:
                del cache[stale]
        return cells

    def grid_indices(self, index):
        """The sliding-grid blocking WITHOUT feature assembly: returns
        (point_idxs [n_blocks, block_points] int64, offsets [n_blocks, 2]
        float64 = each block's (s_x, s_y) corner). Consumes the same RNG
        draws in the same order as __getitem__, which builds its features
        from this. The device featurizer (infer.voting) uses it to avoid
        shipping 9-channel float blocks through the slow host->TPU link —
        only these indices travel per vote."""
        index_blocks, offsets = [], []
        for point_idxs, s_x, s_y in self.grid_structure(index):
            num_batch = int(np.ceil(point_idxs.size / self.block_points))
            point_size = int(num_batch * self.block_points)
            shortfall = point_size - point_idxs.size
            replace = shortfall > point_idxs.size
            repeat = self._rng.choice(point_idxs, shortfall, replace=replace)
            point_idxs = np.concatenate((point_idxs, repeat))
            self._rng.shuffle(point_idxs)
            index_blocks.append(point_idxs.reshape(-1, self.block_points))
            offsets.append(np.repeat([[s_x, s_y]], num_batch, axis=0))

        return (np.concatenate(index_blocks, axis=0),
                np.concatenate(offsets, axis=0))

    def __getitem__(self, index):
        points = self.scene_points_list[index][:, :3]
        labels = self.semantic_labels_list[index]
        coord_max = np.amax(points, axis=0)[:3]
        extra_num = self.num_extra_features

        idx_blocks, offsets = self.grid_indices(index)
        data_blocks, label_blocks, weight_blocks = [], [], []
        for point_idxs, (s_x, s_y) in zip(idx_blocks, offsets):
            data_batch = points[point_idxs, :].copy()
            point_size = point_idxs.size
            normalized = np.zeros((point_size, 3))
            normalized[:, 0] = data_batch[:, 0] / coord_max[0]
            normalized[:, 1] = data_batch[:, 1] / coord_max[1]
            normalized[:, 2] = data_batch[:, 2] / coord_max[2]
            data_batch[:, 0] -= s_x + self.block_size / 2.0
            data_batch[:, 1] -= s_y + self.block_size / 2.0
            data_batch = np.concatenate((data_batch, normalized), axis=1)
            label_batch = labels[point_idxs].astype(int)
            batch_weight = self.labelweights[label_batch]

            if extra_num > 0:
                extra_cols = np.zeros((point_size, extra_num))
                for ix in range(extra_num):
                    name = self.feature_name[ix]
                    col = self.extra_features_data[index][ix][point_idxs]
                    if name in _COLOR_FEATURES:
                        col = col / 255.0
                    extra_cols[:, ix] = col
                data_batch = np.concatenate((data_batch, extra_cols), axis=1)

            data_blocks.append(data_batch)
            label_blocks.append(label_batch)
            weight_blocks.append(batch_weight)

        data_room = np.concatenate(data_blocks, axis=0)
        label_room = np.concatenate(label_blocks, axis=0)
        sample_weight = np.concatenate(weight_blocks, axis=0)

        nf = data_room.shape[1]
        return (data_room.reshape(-1, self.block_points, nf),
                label_room.reshape(-1, self.block_points),
                sample_weight.reshape(-1, self.block_points),
                idx_blocks.copy())

    def filtered_indices(self):
        total = set(range(len(self.scene_points_list)))
        return sorted(total - set(self.non_index))

    def _subset_scene_state(self, idxs):
        """Per-scene lists that must stay aligned with scene_points_list.

        The reference has a latent bug here: its TestCustomDataset.copy
        subsets points/labels only, so extra_features_data / file_list keep
        the old indexing (sem_seg_testing.py:286-310) — it never fires there
        because filtered_update doesn't exist, but our working geofeature
        path (features.attach_geofeatures) does call index_update, so we
        subset everything and remap non_index.
        """
        n = len(self.scene_points_list)
        picked = [int(i) for i in idxs]
        out = {
            "scene_points_list": [self.scene_points_list[i] for i in picked],
            "semantic_labels_list": [self.semantic_labels_list[i]
                                     for i in picked],
        }
        for attr in ("extra_features_data", "file_list",
                     "room_coord_min", "room_coord_max"):
            vals = getattr(self, attr)
            out[attr] = ([vals[i] for i in picked] if len(vals) == n
                         else list(vals))
        old2new = {old: new for new, old in enumerate(picked)}
        out["non_index"] = sorted(old2new[i] for i in self.non_index
                                  if i in old2new)
        return out

    def index_update(self, new_indices):
        for attr, val in self._subset_scene_state(new_indices).items():
            setattr(self, attr, val)
        self.labelweights, self.scene_points_num = self._recompute_weights()

    def filtered_update(self, new_indices=None):
        self.index_update(self.filtered_indices())

    def _recompute_weights(self):
        hist = np.zeros(self.num_classes)
        nums = []
        for seg in self.semantic_labels_list:
            tmp, _ = np.histogram(seg, range(self.num_classes + 1))
            nums.append(seg.shape[0])
            hist += tmp
        return label_weights(hist), nums

    def calculate_labelweights(self):
        print("Calculate Weights")
        weights, nums = self._recompute_weights()
        print(weights)
        assert len(weights) == self.num_classes
        return weights, nums

    def copy(self, new_indices=None) -> "TestGridDataset":
        out = TestGridDataset()
        for attr in ["block_points", "block_size", "padding", "stride",
                     "num_classes", "num_extra_features"]:
            setattr(out, attr, getattr(self, attr))
        out.feature_name = list(self.feature_name)
        idxs = (list(range(len(self.scene_points_list)))
                if new_indices is None else new_indices)
        for attr, val in self._subset_scene_state(idxs).items():
            setattr(out, attr, val)
        # fresh per-scene containers so later feature attachment on one copy
        # cannot cross-pollute the other
        out.extra_features_data = [list(f) for f in out.extra_features_data]
        out.labelweights, out.scene_points_num = out._recompute_weights()
        return out

    def save_data(self, file_path):
        state = self.__dict__.copy()
        state.pop("_rng", None)
        state.pop("_grid_cache", None)  # derived; rebuilt lazily
        state.pop("_grid_cache_lock", None)  # unpicklable; remade lazily
        with open(file_path, "wb") as f:
            pickle.dump(state, f)

    @staticmethod
    def load_data(file_path) -> "TestGridDataset":
        with open(file_path, "rb") as f:
            state = pickle.load(f)
        out = TestGridDataset()
        out.__dict__.update(state)
        out._rng = np.random.default_rng()
        return out
