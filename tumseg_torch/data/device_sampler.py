"""The device training pipeline's block sampler (``tumseg/data/device_sampler.py``).

The rooms' columns are uploaded once, as ``tumseg`` uploads them; each train
step then sends only ``[B]`` room ids, and block selection and featurization
run on the device. The semantics are those of ``TrainBlockDataset.sample``:

1. a uniform random point of the room is the block centre;
2. the centre is redrawn until the 1 m x 1 m xy block around it holds more
   than ``min_block_points`` points (strict ``>``);
3. ``num_point`` members are drawn, without replacement when the block has
   at least ``num_point`` points and with replacement otherwise;
4. featurization in f32: ``[x-cx, y-cy, z, x/max_x, y/max_y, z/max_z,
   extras]``, colour extras pre-scaled by 1/255.

The tables are ``tumseg``'s, built by the same numpy code: each room's
points sorted by a ``0.6 * block_size`` xy bin grid, so a bin is a
contiguous slice of the payload and a block is covered by the 3 x 3 bins
around its centre (``9 * cap`` candidates, ``cap`` the largest bin). Given
the same draws, every step below is ``tumseg``'s bit for bit.

The rejection loop is ``tumseg``'s ``lax.while_loop``, run in rounds: each
pending row draws ``trials`` centres at once, every candidate block is
counted in one batched pass, and each row takes its first accepted trial
(the first acceptance among i.i.d. trials has the loop's distribution).
Only rows with no accepted trial draw another round, so a round costs one
readback of ``[rows]`` booleans. A room with more than
``min_block_points`` points but no block that holds more loops forever, as
in ``tumseg``.

The draws come from explicit uniforms (:meth:`DeviceBlockSampler.
sample_from_draws`, which a test feeds ``tumseg``'s own) or from one
``torch.Generator`` a batch (:meth:`DeviceBlockSampler.sample_batches`),
which draws, per round, ``[pending, trials]`` centre uniforms, then
``[B, 9 * cap]`` selection and ``[B, num_point]`` replacement uniforms.
The rounds (:meth:`DeviceBlockSampler.accept`) read back; the selection
(:meth:`DeviceBlockSampler.draw_select`) does not, so the training engine
captures it in its step's CUDA graph.

On a ``data`` mesh (``tumseg_torch.parallel``) every rank builds all the
tables, replicated as ``tumseg`` replicates them (``P()``), and samples only
its ``B / size`` rows of each batch's room ids, from generators of its own
(the engine seeds them from ``(seed, step, rank)``); a round's readback is
the rank's own, with no collective.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from tumseg_torch.data.dataset import _COLOR_FEATURES
from tumseg_torch.utils.profiling import readback, span, upload

_BIN_FRACTION = 0.6   # bin width / block_size; must be > 0.5 for coverage
_CAP_GRANULE = 256    # bin capacity rounded up, as in tumseg
# centres a pending row draws a round: on an H100 a batch samples in about
# the same time with 1 to 4 (PERF.md), and 4 keep second rounds under 1%
# of rows down to an acceptance of 0.69
TRIALS = 4
_CHUNK = 1 << 24      # candidates one counting pass holds at once
# the 3 x 3 bin neighbourhood in tumseg's order: dx outer, dy inner
_DX = (-1, -1, -1, 0, 0, 0, 1, 1, 1)
_DY = (-1, 0, 1, -1, 0, 1, -1, 0, 1)


class RoomBatch:
    """A batch that exists only as room ids: the engine samples the blocks
    on the device."""

    __slots__ = ("room_ids",)

    def __init__(self, room_ids: np.ndarray):
        self.room_ids = room_ids


class DeviceSampleLoader:
    """Epoch iterator over a TrainBlockDataset's sample list that yields
    :class:`RoomBatch` (int32 ``[B]`` room ids). The order is
    ``BatchLoader``'s and ``tumseg``'s: a fresh seeded shuffle an epoch,
    ``drop_last`` semantics."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: Optional[int] = None):
        self.room_idxs = np.asarray(dataset.room_idxs, dtype=np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._epoch = 0

    def __len__(self):
        n = self.room_idxs.shape[0]
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        self._epoch += 1
        n = self.room_idxs.shape[0]
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(
                None if self._seed is None else self._seed + self._epoch)
            rng.shuffle(order)
        stop = (n - n % self.batch_size) if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            yield RoomBatch(self.room_idxs[order[s:s + self.batch_size]])


class DeviceBlockSampler:
    """Once-uploaded room tables on ``device`` and the batched sampler."""

    def __init__(self, room_points: Sequence[np.ndarray],
                 room_labels: Sequence[np.ndarray],
                 room_extras: Sequence[Sequence[np.ndarray]],
                 color_flags: Sequence[bool], num_point: int,
                 block_size: float = 1.0, min_block_points: int = 1024,
                 device="cuda"):
        self.device = torch.device(device)
        self.num_point = int(num_point)
        self.block_size = float(block_size)
        self.min_block_points = int(min_block_points)
        self.num_extra_features = len(color_flags)
        self.trials = TRIALS
        # rows sampled, rows that needed a second round, rounds
        self.stats = {"rows": 0, "redrawn": 0, "rounds": 0}

        w = _BIN_FRACTION * self.block_size
        xyz_parts, lab_parts, ext_parts = [], [], []
        room_start, room_count = [], []
        room_cmin, room_cmax = [], []
        room_nbx, room_nby, room_bin_off = [], [], []
        bin_start_all: List[np.ndarray] = []
        bin_count_all: List[np.ndarray] = []
        off = 0
        bin_off = 0
        cap = 1
        for r in range(len(room_points)):
            pts = np.asarray(room_points[r], dtype=np.float64)[:, :3]
            n = pts.shape[0]
            if n <= self.min_block_points:
                # no block of this room can hold more points than the room:
                # the rejection loop would never end
                raise ValueError(
                    "room %d has %d points <= min_block_points=%d; the "
                    "device rejection sampler could never accept a block "
                    "from it and would hang the dispatch. Drop the room "
                    "or lower min_block_points." % (r, n,
                                                    self.min_block_points))
            cmin = pts.min(axis=0)
            cmax = pts.max(axis=0)
            nbx = int(np.floor((cmax[0] - cmin[0]) / w)) + 1
            nby = int(np.floor((cmax[1] - cmin[1]) / w)) + 1
            bx = np.clip(np.floor((pts[:, 0] - cmin[0]) / w).astype(np.int64),
                         0, nbx - 1)
            by = np.clip(np.floor((pts[:, 1] - cmin[1]) / w).astype(np.int64),
                         0, nby - 1)
            bid = bx * nby + by
            order = np.argsort(bid, kind="stable")
            counts = np.bincount(bid, minlength=nbx * nby)
            cap = max(cap, int(counts.max()))
            starts = np.zeros(nbx * nby, dtype=np.int64)
            starts[1:] = np.cumsum(counts)[:-1]

            xyz_parts.append(pts[order].astype(np.float32))
            lab_parts.append(
                np.asarray(room_labels[r], dtype=np.int64)[order].astype(
                    np.int32))
            if self.num_extra_features:
                cols = []
                for i, is_color in enumerate(color_flags):
                    col = np.asarray(room_extras[r][i], dtype=np.float64)
                    if is_color:
                        col = col / 255.0
                    cols.append(col[order].astype(np.float32))
                ext_parts.append(np.stack(cols, axis=1))

            room_start.append(off)
            room_count.append(n)
            room_cmin.append(cmin[:2].astype(np.float32))
            room_cmax.append(cmax.astype(np.float32))
            room_nbx.append(nbx)
            room_nby.append(nby)
            room_bin_off.append(bin_off)
            bin_start_all.append(starts + off)
            bin_count_all.append(counts)
            off += n
            bin_off += nbx * nby

        # 9 * cap >= num_point, so a draw without replacement always fits
        cap = max(cap, -(-self.num_point // 9))
        self.cap = int(np.ceil(cap / _CAP_GRANULE) * _CAP_GRANULE)
        # cap rows of padding at +1e9, inside no block: a bin's window of
        # cap rows never runs off the end
        pad = np.full((self.cap, 3), 1e9, np.float32)
        xyz_flat = np.concatenate(xyz_parts + [pad])
        # one packed row table [xyz | extras | label as f32] is the only
        # full table of points; x and y planes feed the counting pass
        packed = [xyz_flat]
        if self.num_extra_features:
            packed.append(np.concatenate(
                ext_parts + [np.zeros((self.cap, self.num_extra_features),
                                      np.float32)]))
        lab_np = np.concatenate(lab_parts + [np.zeros(self.cap, np.int32)])
        packed.append(lab_np.astype(np.float32)[:, None])

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        i64, f32 = torch.int64, torch.float32
        self._packed = put(np.concatenate(packed, axis=1), f32)
        self._px = put(np.ascontiguousarray(xyz_flat[:, 0]), f32)
        self._py = put(np.ascontiguousarray(xyz_flat[:, 1]), f32)
        self._room_start = put(room_start, i64)
        self._room_count = put(room_count, i64)
        self._room_cmin = put(np.stack(room_cmin), f32)
        self._room_cmax = put(np.stack(room_cmax), f32)
        self._room_nbx = put(room_nbx, i64)
        self._room_nby = put(room_nby, i64)
        self._room_bin_off = put(room_bin_off, i64)
        self._bin_start = put(np.concatenate(bin_start_all), i64)
        self._bin_count = put(np.concatenate(bin_count_all), i64)
        # divisors and offsets as device tensors: a division by a host
        # scalar may become a multiplication by its reciprocal on the card
        self._bin_w = torch.tensor(w, dtype=f32, device=self.device)
        self._half = torch.tensor(self.block_size / 2.0, dtype=f32,
                                  device=self.device)
        self._dx = put(_DX, i64)
        self._dy = put(_DY, i64)
        self._lane = torch.arange(self.cap, device=self.device)

    @property
    def _xyz(self):
        return self._packed[:, :3]

    @property
    def _extra(self):
        return self._packed[:, 3:3 + self.num_extra_features]

    @property
    def _labels(self):
        return self._packed[:, 3 + self.num_extra_features].long()

    def table_bytes(self) -> int:
        """Bytes the tables hold on the device."""
        return sum(t.numel() * t.element_size() for t in (
            self._packed, self._px, self._py, self._room_start,
            self._room_count, self._room_cmin, self._room_cmax,
            self._room_nbx, self._room_nby, self._room_bin_off,
            self._bin_start, self._bin_count))

    @classmethod
    def from_dataset(cls, dataset, min_block_points: int = 1024,
                     device="cuda") -> "DeviceBlockSampler":
        """Build from a TrainBlockDataset (split copies share the room
        arrays, so one sampler serves every split's room ids)."""
        color_flags = [n in _COLOR_FEATURES for n in dataset.feature_name]
        return cls(dataset.room_points, dataset.room_labels,
                   dataset.extra_features_data, color_flags,
                   num_point=dataset.num_point,
                   block_size=dataset.block_size,
                   min_block_points=min_block_points, device=device)

    # -- the draw-consuming core ---------------------------------------------

    def _bins(self, rid, cx, cy):
        """Payload starts and counts [M, 9] of the 3 x 3 bins around the
        centres (cx, cy) [M] of rooms rid [M]."""
        nbx = self._room_nbx[rid][:, None]
        nby = self._room_nby[rid][:, None]
        bx = torch.floor((cx - self._room_cmin[rid, 0]) / self._bin_w)
        by = torch.floor((cy - self._room_cmin[rid, 1]) / self._bin_w)
        bx = torch.minimum(bx.to(torch.int64).clamp_min(0)[:, None], nbx - 1)
        by = torch.minimum(by.to(torch.int64).clamp_min(0)[:, None], nby - 1)
        jx, jy = bx + self._dx, by + self._dy
        ok = (jx >= 0) & (jy >= 0) & (jx < nbx) & (jy < nby)
        g = torch.where(ok, self._room_bin_off[rid][:, None] + jx * nby + jy,
                        0)
        return (torch.where(ok, self._bin_start[g], 0),
                torch.where(ok, self._bin_count[g], 0))

    def _inside(self, starts, counts, cx, cy):
        """Block membership [M, 9 * cap] of the bins' candidate rows."""
        px = self._px.unfold(0, self.cap, 1)[starts]        # [M, 9, cap]
        py = self._py.unfold(0, self.cap, 1)[starts]
        cx, cy = cx[:, None, None], cy[:, None, None]
        inside = ((self._lane < counts[..., None])
                  & (px >= cx - self._half) & (px <= cx + self._half)
                  & (py >= cy - self._half) & (py <= cy + self._half))
        return inside.reshape(starts.shape[0], -1)

    def _candidates(self, rid, cx, cy):
        """(idx [M, 9 * cap] payload rows, inside [M, 9 * cap]): tumseg's
        ``_candidates``, batched over M centres."""
        starts, counts = self._bins(rid, cx, cy)
        idx = (starts[..., None] + self._lane).reshape(starts.shape[0], -1)
        return idx, self._inside(starts, counts, cx, cy)

    def trial_blocks(self, rid, u):
        """Trial centres [M, 3] and their blocks' counts [M] for rooms rid
        [M] and centre uniforms u [M]: the centre is point
        ``min(int(u * count), count - 1)`` of the room."""
        count = self._room_count[rid]
        t = torch.minimum((u * count.float()).to(torch.int64), count - 1)
        center = self._xyz[self._room_start[rid] + t]
        cnt = torch.empty(rid.shape[0], dtype=torch.int64, device=self.device)
        step = max(1, _CHUNK // (9 * self.cap))
        for s in range(0, rid.shape[0], step):
            r, c = rid[s:s + step], center[s:s + step]
            starts, counts = self._bins(r, c[:, 0], c[:, 1])
            cnt[s:s + step] = self._inside(starts, counts, c[:, 0],
                                           c[:, 1]).sum(1)
        return center, cnt

    def _first_accepted(self, rid, trial_u):
        """Each row's first accepted trial of trial_u [R, T]: (centre [R,
        3], count [R], accepted [R])."""
        R, T = trial_u.shape
        center, cnt = self.trial_blocks(rid.repeat_interleave(T),
                                        trial_u.reshape(-1))
        ok = (cnt > self.min_block_points).view(R, T)
        first = torch.where(ok, torch.arange(T, device=self.device), T)
        first = first.min(1).values.clamp_max(T - 1)
        rows = torch.arange(R, device=self.device) * T + first
        return center[rows], cnt[rows], ok.any(1)

    def select(self, rid, center, cnt, sel_u, rep_u):
        """Members and features of the accepted blocks: (points [R, P,
        6 + E] f32, labels [R, P] int64, sel [R, P] payload rows) from the
        selection uniforms sel_u [R, 9 * cap] and the replacement uniforms
        rep_u [R, P]."""
        P = self.num_point
        idx, inside = self._candidates(rid, center[:, 0], center[:, 1])
        # ascending by (uniform if inside else 2), stable like lax.sort: the
        # block's members first in uniform random order, so the first P are
        # a draw without replacement and floor(u * cnt) one with it
        order = torch.sort(torch.where(inside, sel_u, 2.0), dim=1,
                           stable=True).indices
        ranked = idx.gather(1, order)
        r = torch.minimum((rep_u * cnt[:, None].float()).to(torch.int64),
                          cnt[:, None] - 1)
        sel = torch.where((cnt >= P)[:, None], ranked[:, :P],
                          ranked.gather(1, r))
        rows = self._packed[sel]                        # [R, P, 4 + E]
        pts = rows[..., :3]
        feats = [pts[..., :2] - center[:, None, :2], pts[..., 2:3],
                 pts / self._room_cmax[rid][:, None, :]]
        if self.num_extra_features:
            feats.append(rows[..., 3:3 + self.num_extra_features])
        labels = rows[..., 3 + self.num_extra_features].long()
        return torch.cat(feats, dim=-1), labels, sel

    def sample_from_draws(self, room_ids, trial_u, sel_u, rep_u):
        """(points, labels, centres, counts, sel) for room ids [R] from
        explicit draws: trial_u [R, T] centre uniforms (each row takes its
        first accepted trial; a row that accepts none raises), sel_u [R,
        9 * cap] and rep_u [R, P]."""
        rid = torch.as_tensor(room_ids, device=self.device).long()
        center, cnt, accepted = self._first_accepted(
            rid, torch.as_tensor(trial_u, device=self.device))
        if not bool(accepted.all()):
            raise ValueError("a row accepted none of its %d trial centres"
                             % trial_u.shape[1])
        points, labels, sel = self.select(
            rid, center, cnt, torch.as_tensor(sel_u, device=self.device),
            torch.as_tensor(rep_u, device=self.device))
        return points, labels, center, cnt, sel

    # -- the generator path --------------------------------------------------

    def accept(self, room_ids_k, generators):
        """The rejection rounds of k batches, batch i drawing its centre
        uniforms from ``generators[i]``: (rid [k * B] int64, centres [k * B,
        3], counts [k * B]). Each round reads back one ``[rows]`` bool, so
        this part stays outside a CUDA graph. Under a profiler it is the
        span ``tumseg.sampler.accept``, each readback ``tumseg.readback``
        and each upload ``tumseg.upload``."""
        with span("tumseg.sampler.accept"):
            rid = upload(np.asarray(room_ids_k), self.device).long()
            k, B = rid.shape
            rid = rid.reshape(-1)
            center = torch.empty(k * B, 3, device=self.device)
            cnt = torch.empty(k * B, dtype=torch.int64, device=self.device)
            pending = np.arange(k * B)      # flat rows, so grouped by batch
            rounds = 0
            while pending.size:
                batch = pending // B
                u = torch.cat([torch.rand(int((batch == i).sum()),
                                          self.trials,
                                          generator=generators[i],
                                          device=self.device)
                               for i in np.unique(batch)])
                rows = upload(pending, self.device)
                c, n, ok = self._first_accepted(rid[rows], u)
                center[rows] = c
                cnt[rows] = n
                ok = readback(ok).numpy()           # the round's readback
                if rounds == 0:
                    self.stats["redrawn"] += int((~ok).sum())
                rounds += 1
                pending = pending[~ok]
            self.stats["rows"] += k * B
            self.stats["rounds"] += rounds
        return rid, center, cnt

    def draw_select(self, rid, center, cnt, generators):
        """The accepted blocks of :meth:`accept` drawn and featurized:
        (points [k, B, P, 6 + E], labels [k, B, P], sel [k, B, P]). Each
        generator draws its batch's ``[B, 9 * cap]`` selection uniforms,
        then each its ``[B, P]`` replacement uniforms; no readback, so a
        CUDA graph can hold it."""
        k, P = len(generators), self.num_point
        B = rid.shape[0] // k
        sel_u = torch.cat([torch.rand(B, 9 * self.cap, generator=g,
                                      device=self.device) for g in generators])
        rep_u = torch.cat([torch.rand(B, P, generator=g, device=self.device)
                           for g in generators])
        points, labels, sel = self.select(rid, center, cnt, sel_u, rep_u)
        return (points.view(k, B, P, -1), labels.view(k, B, P),
                sel.view(k, B, P))

    def sample_batches_aux(self, room_ids_k, generators):
        """k batches at once, batch i drawn from ``generators[i]``: (points
        [k, B, P, 6 + E], labels [k, B, P], centres [k, B, 3], counts [k,
        B], sel [k, B, P]). Each generator sees the draws that it would see
        sampling its batch alone, so this equals k calls of
        :meth:`sample_batch_aux`; the k batches share one readback a
        round."""
        rid, center, cnt = self.accept(room_ids_k, generators)
        k = len(generators)
        points, labels, sel = self.draw_select(rid, center, cnt, generators)
        return (points, labels, center.view(k, -1, 3), cnt.view(k, -1), sel)

    def sample_batches(self, room_ids_k, generators):
        """(points [k, B, P, 6 + E] f32, labels [k, B, P] int64)."""
        return self.sample_batches_aux(room_ids_k, generators)[:2]

    def sample_batch_aux(self, room_ids, generator):
        """One batch: (points [B, P, 6 + E], labels [B, P], centres [B, 3],
        counts [B], sel [B, P])."""
        out = self.sample_batches_aux(np.asarray(room_ids)[None], [generator])
        return tuple(t[0] for t in out)

    def sample_batch(self, room_ids, generator):
        """(points [B, P, 6 + E] f32, labels [B, P] int64)."""
        return self.sample_batch_aux(room_ids, generator)[:2]


def sample_blocks(sampler: DeviceBlockSampler, generator, room_ids):
    """Standalone entry for tools: one batch from ``generator``."""
    return sampler.sample_batch(room_ids, generator)
