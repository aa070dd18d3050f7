"""Point-cloud augmentations (``tumseg/data/augment.py``).

The tensor forms run on the device inside the train step: their draws
(angles, normal noise, scales, shifts) come from the caller, who draws them
from its own ``torch.Generator``, so a test can hand both packages the same
draws. The NumPy forms are ``tumseg``'s host versions of the reference's
``provider.py`` API, vectorized over the batch: each takes an ``rng``, a
``np.random.Generator`` (or the ``np.random`` module, the default), and on
the same Generator state gives ``tumseg``'s arrays bit for bit."""

from __future__ import annotations

import numpy as np
import torch


def rotate_z(batch_xyz: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """batch_xyz [B, N, 3], angles [B] radians -> [B, N, 3] rotated about z:
    ``xyz @ R`` with ``R = [[c, s, 0], [-s, c, 0], [0, 0, 1]]``, the matrix of
    ``tumseg``'s ``jrotate_z``."""
    c, s = torch.cos(angles), torch.sin(angles)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([
        torch.stack([c, s, zeros], -1),
        torch.stack([-s, c, zeros], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], -2)
    return torch.bmm(batch_xyz, rot)


def jitter(batch_data: torch.Tensor, noise: torch.Tensor, sigma: float = 0.01,
           clip: float = 0.05) -> torch.Tensor:
    """``batch + clip(sigma * noise, -clip, clip)`` for standard normal
    noise of the batch's shape (``jjitter``)."""
    return batch_data + torch.clamp(sigma * noise, -clip, clip)


def scale(batch_data: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[B, N, C] times one scale a cloud, scales [B] (``jscale``, whose
    draws are uniform in [0.8, 1.25))."""
    return batch_data * scales[:, None, None]


def shift(batch_data: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] plus one shift a cloud, shifts [B, 3] (``jshift``, whose
    draws are uniform in [-0.1, 0.1))."""
    return batch_data + shifts[:, None, :]


# --------------------------------------------------------------------------
# NumPy host versions (batch-vectorized), copied from tumseg
# --------------------------------------------------------------------------

def _rot_z(angles: np.ndarray) -> np.ndarray:
    """[B] angles -> [B, 3, 3] z-axis rotation matrices in the reference's
    (row-vector, provider.py:79-83) convention."""
    c, s = np.cos(angles), np.sin(angles)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, s, zeros], -1),
        np.stack([-s, c, zeros], -1),
        np.stack([zeros, zeros, ones], -1),
    ], -2)


def _rot_y(angles: np.ndarray) -> np.ndarray:
    c, s = np.cos(angles), np.sin(angles)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, zeros, s], -1),
        np.stack([zeros, ones, zeros], -1),
        np.stack([-s, zeros, c], -1),
    ], -2)


def rotate_point_cloud_z(batch_data, rng=None):
    """Random per-cloud rotation about +z (provider.py:66-84)."""
    rng = rng or np.random
    angles = rng.uniform(size=batch_data.shape[0]) * 2 * np.pi
    return np.einsum("bnc,bck->bnk", batch_data, _rot_z(angles)).astype(np.float32)


def rotate_point_cloud(batch_data, rng=None):
    """Random per-cloud rotation about +y / up (provider.py:46-64)."""
    rng = rng or np.random
    angles = rng.uniform(size=batch_data.shape[0]) * 2 * np.pi
    return np.einsum("bnc,bck->bnk", batch_data, _rot_y(angles)).astype(np.float32)


def rotate_point_cloud_by_angle(batch_data, rotation_angle):
    angles = np.full(batch_data.shape[0], rotation_angle)
    return np.einsum("bnc,bck->bnk", batch_data[..., :3], _rot_y(angles)
                     ).astype(np.float32)


def rotate_point_cloud_with_normal(batch_xyz_normal, rng=None):
    """Random per-cloud +y rotation of [B, N, 6] xyz+normal clouds; the same
    rotation is applied to both blocks (provider.py:86-104)."""
    rng = rng or np.random
    angles = rng.uniform(size=batch_xyz_normal.shape[0]) * 2 * np.pi
    rot = _rot_y(angles)
    out = np.asarray(batch_xyz_normal, dtype=np.float32).copy()
    out[..., :3] = np.einsum("bnc,bck->bnk", out[..., :3], rot)
    out[..., 3:6] = np.einsum("bnc,bck->bnk", out[..., 3:6], rot)
    return out


def rotate_point_cloud_by_angle_with_normal(batch_xyz_normal, rotation_angle):
    """Fixed-angle +y rotation of xyz+normal clouds (provider.py:152-174)."""
    angles = np.full(batch_xyz_normal.shape[0], rotation_angle)
    rot = _rot_y(angles)
    out = np.asarray(batch_xyz_normal, dtype=np.float32).copy()
    out[..., :3] = np.einsum("bnc,bck->bnk", out[..., :3], rot)
    out[..., 3:6] = np.einsum("bnc,bck->bnk", out[..., 3:6], rot)
    return out


def _perturbation_rots(B, angle_sigma, angle_clip, rng):
    """[B, 3, 3] small-euler perturbation matrices Rz @ Ry @ Rx
    (provider.py:176-198 convention), batch-vectorized."""
    draws = (rng.standard_normal((B, 3)) if hasattr(rng, "standard_normal")
             else rng.randn(B, 3))
    a = np.clip(angle_sigma * draws, -angle_clip, angle_clip)
    cx, sx = np.cos(a[:, 0]), np.sin(a[:, 0])
    cy, sy = np.cos(a[:, 1]), np.sin(a[:, 1])
    cz, sz = np.cos(a[:, 2]), np.sin(a[:, 2])
    zeros, ones = np.zeros(B), np.ones(B)
    Rx = np.stack([np.stack([ones, zeros, zeros], -1),
                   np.stack([zeros, cx, -sx], -1),
                   np.stack([zeros, sx, cx], -1)], -2)
    Ry = np.stack([np.stack([cy, zeros, sy], -1),
                   np.stack([zeros, ones, zeros], -1),
                   np.stack([-sy, zeros, cy], -1)], -2)
    Rz = np.stack([np.stack([cz, -sz, zeros], -1),
                   np.stack([sz, cz, zeros], -1),
                   np.stack([zeros, zeros, ones], -1)], -2)
    return Rz @ Ry @ Rx


def rotate_perturbation_point_cloud_with_normal(batch_data, angle_sigma=0.06,
                                                angle_clip=0.18, rng=None):
    """Small random euler perturbations of xyz+normal clouds
    (provider.py:106-131)."""
    rng = rng or np.random
    rot = _perturbation_rots(batch_data.shape[0], angle_sigma, angle_clip, rng)
    out = np.asarray(batch_data, dtype=np.float32).copy()
    out[..., :3] = np.einsum("bnc,bck->bnk", out[..., :3], rot)
    out[..., 3:6] = np.einsum("bnc,bck->bnk", out[..., 3:6], rot)
    return out


def rotate_perturbation_point_cloud(batch_data, angle_sigma=0.06,
                                    angle_clip=0.18, rng=None):
    """Small random xyz-euler perturbations (provider.py:176-198)."""
    rng = rng or np.random
    B = batch_data.shape[0]
    out = np.empty_like(batch_data, dtype=np.float32)
    for k in range(B):
        a = np.clip(angle_sigma * rng.standard_normal(3) if hasattr(rng, "standard_normal")
                    else angle_sigma * rng.randn(3), -angle_clip, angle_clip)
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]])
        Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])],
                       [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]])
        Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                       [np.sin(a[2]), np.cos(a[2]), 0],
                       [0, 0, 1]])
        out[k] = batch_data[k] @ (Rz @ Ry @ Rx)
    return out


def jitter_point_cloud(batch_data, sigma=0.01, clip=0.05, rng=None):
    """Per-point gaussian jitter, clipped (provider.py:201-212)."""
    assert clip > 0
    rng = rng or np.random
    noise = np.clip(sigma * (rng.standard_normal(batch_data.shape)
                             if hasattr(rng, "standard_normal")
                             else rng.randn(*batch_data.shape)),
                    -clip, clip)
    return batch_data + noise


def shift_point_cloud(batch_data, shift_range=0.1, rng=None):
    """Per-cloud xyz shift (provider.py:214-225)."""
    rng = rng or np.random
    shifts = rng.uniform(-shift_range, shift_range, (batch_data.shape[0], 3))
    return batch_data + shifts[:, None, :]


def random_scale_point_cloud(batch_data, scale_low=0.8, scale_high=1.25,
                             rng=None):
    """Per-cloud isotropic scale (provider.py:228-239)."""
    rng = rng or np.random
    scales = rng.uniform(scale_low, scale_high, batch_data.shape[0])
    return batch_data * scales[:, None, None]


def random_point_dropout(batch_pc, max_dropout_ratio=0.875, rng=None):
    """Replace a random subset of each cloud with its first point
    (provider.py:241-248)."""
    rng = rng or np.random
    out = batch_pc.copy()
    for b in range(batch_pc.shape[0]):
        ratio = rng.random() * max_dropout_ratio
        drop = np.flatnonzero(rng.random(batch_pc.shape[1]) <= ratio)
        if drop.size:
            out[b, drop, :] = out[b, 0, :]
    return out


def shuffle_data(data, labels, rng=None):
    """Shuffle clouds and labels together (provider.py:22-32)."""
    rng = rng or np.random
    idx = np.arange(len(labels))
    rng.shuffle(idx)
    return data[idx, ...], labels[idx], idx


def shuffle_points(batch_data, rng=None):
    """Shuffle point order (same permutation batch-wide, provider.py:34-44)."""
    rng = rng or np.random
    idx = np.arange(batch_data.shape[1])
    rng.shuffle(idx)
    return batch_data[:, idx, :]


def random_point_cloud_crop(points, num_points, rng=None):
    """Random subset of exactly num_points rows
    (reference localfunctions.py:133-139)."""
    assert points.shape[0] >= num_points, (
        "Number of points in the point cloud should be greater than or "
        "equal to num_points.")
    rng = rng or np.random
    indices = rng.choice(points.shape[0], num_points, replace=False)
    return points[indices]


def normalize_data(batch_data):
    """Center each cloud and scale to the unit sphere (provider.py:3-19)."""
    centroid = batch_data.mean(axis=1, keepdims=True)
    pc = batch_data - centroid
    m = np.sqrt((pc ** 2).sum(-1)).max(axis=1)
    return pc / m[:, None, None]
