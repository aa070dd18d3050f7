"""Training augmentation on device tensors (``tumseg/data/augment.py:219-249``).
The draws (angles, normal noise, scales, shifts) come from the caller, who
draws them from its own ``torch.Generator``, so a test can hand both
packages the same draws."""

from __future__ import annotations

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
