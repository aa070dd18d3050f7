"""Training augmentation on device tensors (``tumseg/data/augment.py:219-231``).
The angles come from the caller, who draws them from its own
``torch.Generator``, so a test can hand both packages the same angles."""

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
