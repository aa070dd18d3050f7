"""Model registry with the names of ``tumseg/models/__init__.py``, and the
port's own ``pointnext_sem_seg`` (PointNeXt-XL, which ``tumseg`` lacks).
Each module exposes ``get_model(num_classes, num_extra_features)``."""

from __future__ import annotations

import importlib
from types import ModuleType

_ALIASES = {"pointnet2_sem_seg_geo_trial": "pointnet2_sem_seg"}

AVAILABLE = ["pointnet2_sem_seg", "pointnet2_sem_seg_msg", "pointnet_sem_seg",
             "pointnet2_sem_seg_original", "pointnet2_sem_seg_trial",
             "pointnet_sem_seg_original", "pointnext_sem_seg"]


def get_module(name: str) -> ModuleType:
    name = _ALIASES.get(name, name)
    if name not in AVAILABLE:
        raise ValueError(f"unknown model {name!r}; available: {AVAILABLE}")
    return importlib.import_module(f"tumseg_torch.models.{name}")
