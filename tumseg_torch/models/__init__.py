"""Model registry with the names of ``tumseg/models/__init__.py``. Each
module exposes ``get_model(num_classes, num_extra_features)``. Names the
port does not hold yet raise ``NotImplementedError``."""

from __future__ import annotations

import importlib
from types import ModuleType

_ALIASES = {"pointnet2_sem_seg_geo_trial": "pointnet2_sem_seg"}

PORTED = ["pointnet2_sem_seg", "pointnet2_sem_seg_msg"]
AVAILABLE = ["pointnet2_sem_seg", "pointnet2_sem_seg_msg", "pointnet_sem_seg",
             "pointnet2_sem_seg_original", "pointnet2_sem_seg_trial",
             "pointnet_sem_seg_original"]


def get_module(name: str) -> ModuleType:
    name = _ALIASES.get(name, name)
    if name not in AVAILABLE:
        raise ValueError(f"unknown model {name!r}; available: {AVAILABLE}")
    if name not in PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to tumseg_torch yet (ROADMAP "
            f"Queue 1, item 3); ported: {PORTED}")
    return importlib.import_module(f"tumseg_torch.models.{name}")
