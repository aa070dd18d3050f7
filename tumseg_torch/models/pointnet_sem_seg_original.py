"""Frozen variant ``pointnet_sem_seg_original``
(``tumseg/models/pointnet_sem_seg_original.py``): the PointNet model with
exactly 3 extra feature channels; see ``_frozen.py``."""

from tumseg_torch.models import _frozen
from tumseg_torch.models import pointnet_sem_seg as _live

FIXED_EXTRA_FEATURES = 3

get_model = _frozen.pinned_get_model(
    _live.get_model, "pointnet_sem_seg_original", FIXED_EXTRA_FEATURES)
