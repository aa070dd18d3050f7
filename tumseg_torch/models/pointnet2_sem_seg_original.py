"""Frozen variant ``pointnet2_sem_seg_original``
(``tumseg/models/pointnet2_sem_seg_original.py``): the SSG model with exactly
3 extra feature channels; see ``_frozen.py``."""

from tumseg_torch.models import _frozen
from tumseg_torch.models import pointnet2_sem_seg as _live

FIXED_EXTRA_FEATURES = 3

get_model = _frozen.pinned_get_model(
    _live.get_model, "pointnet2_sem_seg_original", FIXED_EXTRA_FEATURES)
