"""The reference's frozen model variants (``tumseg/models/_frozen.py``):
each pins the input channel contract that upstream's ``get_model``
hard-codes, so a variant builds the live architecture with one fixed
number of extra feature channels and rejects any other:

- ``pointnet2_sem_seg_original``: the SSG model with 3 extra channels;
- ``pointnet2_sem_seg_trial``: the SSG model with none;
- ``pointnet_sem_seg_original``: PointNet with 3.

``pointnet2_sem_seg_geo_trial`` has the live contract and stays a registry
alias."""

from __future__ import annotations


def pinned_get_model(live_get_model, frozen_name: str, fixed_extra: int):
    """-> ``get_model(num_classes, num_extra_features=fixed_extra)`` that
    builds ``live_get_model(num_classes, fixed_extra)`` and raises
    ``ValueError`` on any other count."""

    def get_model(num_classes: int, num_extra_features: int = fixed_extra):
        if int(num_extra_features) != fixed_extra:
            raise ValueError(
                f"model {frozen_name!r} is a frozen variant with a fixed "
                f"input contract of {fixed_extra} extra feature channels "
                f"(upstream pins the channel count in get_model); got "
                f"num_extra_features={num_extra_features}. Use the live "
                f"model for a configurable feature count.")
        return live_get_model(num_classes, fixed_extra)

    return get_model
