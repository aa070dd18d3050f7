"""The yardstick's arithmetic that every architecture shares: the H100's
peaks and the least time of a list of point-kernel launches. What a model
computes (its FLOPs a forward and a training step, and each launch's bytes
and operations from its shapes) is its architecture module's
(``reference/<architecture>.py``: ``forward_flops``, ``step_flops``,
``launches``).

Peaks: NVIDIA H100 SXM (80 GB HBM3, 700 W), dense: f32 outside the tensor
cores 67 TFLOP/s (the configurations keep TF32 off), HBM3 3.35 TB/s.

A launch's bound is the larger of its bytes over the HBM rate and its f32
operations over the f32 rate.
"""

from __future__ import annotations

from typing import Dict, List

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def cost(kernel, nbytes, ops):
    """One launch of ``kernel``: the bytes it moves and its operations."""
    return {"kernel": kernel, "nbytes": int(nbytes), "ops": int(ops)}


def bound_s(costs: List[Dict]) -> float:
    """Seconds that the launches take at the least: each launch's larger of
    bytes over the HBM rate and operations over the f32 rate."""
    return sum(max(c["nbytes"] / HBM_BYTES_PER_S, c["ops"] / F32_FLOPS_PER_S)
               for c in costs)
