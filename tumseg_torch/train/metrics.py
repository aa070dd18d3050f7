"""Segmentation metric tallies (``tumseg/train/metrics.py``): per-class
[C] counts on the device, then the reference's IoU and accuracy formulas on
the host. ``tumseg.train`` imports JAX, so its numpy helpers are repeated
here rather than imported."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def confusion_tallies(pred: torch.Tensor, target: torch.Tensor,
                      num_classes: int) -> Dict[str, torch.Tensor]:
    """pred/target [...] int in [0, C) -> {seen, predicted, correct} [C]
    int64: ground-truth count, prediction count and hits per class. Counted
    by ``scatter_add_`` into fixed bins, a miss into an extra bin C that is
    dropped, so nothing has a data-dependent shape or reads back to the
    host (``torch.bincount`` does both on the card) and a CUDA graph can
    hold it."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    ones = torch.ones_like(target)

    def count(idx, bins):
        return torch.zeros(bins, dtype=torch.int64,
                           device=idx.device).scatter_add_(0, idx, ones)

    hits = torch.where(pred == target, target, num_classes)
    return {
        "seen": count(target, num_classes),
        "predicted": count(pred, num_classes),
        "correct": count(hits, num_classes + 1)[:num_classes],
    }


def iou_from_tallies(tallies) -> np.ndarray:
    """Per-class IoU with the reference's +1e-6 denominator smoothing."""
    seen = np.asarray(tallies["seen"], dtype=np.float64)
    predicted = np.asarray(tallies["predicted"], dtype=np.float64)
    correct = np.asarray(tallies["correct"], dtype=np.float64)
    return correct / (seen + predicted - correct + 1e-6)


def miou_from_tallies(tallies) -> float:
    return float(np.mean(iou_from_tallies(tallies)))


def accuracy_from_tallies(tallies, total_seen: int) -> float:
    return float(np.asarray(tallies["correct"]).sum() / float(total_seen))


def class_avg_accuracy(tallies) -> float:
    seen = np.asarray(tallies["seen"], dtype=np.float64)
    correct = np.asarray(tallies["correct"], dtype=np.float64)
    return float(np.mean(correct / (seen + 1e-6)))


def zero_tallies(num_classes: int) -> Dict[str, np.ndarray]:
    z = np.zeros(num_classes, dtype=np.int64)
    return {"seen": z.copy(), "predicted": z.copy(), "correct": z.copy()}


def accumulate(acc, tallies):
    """``acc[k] += tallies[k]`` for every tally, on the device and in place
    in ``acc`` (``tumseg/train/metrics.py:55-62``): no readback, so a CUDA
    graph can hold it. Returns ``acc``."""
    for k in acc:
        acc[k] = acc[k] + tallies[k]
    return acc


def accumulate_host(acc, tallies):
    """int64 host-side accumulation across scenes."""
    for k in acc:
        acc[k] = np.asarray(acc[k]) + np.asarray(
            torch.as_tensor(tallies[k]).cpu(), dtype=np.int64)
    return acc
