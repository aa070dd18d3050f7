"""Numerical sanitizers and debug helpers (``tumseg/utils/debug.py``).

- ``assert_finite(tree, name)``: host-side check of nested dicts, lists and
  tuples of tensors or arrays;
- ``finite_fraction(x)``: the share of finite values;
- ``NanGuard(engine)``: wraps a TrainEngine's ``train_batch`` to read the
  loss back every step and raise with the step index on the first
  non-finite value;
- ``summarize_model(variables)``: parameters by top-level module, in
  ``tumseg``'s lines; feed it ``TrainEngine.variables()`` or
  ``variables_from_state_dict``;
- ``anomaly_detection()``: a context manager over
  ``torch.autograd.set_detect_anomaly``, the counterpart of
  ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch


def _leaves(tree, path=""):
    """(path, leaf) pairs with paths in ``jax.tree_util.keystr``'s form."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + "[%r]" % (key,))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, path + "[%d]" % i)
    elif tree is not None:
        yield path, tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def assert_finite(tree, name: str = "tree") -> None:
    bad = [path for path, leaf in _leaves(tree)
           if _numpy(leaf).dtype.kind == "f"
           and not np.isfinite(_numpy(leaf)).all()]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def finite_fraction(x) -> float:
    return float(np.isfinite(_numpy(x)).mean())


class NanGuard:
    """Wraps TrainEngine.train_batch with per-step loss validation."""

    def __init__(self, engine):
        self.engine = engine
        self.step = 0

    def train_batch(self, points, target, lr, momentum):
        loss, correct = self.engine.train_batch(points, target, lr, momentum)
        self.step += 1
        lv = float(loss)
        if not np.isfinite(lv):
            raise FloatingPointError(
                f"non-finite loss {lv} at step {self.step}")
        return loss, correct

    def __getattr__(self, name):
        return getattr(self.engine, name)


def summarize_model(variables, log=print) -> int:
    """Per-module parameter counts, ``tumseg``'s lines for the same
    weights. Returns the total parameter count."""
    totals = {}
    for path, leaf in _leaves(variables.get("params", variables)):
        top = path[:path.index("]") + 1].strip("[]'\"")
        totals[top] = totals.get(top, 0) + _numpy(leaf).size
    total = 0
    for name in sorted(totals):
        log("%-12s %10d params" % (name, totals[name]))
        total += totals[name]
    log("%-12s %10d params" % ("TOTAL", total))
    return total


@contextlib.contextmanager
def anomaly_detection() -> Iterator[None]:
    """Autograd's anomaly mode inside the block: a backward that produces
    NaN raises with the forward's traceback."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)
