"""``tumseg-ckpt-v2`` checkpoints with numpy alone
(``tumseg/train/checkpoint.py:155-214``), so a checkpoint moves between
``tumseg`` and the port in both directions.

The file is an ``.npz`` (never a pickle) holding a JSON manifest and one
array per leaf of the ``tumseg`` variables pytree, addressed by its path of
dict keys and list indices. The port converts those variables to and from
its ``state_dict`` with ``tumseg_torch.models.convert``. Optimizer state is
written empty until training is ported; saved optimizer leaves are read
back as a plain list.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

FORMAT = "tumseg-ckpt-v2"


def _flatten(tree, path=()):
    """(path, leaf) pairs in ``jax.tree_util`` order: dict keys sorted,
    list items in order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _flatten(item, path + (i,))
    else:
        yield list(path), np.asarray(tree)


def _unflatten(paths: List[List], arrays: List[np.ndarray]) -> Dict:
    root: Dict = {}
    for elems, arr in zip(paths, arrays):
        node = root
        for e, nxt in zip(elems[:-1], elems[1:]):
            if isinstance(node, list):
                while len(node) <= e:
                    node.append(None)
                if node[e] is None:
                    node[e] = [] if isinstance(nxt, int) else {}
                node = node[e]
            else:
                node = node.setdefault(e, [] if isinstance(nxt, int) else {})
        last = elems[-1]
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
        node[last] = arr
    return root


def save_checkpoint(path: str, *, epoch: int, variables: Dict,
                    class_avg_iou: Optional[float] = None) -> None:
    """Write ``variables`` (a ``tumseg`` pytree of arrays, e.g. from
    ``convert.variables_from_state_dict``) as a ``tumseg-ckpt-v2`` file."""
    model_flat = list(_flatten(variables))
    manifest = {
        "format": FORMAT,
        "epoch": int(epoch),
        "model_paths": [p for p, _ in model_flat],
        "n_opt_leaves": 0,
        "has_opt_state": False,
    }
    if class_avg_iou is not None:
        manifest["class_avg_iou"] = float(class_avg_iou)
    arrays = {"__manifest__": np.frombuffer(
        json.dumps(manifest).encode("utf-8"), dtype=np.uint8)}
    for i, (_, arr) in enumerate(model_flat):
        arrays[f"m{i}"] = arr
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    """-> {epoch, model_state_dict (the ``tumseg`` variables pytree of numpy
    arrays), optimizer_state_dict (list of leaves or None)[, class_avg_iou]}.
    Never unpickles."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:2] != b"PK":
        raise ValueError(
            f"{path} is not a {FORMAT} checkpoint (found a legacy pickle or "
            "unknown file). Re-save it with tools/convert_legacy_checkpoint.py "
            "in a trusted process; pickles are never loaded implicitly.")
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode("utf-8"))
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: unknown checkpoint format "
                             f"{manifest.get('format')!r}")
        paths = manifest["model_paths"]
        model = _unflatten(paths, [z[f"m{i}"] for i in range(len(paths))])
        opt = ([z[f"o{i}"] for i in range(manifest["n_opt_leaves"])]
               if manifest["has_opt_state"] else None)
    state = {"epoch": manifest["epoch"], "model_state_dict": model,
             "optimizer_state_dict": opt}
    if "class_avg_iou" in manifest:
        state["class_avg_iou"] = manifest["class_avg_iou"]
    return state
