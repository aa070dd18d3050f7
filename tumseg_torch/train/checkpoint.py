"""``tumseg-ckpt-v2`` checkpoints with numpy alone
(``tumseg/train/checkpoint.py:155-214``), so a checkpoint moves between
``tumseg`` and the port in both directions.

The file is an ``.npz`` (never a pickle) holding a JSON manifest and one
array per leaf of the ``tumseg`` variables pytree, addressed by its path of
dict keys and list indices. The port converts those variables to and from
its ``state_dict`` with ``tumseg_torch.models.convert``.

Optimizer state is stored as ``tumseg``'s optax leaves in tree order
(``o0``, ``o1``, ...): for Adam ``count``, then every first moment ``mu``,
then every second moment ``nu``; for SGD the momentum trace. Each tree of
moments is laid out like ``tumseg``'s params (dict keys sorted, dense
kernels ``[in, out]``), so :func:`optimizer_leaves` and
:func:`load_optimizer_leaves` move torch's ``exp_avg`` / ``exp_avg_sq`` /
``momentum_buffer`` through ``convert`` exactly as the weights move.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from tumseg_torch.models.convert import (state_dict_from_variables,
                                         variables_from_state_dict)

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


def _moment_tree(model: torch.nn.Module, values: Dict[str, torch.Tensor]):
    """``tumseg`` params tree of one optimizer moment: ``values`` maps each
    parameter name to a tensor of the parameter's shape (zeros where a name
    is missing)."""
    sd = dict(model.state_dict())
    for name, p in model.named_parameters():
        sd[name] = values.get(name, torch.zeros_like(p))
    return variables_from_state_dict(sd)["params"]


def optimizer_leaves(optimizer: torch.optim.Optimizer,
                     model: torch.nn.Module) -> List[np.ndarray]:
    """``optimizer``'s state over ``model``'s parameters as ``tumseg``'s
    optax leaves (Adam: count, mu..., nu...; SGD: trace...)."""
    names = {p: n for n, p in model.named_parameters()}

    def tree(field):
        values = {names[p]: st[field] for p, st in optimizer.state.items()
                  if st.get(field) is not None}
        return [a for _, a in _flatten(_moment_tree(model, values))]

    if isinstance(optimizer, torch.optim.Adam):
        steps = [int(st["step"]) for st in optimizer.state.values()
                 if "step" in st]
        count = np.asarray(max(steps, default=0), dtype=np.int32)
        return [count] + tree("exp_avg") + tree("exp_avg_sq")
    if isinstance(optimizer, torch.optim.SGD):
        return tree("momentum_buffer")
    raise TypeError(f"no tumseg layout for {type(optimizer).__name__} state")


def load_optimizer_leaves(optimizer: torch.optim.Optimizer,
                          model: torch.nn.Module, leaves: List) -> None:
    """Set ``optimizer``'s state from ``tumseg``'s optax leaves (the inverse
    of :func:`optimizer_leaves`)."""
    template = variables_from_state_dict(model.state_dict())
    paths = [p for p, _ in _flatten(template["params"])]
    n = len(paths)
    adam = isinstance(optimizer, torch.optim.Adam)
    want = 1 + 2 * n if adam else n
    if len(leaves) != want:
        raise ValueError(
            f"optimizer state has {len(leaves)} saved leaves but "
            f"{type(optimizer).__name__} over this model expects {want}: "
            "optimizer or model changed since the checkpoint was written")

    def torch_layout(arrays):
        sd = state_dict_from_variables({
            "params": _unflatten(paths, list(arrays)),
            "batch_stats": template["batch_stats"]})
        return {name: sd[name].to(p.device)
                for name, p in model.named_parameters()}

    params = dict(model.named_parameters())
    if adam:
        step = torch.tensor(float(np.asarray(leaves[0])), dtype=torch.float32)
        # a capturable Adam keeps its step count on the parameter's device
        capturable = optimizer.param_groups[0].get("capturable", False)
        mu, nu = torch_layout(leaves[1:1 + n]), torch_layout(leaves[1 + n:])
        for name, p in params.items():
            optimizer.state[p] = {
                "step": step.to(p.device) if capturable else step.clone(),
                "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    else:
        trace = torch_layout(leaves)
        for name, p in params.items():
            optimizer.state[p] = {"momentum_buffer": trace[name]}


def save_checkpoint(path: str, *, epoch: int, variables: Dict,
                    opt_leaves: Optional[List[np.ndarray]] = None,
                    class_avg_iou: Optional[float] = None,
                    mesh=None) -> None:
    """Write ``variables`` (a ``tumseg`` pytree of arrays, e.g. from
    ``convert.variables_from_state_dict``) and the optimizer leaves of
    :func:`optimizer_leaves`, if any, as a ``tumseg-ckpt-v2`` file. On a
    ``mesh``, whose ranks hold the same replicated state, rank 0 writes the
    file once and every rank returns after it has, so any rank may read it
    next."""
    if mesh is not None:
        if mesh.rank == 0:
            save_checkpoint(path, epoch=epoch, variables=variables,
                            opt_leaves=opt_leaves,
                            class_avg_iou=class_avg_iou)
        mesh.barrier()
        return
    model_flat = list(_flatten(variables))
    opt_leaves = [] if opt_leaves is None else list(opt_leaves)
    manifest = {
        "format": FORMAT,
        "epoch": int(epoch),
        "model_paths": [p for p, _ in model_flat],
        "n_opt_leaves": len(opt_leaves),
        "has_opt_state": bool(opt_leaves),
    }
    if class_avg_iou is not None:
        manifest["class_avg_iou"] = float(class_avg_iou)
    arrays = {"__manifest__": np.frombuffer(
        json.dumps(manifest).encode("utf-8"), dtype=np.uint8)}
    for i, (_, arr) in enumerate(model_flat):
        arrays[f"m{i}"] = arr
    for i, arr in enumerate(opt_leaves):
        arrays[f"o{i}"] = np.asarray(arr)
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
