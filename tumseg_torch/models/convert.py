"""Weights between ``tumseg``'s variables and the port's ``state_dict``.

``tumseg`` keeps ``{"params": ..., "batch_stats": ...}`` pytrees whose dense
kernels are ``[in, out]``; the port keeps the reference's torch layout
(``tools/export_torch_checkpoint.py:20-58``): conv weights ``[out, in, 1, 1]``
in the set abstractions and ``[out, in, 1]`` elsewhere, BN as
weight/bias/running_mean/running_var/num_batches_tracked. Stage entries
(``sa*``, ``fp*``) are lists of ``{"conv", "bn"}`` layers, the port's
``<stage>.mlp_convs.j`` / ``<stage>.mlp_bns.j``; an MSG set abstraction is a
list of such lists, one per scale, the port's ``<stage>.conv_blocks.s.j`` /
``<stage>.bn_blocks.s.j``. Any other entry with ``"w"`` is a conv or, under
a name that starts with ``fc``, a Linear (``[out, in]``), one with
``"scale"`` a batch norm, and any other dict a module of such entries, as
PointNet's ``feat``, ``feat.stn`` and ``feat.fstn``, or PointNeXt's
``res<i>.<j>`` blocks, whose local aggregation's conv (``*.aggr.*``) is
``[out, in, 1, 1]`` like a set abstraction's. A conv without a bias
(PointNeXt's that a BatchNorm follows) has no ``"b"``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


_STACKS = ("mlp_convs", "mlp_bns", "conv_blocks", "bn_blocks")


def _conv_rank(path: str) -> int:
    """Trailing 1-dims of the weight at ``path`` (a dotted module path): 2
    for a conv over grouped neighbourhoods (a set abstraction's, ``sa*``,
    or a PointNeXt local aggregation's, ``*.aggr.*``)."""
    if path.startswith("sa") or ".aggr." in path:
        return 2
    return 0 if path.rsplit(".", 1)[-1].startswith("fc") else 1


def _weight(w, rank: int) -> torch.Tensor:
    t = np.ascontiguousarray(np.asarray(w, dtype=np.float32).T)
    return torch.from_numpy(t.reshape(*t.shape, *([1] * rank)))


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bn(sd: Dict, prefix: str, params, stats) -> None:
    sd[f"{prefix}.weight"] = _tensor(params["scale"])
    sd[f"{prefix}.bias"] = _tensor(params["bias"])
    sd[f"{prefix}.running_mean"] = _tensor(stats["mean"])
    sd[f"{prefix}.running_var"] = _tensor(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv(sd: Dict, prefix: str, p, rank: int) -> None:
    """A conv's weight, and its bias where it has one (PointNeXt's convs
    that a BatchNorm follows have none)."""
    sd[f"{prefix}.weight"] = _weight(p["w"], rank)
    if "b" in p:
        sd[f"{prefix}.bias"] = _tensor(p["b"])


def _stack(sd: Dict, convs: str, bns: str, layers, stats, rank: int) -> None:
    for j, (layer, s) in enumerate(zip(layers, stats)):
        _conv(sd, f"{convs}.{j}", layer["conv"], rank)
        _bn(sd, f"{bns}.{j}", layer["bn"], s)


def state_dict_from_variables(variables: Dict) -> Dict[str, torch.Tensor]:
    """``tumseg`` variables (numpy or array-like leaves) -> port state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _emit(sd, "", variables["params"], variables["batch_stats"])
    return sd


def _emit(sd: Dict, prefix: str, params: Dict, stats: Dict) -> None:
    for name, p in params.items():
        path, s = prefix + name, stats.get(name)
        if isinstance(p, (list, tuple)) and isinstance(p[0], (list, tuple)):
            for i, scale in enumerate(p):  # MSG: one stack per scale
                _stack(sd, f"{path}.conv_blocks.{i}", f"{path}.bn_blocks.{i}",
                       scale, s[i], _conv_rank(path))
        elif isinstance(p, (list, tuple)):
            _stack(sd, f"{path}.mlp_convs", f"{path}.mlp_bns", p, s,
                   _conv_rank(path))
        elif "w" in p:
            _conv(sd, path, p, _conv_rank(path))
        elif "scale" in p:
            _bn(sd, path, p, s)
        else:
            _emit(sd, path + ".", p, s)


def variables_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """Port state_dict -> ``tumseg`` variables of numpy arrays (the inverse
    of :func:`state_dict_from_variables`; ``num_batches_tracked`` has no
    ``tumseg`` counterpart and is dropped)."""
    modules: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        prefix, field = key.rsplit(".", 1)
        modules.setdefault(prefix, {})[field] = value.detach().cpu().numpy()

    params: Dict = {}
    stats: Dict = {}
    for prefix, m in modules.items():
        if "running_mean" in m:
            p = {"scale": m["weight"].copy(), "bias": m["bias"].copy()}
            s = {"mean": m["running_mean"].copy(),
                 "var": m["running_var"].copy()}
        else:
            w = m["weight"]
            p = {"w": np.ascontiguousarray(w.reshape(w.shape[0],
                                                     w.shape[1]).T)}
            if "bias" in m:
                p["b"] = m["bias"].copy()
            s = None
        parts = prefix.split(".")
        if len(parts) < 3 or parts[1] not in _STACKS:
            # a conv, Linear or batch norm, at the top or in a module
            *path, name = parts
            _node(params, path)[name] = p
            if s is not None:
                _node(stats, path)[name] = s
            continue
        # <stage>.mlp_convs.j (a stack) or <stage>.conv_blocks.s.j (MSG)
        stage, kind, *pos = parts[0], parts[1], *map(int, parts[2:])
        p_node = params.setdefault(stage, [])
        s_node = stats.setdefault(stage, [])
        for i in pos[:-1]:
            p_node, s_node = _slot(p_node, i, list), _slot(s_node, i, list)
        p_layer = _slot(p_node, pos[-1], dict)
        s_layer = _slot(s_node, pos[-1], dict)
        if kind in ("mlp_convs", "conv_blocks"):
            p_layer["conv"] = p
        else:
            p_layer["bn"] = p
            s_layer.update(s)
    return {"params": params, "batch_stats": stats}


def _slot(seq: List, i: int, make):
    """``seq[i]``, growing ``seq`` with ``make()`` up to index ``i``."""
    while len(seq) <= i:
        seq.append(make())
    return seq[i]


def _node(tree: Dict, path: List[str]) -> Dict:
    """The dict at ``path`` in ``tree``, made where missing."""
    for key in path:
        tree = tree.setdefault(key, {})
    return tree
