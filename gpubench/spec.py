"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<name>.json``) and its architecture module
(``reference/<architecture>.py``, by the configuration's
``architecture``), its traffic mix (``traffic/<name>.json``), the loop
that mix drives (``loops/<loop>.py``) and each per-layer metric's reader
(``metrics/<name>.py``). Nothing is listed in code: a file is found by the
name that ``BENCHMARK.json`` or the configuration gives it."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MODULE = re.compile(r"^[a-z_][a-z0-9_]*$")

# what an architecture module gives (``gpubench/README.md``)
ARCHITECTURE = ("make_weights", "Net", "leaves", "loss", "forward_flops",
                "step_flops", "launches")


def load_benchmark(path: Path = BENCHMARK) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> Dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str) -> Dict:
    return _json("configs", name)


def traffic(name: str) -> Dict:
    return _json("traffic", name)


def loop(name: str):
    """The module ``gpubench.loops.<name>``."""
    if not MODULE.match(name):
        raise ValueError(f"bad loop name {name!r}")
    return importlib.import_module(f"gpubench.loops.{name}")


def architecture(cfg: Dict):
    """The module ``gpubench.reference.<cfg["architecture"]>``: the
    architecture's reference, loss and counts, each of ``ARCHITECTURE``."""
    name = cfg["architecture"]
    if not MODULE.match(name):
        raise ValueError(f"bad architecture name {name!r}")
    module = importlib.import_module(f"gpubench.reference.{name}")
    missing = [f for f in ARCHITECTURE if not callable(getattr(module, f,
                                                               None))]
    if missing:
        raise AttributeError(f"architecture module {module.__name__} lacks "
                             + ", ".join(missing))
    return module


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    if not NAME.match(metric):
        raise ValueError(f"bad metric name {metric!r}")
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: Dict, kind: str, workload: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload``
    reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def limits(workload: str) -> Dict[str, float]:
    """The limit of each number that the cell's check compares
    (``limits/<workload>.json``)."""
    return _json("limits", workload)
