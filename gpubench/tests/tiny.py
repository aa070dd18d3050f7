"""Tiny versions of the cells for the CPU tests: the same configurations
and mixes with smaller blocks and batches, tiles of a few thousand points,
and whatever the configuration's architecture module shrinks, where it
has a ``tiny`` (PointNet++'s centroid counts, which the program's models
take from their modules' ``SA_CFGS``, patched to match).

Besides the benchmark's cells, the fixture cells run a test configuration
(``tests/configs/<name>.json``, in no cell of ``BENCHMARK.json``) like a
cell of the benchmark: its traffic, its metrics and its limits."""

from __future__ import annotations

import copy
import importlib
import json
from pathlib import Path

import torch

from gpubench import run, spec

FIXTURES = Path(__file__).resolve().parent / "configs"

# fixture cell -> (its configuration, the cell it runs like)
FIXTURE_CELLS = {"pointnet.serve.facade": ("pointnet", "ssg.serve.facade"),
                 "pointnet.train.facade": ("pointnet", "ssg.train.facade")}


def full_config(name: str):
    """``configs/<name>.json``, or the fixture ``tests/configs/<name>.json``."""
    path = FIXTURES / f"{name}.json"
    return json.loads(path.read_text()) if path.exists() else spec.config(name)


def config(name: str):
    """-> (the tiny configuration, the program's sizes to set for it)."""
    cfg = full_config(name)
    shrink = getattr(spec.architecture(cfg), "tiny", None)
    cfg, program = shrink(cfg) if shrink else (copy.deepcopy(cfg), [])
    cfg["serve"].update(batch=2, block_points=128, votes=2, calibrate=2)
    cfg["train"].update(batch=2, num_point=128, superstep=2,
                        min_block_points=16)
    return cfg, program


def mix(name: str):
    m = spec.traffic(name)
    m.update(tile_points=[3000, 4000], points_per_m2=100, height_m=10.0)
    if "warmup_points" in m:
        m.update(warmup_points=4000, distinct_tiles=2)
    else:
        m["tiles"] = 2
    return m


def program_sizes(monkeypatch, cfg, program) -> None:
    """Sets ``program`` (``(attribute, index, key, value)`` of the model's
    module) for the rest of the test."""
    mod = importlib.import_module("tumseg_torch.models." + cfg["model"])
    for attribute, index, key, value in program:
        monkeypatch.setitem(getattr(mod, attribute)[index], key, value)


def with_fixture(bench, workload: str):
    """``bench`` with the fixture cell ``workload`` added, reporting every
    metric of the cell it runs like; -> (bench, that cell's limits)."""
    name, like = FIXTURE_CELLS[workload]
    bench = copy.deepcopy(bench)
    traffic = spec.cell(bench, like)["traffic"]
    bench["workloads"].append({"name": workload, "config": name,
                               "traffic": traffic, "chips": 1,
                               "why": "fixture"})
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if like in m.get("workloads", []):
                m["workloads"].append(workload)
    return bench, spec.limits(like)


def execute(monkeypatch, workload: str, control: str = "none",
            seed: int = 2147483651, trace: int = 0):
    """One run of the tiny cell on the CPU: -> the result's line."""
    bench, limits = spec.load_benchmark(), None
    if workload in FIXTURE_CELLS:
        bench, limits = with_fixture(bench, workload)
    cell = spec.cell(bench, workload)
    cfg, program = config(cell["config"])
    program_sizes(monkeypatch, cfg, program)
    args = run.parse_args(["--workload", workload, "--seed", str(seed),
                           "--seconds", "0.5", "--trace", str(trace),
                           "--control", control])
    return run.execute(args, torch.device("cpu"), bench, cfg,
                       mix(cell["traffic"]), limits)
