"""Tiny versions of the cells for the CPU tests: the same configurations
and mixes with fewer centroids, smaller blocks and batches, and tiles of a
few thousand points. The program's models take their centroid counts from
their modules' ``SA_CFGS``, which :func:`program_sizes` patches to match."""

from __future__ import annotations

import importlib

import torch

from gpubench import run, spec

NPOINT = [64, 16, 8, 4]


def config(name: str):
    cfg = spec.config(name)
    for sa, n in zip(cfg["sa"], NPOINT):
        sa["npoint"] = n
    cfg["serve"].update(batch=2, block_points=128, votes=2, calibrate=2)
    cfg["train"].update(batch=2, num_point=128, superstep=2,
                        min_block_points=16)
    return cfg


def mix(name: str):
    m = spec.traffic(name)
    m.update(tile_points=[3000, 4000], points_per_m2=100, height_m=10.0)
    if "warmup_points" in m:
        m.update(warmup_points=4000, distinct_tiles=2)
    else:
        m["tiles"] = 2
    return m


def program_sizes(monkeypatch, cfg) -> None:
    mod = importlib.import_module("tumseg_torch.models." + cfg["model"])
    for sa, n in zip(mod.SA_CFGS, NPOINT):
        monkeypatch.setitem(sa, "npoint", n)


def execute(monkeypatch, workload: str, control: str = "none",
            seed: int = 2147483651, trace: int = 0):
    """One run of the tiny cell on the CPU: -> the result's line."""
    bench = spec.load_benchmark()
    cell = spec.cell(bench, workload)
    cfg = config(cell["config"])
    program_sizes(monkeypatch, cfg)
    args = run.parse_args(["--workload", workload, "--seed", str(seed),
                           "--seconds", "0.5", "--trace", str(trace),
                           "--control", control])
    return run.execute(args, torch.device("cpu"), bench, cfg,
                       mix(cell["traffic"]))
