"""The check that decides ``correct``, on the CPU at tiny sizes: every
cell reads correct as the program runs, and not correct with the control
(the program's bf16 compute) in its place or with the timed path broken
underneath: a vote or a step that leaves the state unchanged, half of the
blocks or of the batch left out, an answer altered where it is made; and
a fault that spares the set-up and breaks only the window's tiles or
calls. The fixture cells (``tiny.FIXTURE_CELLS``) run the same loops on
PointNet, an architecture that no cell of the benchmark runs."""

from __future__ import annotations

import pytest

from gpubench import faults, spec
from gpubench.tests import tiny

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]] + list(
    tiny.FIXTURE_CELLS)


def _failed(line):
    return [n for n, c in line["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(monkeypatch, workload):
    line = tiny.execute(monkeypatch, workload)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_bf16_is_not_correct(monkeypatch, workload):
    line = tiny.execute(monkeypatch, workload, control="bf16")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "late"])
@pytest.mark.parametrize("workload", ["ssg.serve.facade", "ssg.train.facade",
                                      *tiny.FIXTURE_CELLS])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    like = tiny.FIXTURE_CELLS.get(workload, (None, workload))[1]
    loop = spec.traffic(spec.cell(spec.load_benchmark(),
                                  like)["traffic"])["loop"]
    faults.plant(loop, fault, monkeypatch)
    line = tiny.execute(monkeypatch, workload)
    assert not line["correct"], (fault, line["checks"])
