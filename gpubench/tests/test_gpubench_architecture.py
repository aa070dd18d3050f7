"""A configuration's architecture module, found by the name in its
``architecture`` key: PointNet++'s counts as they were before they moved
into its module (``golden_counts.json``), the refusals of a bad name and
of a module that lacks part of the contract, the tests' shrinking as an
option of the module, and no knowledge of PointNet++ in the files that
every architecture shares."""

from __future__ import annotations

import json
import re
import sys
import types
from pathlib import Path

import pytest

from gpubench import counting, spec
from gpubench.tests import tiny

HERE = Path(__file__).resolve().parent
GOLDEN = json.loads((HERE / "golden_counts.json").read_text())
CONFIGS = [c["name"] for c in spec.load_benchmark()["configs"]]


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_counts_are_the_parents(name):
    cfg = spec.config(name)
    arch = spec.architecture(cfg)
    golden = GOLDEN[name]
    assert arch.forward_flops(cfg, 32, 4096) == golden["forward_flops"]
    assert arch.step_flops(cfg, 16, 4096) == golden["step_flops"]
    for mode, B, train in (("serve", 32, False), ("train", 16, True)):
        per = arch.launches(cfg, B, 4096, train)
        assert [[c["kernel"], c["nbytes"], c["ops"]] for c in per] == \
            golden[mode]["launches"]
        assert counting.bound_s(per) == pytest.approx(golden[mode]["bound_s"],
                                                      rel=1e-9)


@pytest.mark.parametrize("name", CONFIGS + ["pointnet"])
def test_every_configuration_names_its_architecture(name):
    cfg = tiny.full_config(name)
    arch = spec.architecture(cfg)
    assert arch.__name__ == "gpubench.reference." + cfg["architecture"]


@pytest.mark.parametrize("name", ["Pointnet2", "pointnet2.ops", "../run",
                                  "", "2x"])
def test_a_bad_architecture_name_is_refused(name):
    with pytest.raises(ValueError, match="bad architecture name"):
        spec.architecture({"architecture": name})


@pytest.mark.parametrize("name", ["ops", "serve", "train", "layers"])
def test_a_reference_module_that_is_no_architecture_is_refused(name):
    with pytest.raises(AttributeError, match="lacks"):
        spec.architecture({"architecture": name})


@pytest.mark.parametrize("missing", spec.ARCHITECTURE)
def test_a_module_missing_one_function_is_named(monkeypatch, missing):
    module = types.ModuleType("gpubench.reference.partial_arch")
    for f in spec.ARCHITECTURE:
        if f != missing:
            setattr(module, f, lambda *a, **k: None)
    monkeypatch.setitem(sys.modules, module.__name__, module)
    with pytest.raises(AttributeError) as err:
        spec.architecture({"architecture": "partial_arch"})
    assert str(err.value).endswith("lacks " + missing)


def test_a_module_without_tiny_runs_the_tests_unshrunk():
    cfg = tiny.full_config("pointnet")
    assert not hasattr(spec.architecture(cfg), "tiny")
    small, program = tiny.config("pointnet")
    assert program == []
    assert {k: v for k, v in small.items() if k not in ("serve", "train")} \
        == {k: v for k, v in cfg.items() if k not in ("serve", "train")}


SHARED = ["loops", "metrics", "check.py", "counting.py", "reference/train.py",
          "reference/serve.py"]
POINTNET2 = re.compile(r'pointnet2|cfg\["(sa|fp|head)"\]')


def test_shared_files_name_no_pointnet2():
    found = []
    for part in SHARED:
        path = spec.HERE / part
        for f in sorted(path.rglob("*.py")) if path.is_dir() else [path]:
            for i, line in enumerate(f.read_text().splitlines(), start=1):
                if POINTNET2.search(line):
                    found.append(f"{f.relative_to(spec.HERE)}:{i}: {line}")
    assert not found, "\n".join(found)


@pytest.mark.parametrize("workload,kind", [("pointnet.serve.facade", "serve"),
                                           ("pointnet.train.facade", "train")])
def test_a_new_architecture_inherits_the_per_layer_metrics(monkeypatch,
                                                           workload, kind):
    line = tiny.execute(monkeypatch, workload, trace=1)
    assert line["correct"], line["checks"]
    assert {f"mfu.{kind}", f"device.idle.{kind}"} <= set(line["metrics"])
    assert line["metrics"][f"mfu.{kind}"]["value"] > 0
