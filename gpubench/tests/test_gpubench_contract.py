"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery, import check and result line, on the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from gpubench import guard, spec
from gpubench.tests import tiny

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def _names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert spec.NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_unit_better_source(metric):
    assert spec.UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = (("host_clock", "device_trace") if "bound" in metric else
               ("device_trace", "program_span", "program_counter",
                "host_clock"))
    assert metric["source"] in allowed


def test_unique_names_and_keys():
    for kind, keys in (("configs", {"name", "source", "file", "reduced",
                                    "why"}),
                       ("workloads", {"name", "config", "traffic", "chips",
                                      "why"})):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
        assert all(set(e) == keys for e in BENCH[kind])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_texts_are_one_short_line():
    texts = [e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
    texts += [c["source"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_bounds_and_setup():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(BENCH, "end_to_end",
                                                  w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(BENCH, "per_layer", w["name"])
        assert w["chips"] == 1


def test_moves_names_an_end_to_end_metric_of_the_same_cells():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for c in cells:
            assert c in moved.get("workloads", [c]), (m["name"], c)


def test_layers_are_spelt_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    lower = {l.lower() for l in layers}
    assert len(lower) == len(layers)


def test_configuration_files():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.parts[len(ROOT.parts)] == "gpubench"
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_every_cell_resolves_by_name():
    for w in BENCH["workloads"]:
        cfg = spec.config(w["config"])
        mix = spec.traffic(w["traffic"])
        assert spec.loop(mix["loop"]).run
        assert set(spec.limits(w["name"]))
        assert cfg["name"] == w["config"]
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    for kind in ("configs", "traffic", "metrics", "limits"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "new_model.json").write_text('{"name": "x"}')
    (tmp_path / "traffic" / "new_mix.json").write_text('{"loop": "y"}')
    (tmp_path / "limits" / "new.cell.json").write_text('{"gap": 0.5}')
    (tmp_path / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return ctx['x'] * 2\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    assert spec.config("new_model") == {"name": "x"}
    assert spec.traffic("new_mix") == {"loop": "y"}
    assert spec.limits("new.cell") == {"gap": 0.5}
    assert spec.reader("new.metric")({"x": 21}) == 42
    with pytest.raises(ValueError):
        spec.config("../BENCHMARK")


@pytest.mark.parametrize("names,banned", [
    (["tumseg_torch", "tumseg_torch.ops.core", "jaxtyping", "flaxen"], []),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "tumseg",
      "tumseg.ops"], ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                      "tumseg", "tumseg.ops"]),
])
def test_import_check_compares_whole_top_level_names(names, banned):
    assert guard.forbidden(names) == banned


def test_harness_imports_no_jax_nor_tumseg():
    for path in sorted(spec.HERE.rglob("*.py")):
        names = guard.imports_of(path)
        assert not guard.forbidden(names), path
        assert not any(n.startswith(("benchmarks", "bench")) for n in names)
        if "reference" in path.parts:
            assert not [n for n in names
                        if n.split(".")[0] == "tumseg_torch"], path


def test_a_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "gpubench.run",
                          "--workload", BENCH["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_run_outside_the_repository_fails(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "gpubench")
    out = subprocess.run([sys.executable, "-m", "gpubench.run",
                          "--workload", BENCH["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(monkeypatch, trace):
    line = tiny.execute(monkeypatch, "ssg.train.facade", trace=trace)
    keys = list(line)
    assert keys[:5] == LINE_KEYS
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == bool(trace)
    assert set(keys) <= set(LINE_KEYS) | {"breakdown", "card", "checks"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == {"train_points_per_s",
                                        "train_call_ms_p90", "setup_s"}
    json.dumps(line)
