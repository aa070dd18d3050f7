"""The port's benches (``tumseg_torch/tools/``: ``voting_bench``,
``train_sustained``, ``sampler_probe``, ``breakdown``, ``serve_probe3``,
``roofline``), the counterparts of ``benchmarks/``, on the CPU at small
sizes: each prints its original's keys with finite positive values, runs on
the CPU only with ``--gpu cpu``, and measures what the port runs:
``voting_bench``'s scene is the original's draws, ``serve_probe3``'s whole
chunk program votes what ``InferenceRunner`` votes, ``sampler_probe``'s
phases are ``DeviceBlockSampler``'s, and ``roofline``'s FLOP count is the
count from ``tumseg``'s own variables. The tiles and scenes are shrunk by
swapping their makers (a 1 m block must hold > 1024 points to be
sampled), as tests/test_torch_quality.py swaps the soak's."""

import json
import math
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tumseg_torch.tools import (breakdown, roofline, sampler_probe,
                                serve_probe3, soak, train_sustained,
                                voting_bench)

ROOT = Path(__file__).resolve().parents[1]
TOOLS = (voting_bench, train_sustained, sampler_probe, breakdown,
         serve_probe3, roofline)
VOTING_KEYS = ("metric", "scene_points", "votes", "block_batches",
               "blocks_per_vote", "wall_s", "host_grid_s_per_vote",
               "host_full_featurize_s_per_vote", "device_features",
               "device_reblock", "value")
TRAIN_KEYS = ("mode", "steps", "batch", "npoint", "epoch_s", "ms_per_step",
              "points_per_sec")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(out: str):
    """The JSON lines of a tool's output, after its card line."""
    text = out.strip().splitlines()
    assert text[0].startswith("cpu")
    return [json.loads(t) for t in text[1:] if t.startswith("{")]


def _positive(*values):
    for v in values:
        assert isinstance(v, (int, float)) and math.isfinite(v) and v > 0, v


def _small_scene(n, seed=0):
    """A 1.5 m x 1.5 m x 2 m scene of the original's kind: a few blocks."""
    r = np.random.default_rng(seed)
    xyz = np.stack([r.uniform(0, 1.5, n), r.uniform(0, 1.5, n),
                    r.uniform(0, 2, n)], 1)
    return xyz, r.integers(0, 8, n)


def _dense_tile(path, n, seed):
    """A 2 m x 1 m x 2.5 m training tile with colour, dense enough that
    every 1 m block holds > 1024 points."""
    from tumseg_torch.data.las import write_las

    r = np.random.default_rng(seed)
    xyz = np.stack([r.uniform(0, 2, n), r.uniform(0, 1, n),
                    r.uniform(0, 2.5, n)], 1)
    labels = np.where(xyz[:, 2] < 1.0, 1, 2)
    write_las(path, xyz, labels,
              rgb=r.integers(0, 255, (n, 3)).astype(np.uint16))
    return n


def _original_lines(rel: str, first: str, count: int, **names):
    """Runs ``count`` lines of ``rel`` from the one that starts with
    ``first`` (dedented) in a namespace holding numpy and ``names``."""
    lines = (ROOT / rel).read_text().splitlines()
    at = next(i for i, line in enumerate(lines)
              if line.strip().startswith(first))
    ns = dict(np=np, **names)
    exec(textwrap.dedent("\n".join(lines[at:at + count])), ns)
    return ns


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__)
def test_tool_without_cuda_raises_unless_gpu_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.parse_args([]).gpu == "0"
    with pytest.raises(RuntimeError, match="--gpu cpu"):
        tool.main([])


def test_voting_bench_scene_is_the_originals_draws():
    ns = _original_lines("benchmarks/voting_bench.py",
                         "r = np.random.default_rng(0)", 5,
                         args=SimpleNamespace(points=20_000))
    xyz, labels = voting_bench.scene(20_000)
    assert np.array_equal(xyz, ns["xyz"]) and np.array_equal(labels,
                                                             ns["labels"])


def test_serve_probe3_scene_is_the_originals_draws():
    ns = _original_lines("benchmarks/serve_probe3.py",
                         "r = np.random.default_rng(0)", 4)
    want_labels = ns["r"].integers(0, 8, ns["n"])   # the dataset's labels
    xyz, labels = voting_bench.scene(ns["n"])
    assert np.array_equal(xyz, ns["xyz"])
    assert np.array_equal(labels, want_labels)


@pytest.mark.parametrize("path", ["auto", "device_reblock",
                                  "device_features", "host"])
def test_voting_bench_runs_on_the_cpu(path, monkeypatch, capsys):
    monkeypatch.setattr(voting_bench, "scene", _small_scene)
    voting_bench.main(["--gpu", "cpu", "--points", "3000", "--batch", "4",
                       "--block_points", "1024", "--votes", "1", "--path",
                       path])
    (line,) = _lines(capsys.readouterr().out)
    assert set(VOTING_KEYS) <= set(line)
    assert line["metric"] == "whole_scene_voting_points_per_sec"
    _positive(line["wall_s"], line["value"], line["host_grid_s_per_vote"],
              line["host_full_featurize_s_per_vote"],
              line["blocks_per_vote"], line["block_batches"])
    assert line["block_batches"] == math.ceil(line["blocks_per_vote"] / 4)
    assert line["voted_points"] == line["scene_points"] == 3000
    assert line["cuda_graphs"] is False and line["idle_share"] is None
    want = {"auto": False, "device_reblock": True, "device_features": True,
            "host": False}[path]
    assert line["device_features"] is want
    assert line["device_reblock"] is (path == "device_reblock")


def test_train_sustained_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(soak, "make_tile", _dense_tile)
    res = train_sustained.run(train_sustained.parse_args([
        "--gpu", "cpu", "--points", "6000", "--batch", "2", "--npoint",
        "256", "--sample_rate", "0.1", "--epochs", "1", "--superstep", "2"]))
    lines = _lines(capsys.readouterr().out)
    modes = ["device_rate", "device_pipeline", "host_pipeline", "superstep2"]
    assert [line["mode"] for line in lines] == modes + ["summary"]
    for line in lines[:-1]:
        assert set(TRAIN_KEYS) <= set(line)
        assert (line["batch"], line["npoint"]) == (2, 256)
        _positive(line["steps"], line["epoch_s"], line["ms_per_step"],
                  line["points_per_sec"], line["epoch_s_median"])
        assert line["epoch_s"] == min(line["epoch_s_runs"])
    summary = lines[-1]
    assert set(summary) == {"mode"} | {f"{m}_vs_device_rate"
                                       for m in modes[1:]}
    _positive(*(v for k, v in summary.items() if k != "mode"))
    assert res["summary"] == summary


@pytest.fixture(scope="module")
def small_sampler(tmp_path_factory):
    work = tmp_path_factory.mktemp("sampler")
    orig = soak.make_tile
    soak.make_tile = _dense_tile
    try:
        return sampler_probe.make_sampler(work, 6000, 256, "cpu")
    finally:
        soak.make_tile = orig


def test_sampler_probe_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(soak, "make_tile", _dense_tile)
    for name, value in (("POINTS", 6000), ("B", 2), ("P", 256), ("REPS", 2)):
        monkeypatch.setattr(sampler_probe, name, value)
    sampler_probe.main(["--gpu", "cpu"])
    lines = _lines(capsys.readouterr().out)
    assert set(lines[0]) == {"cap", "cands"}
    assert lines[0]["cands"] == 9 * lines[0]["cap"] > 0
    assert [line["phase"] for line in lines[1:]] == [
        "candidates_pass", "rejection_loop", "sort_u_idx", "top_k",
        "featurize_gathers", "sample_batch_full"]
    for line in lines[1:]:
        _positive(line["ms"], line["min_ms"], *line["runs"])


def test_sampler_probe_phases_are_the_samplers(small_sampler):
    s = small_sampler
    B, P = 3, s.num_point
    rng = np.random.default_rng(5)
    rooms = torch.as_tensor(rng.integers(0, 2, B))
    u = torch.as_tensor(rng.random(B).astype(np.float32))
    sel_u = torch.as_tensor(rng.random((B, 9 * s.cap)).astype(np.float32))
    rep_u = torch.as_tensor(rng.random((B, P)).astype(np.float32))
    _, _, centres, counts, sel = s.sample_from_draws(rooms, u[:, None],
                                                     sel_u, rep_u)
    assert torch.equal(sampler_probe.candidates_pass(s, rooms, u), counts)
    assert bool((counts >= P).all())
    idx, _ = s._candidates(rooms, centres[:, 0], centres[:, 1])
    inside = sampler_probe.inside_mask(s, rooms, centres)
    order = sampler_probe.sort_u_idx(sel_u, inside, P)
    assert torch.equal(idx.gather(1, order), sel)
    top = sampler_probe.top_k(sel_u, inside, P)
    assert torch.equal(top.sort(1).values, order.sort(1).values)
    rows = sampler_probe.featurize_gathers(s, sel)
    assert torch.equal(rows, s._packed[sel])


def test_breakdown_runs_on_the_cpu(capsys, tmp_path, monkeypatch):
    for name, value in (("B", 1), ("TRAIN_B", 1), ("TRAIN_STEPS", 2)):
        monkeypatch.setattr(breakdown, name, value)
    out = tmp_path / "rows.json"
    rows = breakdown.run(breakdown.parse_args([
        "--gpu", "cpu", "--chain", "2", "--iters", "2", "--only",
        "floor,fps4,bq4,3nn3,sa4,fp4,train",
        "--json", str(out)]))
    lines = _lines(capsys.readouterr().out)
    assert [line["name"] for line in lines] == [
        "floor(add)", "fps4 N64->S16", "bq4 N64 S16 r0.8",
        "3nn fp3 N256 S64", "sa4_block N64->S16", "fp4_block N64 S16",
        "train_step B1 bf16"]
    for line in lines:
        _positive(line["ms"], line["median_ms"], line["min_ms"],
                  *line["runs"])
        assert len(line["runs"]) == 2 and "compile_s" in line
    assert json.loads(out.read_text()) == rows == lines


def _small_probe(monkeypatch):
    monkeypatch.setattr(voting_bench, "scene", _small_scene)
    for name, value in (("POINTS", 3000), ("BATCH", 4),
                        ("BLOCK_POINTS", 1024), ("REPS", 1)):
        monkeypatch.setattr(serve_probe3, name, value)


def test_serve_probe3_runs_on_the_cpu(monkeypatch, capsys):
    _small_probe(monkeypatch)
    serve_probe3.main(["--gpu", "cpu"])
    lines = _lines(capsys.readouterr().out)
    assert set(lines[0]) == {"nb", "nb_pad", "L", "n_pad"}
    assert lines[0]["n_pad"] == 3000 and lines[0]["nb_pad"] % 4 == 0
    assert [line["phase"] for line in lines[1:-1]] == [
        "reblock_sort", *serve_probe3.PHASES]
    for line in lines[1:-1]:
        _positive(line["ms_per_vote"], *line["runs"])
    assert set(lines[-1]["derived"]) == {
        "scatter_ms", "random_vs_contiguous_gather_ms", "featurize_total_ms"}
    assert all(math.isfinite(v) for v in lines[-1]["derived"].values())


def test_serve_probe3_full_chunk_votes_what_the_runner_votes(monkeypatch):
    """One vote of the probe's whole chunk program leaves the pool of one
    ``InferenceRunner`` vote with the same draws, bit for bit."""
    from tumseg_torch import ops
    from tumseg_torch.infer.voting import InferenceRunner

    _small_probe(monkeypatch)
    xyz, labels = voting_bench.scene(3000)
    ds = voting_bench.scene_dataset(xyz, labels, 1024)
    want = InferenceRunner(voting_bench.seeded_model(), 8, batch_size=4,
                           device="cpu", compute_dtype=torch.bfloat16,
                           device_features=True, device_reblock=True,
                           window_ops=True)
    want.infer_scene(ds, 0, num_votes=1)
    runner, ds, scene, grid, pool = serve_probe3.setup("cpu")
    n = scene[0].shape[0]
    with torch.inference_mode(), ops.window_enabled(True):
        idx = runner._reblock(grid, 0, 0, 1024)
        programs = serve_probe3.chunk_programs(runner, scene, 1.0, pool,
                                               None)
        serve_probe3.vote(runner, "scan_full", programs["scan_full"], idx,
                          grid[4], n)
    chunks = math.ceil(idx.shape[0] / 4)
    assert chunks > 1 and int(pool.sum()) == chunks * 4 * idx.shape[1]
    assert torch.equal(pool, want._buffers["pool"])


def _tumseg_flops(name, B, N):
    """2 * rows * in * out over the kernels of ``tumseg``'s own ``init``
    variables, the rows by the layer's place, plus PointNet's bmms."""
    import jax

    from tumseg import models

    extra = 3 if name.endswith("_original") else 0
    variables = models.get_module(name).init(jax.random.PRNGKey(0), 8, extra)
    npoint, levels = (1024, 256, 64, 16), (N, 1024, 256, 64)
    flops = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            variables["params"])[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        if keys[-1] != "w":
            continue
        cin, cout = leaf.shape
        top = keys[0]
        if top.startswith("sa"):
            stage = int(top[2]) - 1
            msg = len(keys) == 5          # sa/[scale]/[layer]/conv/w
            k = (16, 32)[int(keys[1])] if msg else 32
            rows = B * npoint[stage] * k
        elif top.startswith("fp"):
            rows = B * levels[int(top[2]) - 1]
        elif any(k.startswith("fc") for k in keys):
            rows = B
        else:
            rows = B * N
        flops += 2 * rows * cin * cout
    if name.startswith("pointnet_sem_seg"):
        flops += 2 * B * N * 3 * 3 + 2 * B * N * 64 * 64
    return flops


@pytest.mark.parametrize("name", roofline.MODELS)
def test_roofline_flops_are_tumsegs_count(name):
    assert roofline.model_flops(name, 2, 512) == _tumseg_flops(name, 2, 512)


def test_roofline_hand_count_of_the_ssg_forward():
    """The SSG B=32 x 4096 forward's GEMMs: 61.7 GFLOP."""
    assert roofline.model_flops("pointnet2_sem_seg", 32, 4096) == 61714989056


@pytest.mark.parametrize("name,dtype", [("pointnet2_sem_seg", "bf16"),
                                        ("pointnet2_sem_seg_msg", "f32"),
                                        ("pointnet_sem_seg", "bf16")])
def test_roofline_runs_on_the_cpu(name, dtype, capsys, monkeypatch):
    monkeypatch.setattr(roofline, "RUNS", 1)
    line = roofline.run(roofline.parse_args([
        "--gpu", "cpu", "--model", name, "--B", "1", "--N", "1024",
        "--dtype", dtype]))
    lines = _lines(capsys.readouterr().out)
    assert lines[-1] == line
    assert line["flops"] == line["flops_traced"] == roofline.model_flops(
        name, 1, 1024)
    _positive(line["flops"], line["bytes"], line["mfu"], line["forward_ms"],
              line["compute_bound_ms"], line["hbm_bound_ms"])
    assert line["forward_ms"] == line["forward_ms_min"]
    assert len(line["forward_runs"]) == 1
    assert line["peak_flops_per_s"] == roofline.PEAK_FLOPS[dtype]
    kernels = lines[:-1]
    if name == "pointnet_sem_seg":
        assert not kernels and line["bmm_flops"] > 0
    else:
        assert {k["kernel"] for k in kernels} == {
            "fps", "group", "three_nn_interpolate",
            "ball_query" if name == "pointnet2_sem_seg" else
            "ball_query_multi"}
        for k in kernels:
            _positive(k["nbytes"], k["ops"], k["bound_ms"])
        assert line["point_kernel_bytes"] == sum(k["nbytes"]
                                                 for k in kernels)


def test_roofline_bf16_groups_write_two_bytes():
    """A bf16 forward groups in the single-pass bf16 mode: its point
    kernels' lines are the f32 forward's, but for each neighbourhood
    group's output at 2 bytes an element in place of 4."""
    torch.manual_seed(0)
    model = roofline._model("pointnet2_sem_seg")
    x = torch.as_tensor(np.random.default_rng(0).random(
        (1, 1024, 6)).astype(np.float32))
    f32, bf16 = (roofline.traced_flops(model, x, dtype)[1]
                 for dtype in (None, torch.bfloat16))
    assert len(f32) == len(bf16)
    saved = 0
    for a, b in zip(f32, bf16):
        if "K=" in a["stage"]:
            assert (a["kernel"], a["stage"], a["ops"]) == (
                b["kernel"], b["stage"], b["ops"])
            saved += a["nbytes"] - b["nbytes"]
        else:
            assert a == b
    outputs = 0
    for i in range(1, 5):
        sa = getattr(model, f"sa{i}")
        c = roofline._dense_widths(sa.mlp_convs)[0][1]   # 3 + D
        outputs += sa.npoint * sa.nsample * c
    assert saved == 2 * outputs


def test_roofline_takes_a_given_forward_time(capsys):
    line = roofline.run(roofline.parse_args([
        "--gpu", "cpu", "--B", "1", "--N", "1024", "--forward-ms", "8.5"]))
    assert line["forward_ms"] == 8.5 and not line["forward_ms_measured"]
    assert line["mfu"] == pytest.approx(
        line["flops"] / 8.5e-3 / roofline.BF16_FLOPS_PER_S)


def test_kernel_bounds_count_as_chip_smoke_counts():
    """The counting rules that chip_smoke.py's bounds import, on one
    shape each."""
    assert roofline.group_cost(2, 3, 4, 5, 6) == dict(
        nbytes=4 * (24 + 60 + 18 + 120), ops=72)
    assert roofline.group_cost(2, 3, 4, 5, 6, fast=True) == dict(
        nbytes=4 * (24 + 60 + 18) + 2 * 120, ops=72)
    assert roofline.ball_query_cost(2, 10, 3, (16, 32), 100) == dict(
        nbytes=240 + 72 + 2 * 3 * 48 * 4, ops=900)
    assert roofline.fps_cost(2, 10, 3) == dict(nbytes=240 + 8 + 24, ops=600)
    ms, bytes_ms, ops_ms = roofline.bound_ms(3.35e9, 67e9)
    assert bytes_ms == pytest.approx(1.0) and ops_ms == pytest.approx(1.0)
