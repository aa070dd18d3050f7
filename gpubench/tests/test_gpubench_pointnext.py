"""PointNeXt-XL's architecture module (``reference/pointnext.py``) and the
two per-layer metrics that its cell adds, on the CPU:

- its counts pinned as literals at the configuration's sizes: the FLOPs
  of a B=1 forward and of a B=16 step, each mode's point-kernel and
  BatchNorm-kernel launches, and the parameters of ``make_weights``;
- ``launches`` and ``bn_launches`` against what the program counts over
  one tiny training step, its point ops and BatchNorm kernels stood in for
  by counted plain versions (the CPU launches no kernel);
- the cell ``pointnext_xl.train.facade`` not correct with each of
  ``faults.py``'s four faults planted in its timed path;
- ``train.aggregation_ms_per_step`` and ``train.bn_kernels_roofline`` on
  made-up traces: the value, a count that does not match, a trace that
  lost launches (raises), and no reading off the card or for an
  architecture without ``bn_launches``."""

from __future__ import annotations

from collections import Counter

import pytest
import torch

from gpubench import counting, faults, spec
from gpubench.tests import tiny

CFG = spec.config("pointnext_xl")
ARCH = spec.architecture(CFG)
CELL = "pointnext_xl.train.facade"
STEPS = 10


def test_counts_pinned():
    assert ARCH.forward_flops(CFG, 1, 4096) == 23_091_216_384
    assert ARCH.step_flops(CFG, 16, 4096) == 1_108_302_888_960
    serve = Counter(c["kernel"] for c in ARCH.launches(CFG, 32, 4096, False))
    assert serve == {"fps": 4, "group": 23, "ball_query": 19,
                     "three_nn_interpolate": 4}
    train = Counter(c["kernel"] for c in ARCH.launches(CFG, 16, 4096, True))
    assert train == dict(serve, group_backward=19, interpolate_backward=4)
    assert Counter(c["kernel"] for c in ARCH.bn_launches(
        CFG, 32, 4096, False)) == {"bn_apply": 58}
    assert Counter(c["kernel"] for c in ARCH.bn_launches(
        CFG, 16, 4096, True)) == dict.fromkeys(
            ("bn_apply", "bn_backward_terms", "bn_backward_dx"), 58)
    w = ARCH.make_weights(CFG, 1, torch.device("cpu"))
    assert sum(w[n].numel() for n in ARCH.leaves(w)) == 41_577_106


# the plain ops that stand for each kernel in the counted step
KERNEL_OF = {"farthest_point_sample": "fps", "query_ball_point": "ball_query",
             "query_ball_point_multi": "ball_query_multi",
             "group_points": "group", "fused_ball_group": "fused_ball_group",
             "three_nn_interpolate": "three_nn_interpolate",
             "three_nn_window_interpolate": "three_nn_window",
             "group_points_backward": "group_backward",
             "interpolate_backward": "interpolate_backward"}


class _Counted:
    """``ops.core`` with each kernel's plain stand-in counted in
    ``kernels.launches``."""

    def __init__(self, core, launches):
        self.core, self.launches = core, launches

    def __getattr__(self, name):
        fn = getattr(self.core, name)
        if name not in KERNEL_OF:
            return fn

        def counted(*args, **kwargs):
            self.launches[KERNEL_OF[name]] += 1
            return fn(*args, **kwargs)
        return counted


def test_counts_against_the_programs_launches(monkeypatch):
    """One tiny training step (fast gathers) of the port, with its point
    ops and ``BatchNormReLU``'s three kernels stood in for by counted plain
    versions: each kernel's launches are the configuration's count."""
    from tumseg_torch import models, ops
    from tumseg_torch.ops import autograd, core, kernels

    cfg, program = tiny.config("pointnext_xl")
    tiny.program_sizes(monkeypatch, cfg, program)
    launches = dict.fromkeys(kernels.KERNELS, 0)
    monkeypatch.setattr(kernels, "launches", launches)
    monkeypatch.setattr(ops, "_impl", lambda t: _Counted(core, launches))

    def counted(name, fn):
        def run(*args, **kwargs):
            launches[name] += 1
            return fn(*args, **kwargs)
        return run

    def apply(x, mean, inv, bias, relu, dtype=torch.float32):
        z = (x - mean) * inv + bias
        return (torch.relu(z) if relu else z).to(dtype)

    monkeypatch.setattr(kernels, "bn_apply", counted("bn_apply", apply))
    monkeypatch.setattr(kernels, "bn_backward_terms",
                        counted("bn_backward_terms", core.batch_norm_terms))
    monkeypatch.setattr(kernels, "bn_backward_dx",
                        counted("bn_backward_dx", core.batch_norm_dx))

    def batch_norm(x, weight, bias, running_mean, running_var, momentum,
                   momentum_keep, eps, training, mesh=None, relu=False,
                   dtype=None):
        return autograd.BatchNormReLU.apply(
            x, weight, bias, running_mean, running_var, momentum,
            momentum_keep, eps, training, relu,
            torch.float32 if dtype is None else dtype)

    monkeypatch.setattr(ops, "batch_norm", batch_norm)
    model = models.get_module(cfg["model"]).get_model(18, 3).train()
    x = torch.rand(2, 128, 9)
    lp, aux = model(x, generator=torch.Generator().manual_seed(0),
                    fast_gather=True)
    model.loss(lp, torch.randint(0, 18, (2, 128)), aux,
               torch.ones(18)).backward()
    want = Counter(c["kernel"] for c in ARCH.launches(cfg, 2, 128, True)
                   + ARCH.bn_launches(cfg, 2, 128, True))
    assert {k: v for k, v in launches.items() if v} == want


def _aggregation_ctx(lost=0):
    """A traced window of STEPS steps, each of a step's grouping and other
    point-kernel launches 10 us on the device; ``lost`` group launches
    missing from the trace."""
    per = ARCH.launches(CFG, 16, 4096, True)
    kernels, launches = [], Counter()
    for _ in range(STEPS):
        for c in per:
            kernels.append((f"void tumseg::{c['kernel']}_kernel<float>",
                            1e-5))
            launches[c["kernel"]] += 1
    for _ in range(lost):
        kernels.remove(("void tumseg::group_kernel<float>", 1e-5))
    return {"trace": {"kernels": kernels + [("gemm", 1.0)]},
            "device": "cuda", "steps": STEPS, "launches": dict(launches)}


def test_aggregation_ms_per_step():
    read = spec.reader("train.aggregation_ms_per_step")
    grouping = [c for c in ARCH.launches(CFG, 16, 4096, True)
                if c["kernel"] in ("ball_query", "group", "group_backward")]
    assert read(_aggregation_ctx()) == pytest.approx(1e3 * len(grouping)
                                                     * 1e-5)
    with pytest.raises(RuntimeError, match="grouping launches"):
        read(_aggregation_ctx(lost=1))
    assert read(dict(_aggregation_ctx(), device="cpu")) is None
    assert read(dict(_aggregation_ctx(), trace=None)) is None


def _bn_ctx(cfg=CFG, drop=0, lost=0):
    """A traced window of STEPS steps, each BatchNorm-kernel launch 10 us;
    ``drop`` bn_apply launches a step fewer than the count, in the trace
    and the program's counters alike; ``lost`` missing from the trace
    alone."""
    per = ARCH.bn_launches(CFG, 16, 4096, True)
    kernels, launches = [], Counter()
    for _ in range(STEPS):
        skipped = 0
        for c in per:
            if c["kernel"] == "bn_apply" and skipped < drop:
                skipped += 1
                continue
            kernels.append((f"void tumseg::{c['kernel']}_kernel<true>",
                            1e-5))
            launches[c["kernel"]] += 1
    del kernels[:lost]
    return {"trace": {"kernels": kernels + [("gemm", 1.0)]},
            "device": "cuda", "cfg": cfg, "batch": 16, "points": 4096,
            "train": True, "steps": STEPS, "launches": dict(launches)}, per


def test_bn_kernels_roofline():
    read = spec.reader("train.bn_kernels_roofline")
    ctx, per = _bn_ctx()
    share = read(ctx)
    assert share == pytest.approx(100.0 * counting.bound_s(per) * STEPS
                                  / (len(per) * STEPS * 1e-5))
    ctx, _ = _bn_ctx(drop=1)
    priced = [c for c in per if c["kernel"] != "bn_apply"]
    assert read(ctx) == pytest.approx(
        100.0 * counting.bound_s(priced) * STEPS
        / ((len(per) - 1) * STEPS * 1e-5))
    assert read(ctx) < share
    with pytest.raises(RuntimeError, match="BatchNorm launches"):
        read(_bn_ctx(lost=1)[0])
    assert read(dict(_bn_ctx()[0], device="cpu")) is None
    assert read(_bn_ctx(cfg=spec.config("pointnet2_ssg"))[0]) is None


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "late"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    """A step that leaves the parameters, half of each batch, losses 1%
    off, or stale room ids once the window runs: the cell's check reads
    each as not correct."""
    loop = spec.traffic(spec.cell(spec.load_benchmark(),
                                  CELL)["traffic"])["loop"]
    faults.plant(loop, fault, monkeypatch)
    line = tiny.execute(monkeypatch, CELL)
    assert not line["correct"], (fault, line["checks"])
