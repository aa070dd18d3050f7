"""The single-pass bf16 gathers (``fast``) of the port's plain ops against
tumseg's Pallas kernels in interpret mode, on the same numpy inputs, and the
training engine's routing of them (tumseg trains with them on its
accelerator: ``tumseg/train/loop.py:85,126``).

- The fast group stores bf16 and must equal ``group_points(fast=True)``
  bit for bit; its backward (a bf16 cotangent, summed in f32) agrees with
  ``jax.vjp`` of it within rtol 1e-5 / atol 1e-6 (the same terms summed in
  another order).
- The fast interpolation cannot be held against ``weighted_interpolate(
  fast=True)``: interpret mode does not round at ``Precision.DEFAULT``, so
  on the CPU fast equals exact (asserted below, difference 0.0, so that a
  JAX that starts to round shows here). The TPU's single bf16 pass is
  reproduced by rounding the operands by hand and running the exact kernel:
  ``weighted_interpolate(idx, bf16(w), bf16(p2), fast=False)`` and its VJP
  at ``bf16(g)``. The products are then exact, so the two agree within
  atol 1e-6 forward (three terms in another order) and rtol 1e-5 / atol
  1e-6 backward (about 3N/S terms a source row).
- Each layer of the SSG forward with ``fast_gather`` against tumseg's
  through its Pallas kernels (interpret mode, the interpolation's operands
  rounded by hand as above), fed the same inputs. Not the whole forward:
  an f32 value that the two frameworks compute an ulp apart now and then
  rounds to bf16 values a bf16 step (2^-8 relative) apart, and four
  stages of that move the log-probs by ~2e-2 where each layer agrees to
  ~1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg_torch import ops as tops
from tumseg_torch.ops import core


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _interpret_mode():
    """Pallas TPU kernels run under the interpreter on CPU, as in
    tests/test_pallas_ops.py."""
    if os.environ.get("TUMSEG_TEST_TPU") == "1":
        yield
        return
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(a):
    """numpy f32 rounded to bf16 (to nearest even), as f32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _group_inputs(B, N, S, K, C, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, (B, S, K)).astype(np.int32)
    idx[:, 0, :] = N                  # an empty ball: the sentinel
    idx[:, 1, 3:] = idx[:, 1, :1]     # a short ball padded with its first
    src = (rng.standard_normal((B, N, C)) * 3).astype(np.float32)
    new_xyz = rng.standard_normal((B, S, 3)).astype(np.float32)
    return idx, src, new_xyz


@pytest.mark.parametrize("B,N,S,K,C", [(2, 128, 32, 8, 9),
                                       (1, 96, 16, 16, 35)])
def test_fast_group_matches_pallas(B, N, S, K, C):
    from tumseg.ops.pallas.group import group_points as group_pallas

    idx, src, new_xyz = _group_inputs(B, N, S, K, C, 20)
    want = group_pallas(jnp.asarray(idx), jnp.asarray(src),
                        jnp.asarray(new_xyz), fast=True)
    got = core.group_points(_t(idx), _t(src), _t(new_xyz), fast=True)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got[..., 3:]), _bf16(_np(got[..., 3:])))
    # the dispatch on a CPU tensor is the plain op
    assert torch.equal(tops.group_points(_t(idx), _t(src), _t(new_xyz),
                                         fast=True), got)
    exact = core.group_points(_t(idx), _t(src), _t(new_xyz))
    assert exact.dtype == torch.float32
    assert not torch.equal(got.float(), exact)


@pytest.mark.parametrize("B,N,S,K,C", [(2, 128, 32, 8, 9),
                                       (1, 96, 16, 16, 35)])
def test_fast_group_backward_matches_pallas_vjp(B, N, S, K, C):
    from tumseg.ops.pallas.group import group_points as group_pallas

    idx, src, new_xyz = _group_inputs(B, N, S, K, C, 21)
    idx[:, :, 0] = 7                  # one row that every group holds
    g = np.random.default_rng(22).standard_normal((B, S, K, C)).astype(
        np.float32)
    g_bf = jnp.asarray(g).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda s_: group_pallas(
        jnp.asarray(idx), s_, jnp.asarray(new_xyz), fast=True),
        jnp.asarray(src))
    want = np.asarray(vjp(g_bf)[0])
    got = core.group_points_backward(_t(idx), _t(g).bfloat16(), N, fast=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # an f32 cotangent is rounded to bf16 in the op
    assert torch.equal(core.group_points_backward(_t(idx), _t(g), N,
                                                  fast=True), got)
    # through autograd: the bf16 output's cotangent reaches the fast backward
    s_t = _t(src).requires_grad_()
    out = tops.group_points(_t(idx), s_t, _t(new_xyz), fast=True)
    out.backward(_t(g).bfloat16())
    assert torch.equal(s_t.grad, got)


def _interp_inputs(B, N, S, D, seed):
    rng = np.random.default_rng(seed)
    xyz1 = rng.random((B, N, 3)).astype(np.float32)
    xyz2 = rng.random((B, S, 3)).astype(np.float32)
    p2 = rng.standard_normal((B, S, D)).astype(np.float32)
    g = rng.standard_normal((B, N, D)).astype(np.float32)
    return xyz1, xyz2, p2, g


@pytest.mark.parametrize("B,N,S,D", [(2, 256, 64, 16), (1, 96, 3, 40)])
def test_fast_interpolation_matches_pallas_on_rounded_operands(B, N, S, D):
    from tumseg.ops.pallas.interpolate import weighted_interpolate

    xyz1, xyz2, p2, g = _interp_inputs(B, N, S, D, 23)
    dists, idx = core.three_nn(_t(xyz1), _t(xyz2))
    w = core.interpolation_weights(dists).numpy()
    ji, jw, jp2 = jnp.asarray(idx.numpy()), jnp.asarray(w), jnp.asarray(p2)

    # interpret mode does not round at Precision.DEFAULT: fast == exact
    gap = jnp.abs(weighted_interpolate(ji, jw, jp2, fast=True)
                  - weighted_interpolate(ji, jw, jp2, fast=False)).max()
    assert float(gap) == 0.0

    want = weighted_interpolate(ji, jnp.asarray(_bf16(w)),
                                jnp.asarray(_bf16(p2)), fast=False)
    d_t, i_t, got = core.three_nn_interpolate(_t(xyz1), _t(xyz2), _t(p2),
                                              fast=True)
    assert torch.equal(i_t, idx) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    exact = core.three_nn_interpolate(_t(xyz1), _t(xyz2), _t(p2))[2]
    assert (got - exact).abs().max() > 1e-4  # the rounding is there

    _, vjp = jax.vjp(lambda p: weighted_interpolate(
        ji, jnp.asarray(_bf16(w)), p, fast=False), jnp.asarray(_bf16(p2)))
    want_bwd = np.asarray(vjp(jnp.asarray(_bf16(g)))[0])
    got_bwd = core.interpolate_backward(idx, _t(w), _t(g), S, fast=True)
    np.testing.assert_allclose(got_bwd.numpy(), want_bwd, rtol=1e-5,
                               atol=1e-6)
    # through autograd, which recomputes the weights from the distances
    p_t = _t(p2).requires_grad_()
    tops.three_nn_interpolate(_t(xyz1), _t(xyz2), p_t, fast=True)[2].backward(
        _t(g))
    assert torch.equal(p_t.grad, got_bwd)


def test_fast_window_interpolation_rounds_like_the_direct_form():
    """The z-window 3-NN's interpolation takes the same fast mode: equal to
    the fast interpolation of its own neighbours."""
    xyz1, xyz2, p2, _ = _interp_inputs(2, 512, 256, 8, 24)
    dists, idx, got = core.three_nn_window_interpolate(
        _t(xyz1), _t(xyz2), _t(p2), 128, 64, fast=True)
    assert torch.equal(got, core.interpolate_weighted(dists, idx, _t(p2),
                                                      fast=True))
    with tops.window_enabled(True):
        assert torch.equal(tops.three_interpolate(
            _t(xyz1), _t(xyz2), _t(p2), fast_gather=True),
            core.three_nn_interpolate(_t(xyz1), _t(xyz2), _t(p2),
                                      fast=True)[2])


class _Spy:
    """Records the ``fast`` flag of every plain grouping and interpolation
    call, forward and backward."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("group_points", "three_nn_interpolate",
                     "group_points_backward", "interpolate_backward"):
            monkeypatch.setattr(core, name, self._wrap(name,
                                                       getattr(core, name)))

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            fast = kwargs.get("fast", args[-1] if isinstance(
                args[-1], bool) else False)
            k = args[0].shape[-1] if name == "group_points" else None
            self.calls.append((name, k, fast))
            return fn(*args, **kwargs)
        return spy

    def flags(self, name, k=None):
        return {f for n, kk, f in self.calls
                if n == name and (k is None or (kk == 1) == (k == 1))}


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.random((2, 256, 6)).astype(np.float32)
    return x, (x[..., 2] * 8).astype(np.int32)


@pytest.mark.parametrize("model_name", ["pointnet2_sem_seg",
                                        "pointnet2_sem_seg_msg"])
@pytest.mark.parametrize("exact_gathers", [False, True])
def test_train_engine_routes_gathers(monkeypatch, model_name, exact_gathers):
    """train_batch gathers with fast=True by default and fast=False with
    exact_gathers=True; eval_batch always gathers exactly; the centroid
    gather (K=1) is always exact."""
    from tumseg_torch import models
    from tumseg_torch.train.loop import TrainEngine

    torch.manual_seed(0)
    model = models.get_module(model_name).get_model(8)
    kwargs = {} if not exact_gathers else dict(exact_gathers=True)
    eng = TrainEngine(model, 8, np.ones(8), device="cpu", **kwargs)
    assert eng.exact_gathers is exact_gathers
    spy = _Spy(monkeypatch)
    x, t = _batch(25)
    loss, _ = eng.train_batch(x, t, 1e-3, 0.1)
    assert np.isfinite(float(loss))
    fast = not exact_gathers
    assert spy.flags("group_points", k=32) == {fast}
    assert spy.flags("group_points", k=1) == {False}
    for name in ("three_nn_interpolate", "group_points_backward",
                 "interpolate_backward"):
        assert spy.flags(name) == {fast}, name
    spy.calls.clear()
    eng.eval_batch(x, t)
    assert spy.flags("group_points") == {False}
    assert spy.flags("three_nn_interpolate") == {False}
    assert not spy.flags("group_points_backward")


def test_train_cli_builds_the_engine_with_fast_gathers():
    """The training CLI leaves exact_gathers at its default, as tumseg's
    CLI does (tumseg/cli/train.py:256)."""
    import ast
    import inspect

    from tumseg_torch.cli import train as train_cli
    from tumseg_torch.train.loop import TrainEngine

    assert inspect.signature(TrainEngine).parameters[
        "exact_gathers"].default is False
    calls = [node for node in ast.walk(ast.parse(inspect.getsource(
        train_cli))) if isinstance(node, ast.Call)
        and getattr(node.func, "id", None) == "TrainEngine"]
    assert len(calls) == 1
    assert "exact_gathers" not in {k.arg for k in calls[0].keywords}


def test_ssg_layers_fast_match_tumseg_pallas(monkeypatch):
    """Each set abstraction and feature propagation of the SSG eval forward
    with fast_gather=True against tumseg's layer with fast_gather=True
    through its Pallas kernels in interpret mode (the interpolation's
    operands rounded to bf16 by hand, see above), each fed the port's
    previous outputs: centroids identical, features within rtol 1e-5 /
    atol 1e-4 (f32 MLPs, sums in another order, values up to ~10)."""
    from tumseg import ops as jops
    from tumseg.models import pointnet2_sem_seg as jmodel
    from tumseg.nn import layers as jl
    from tumseg.ops.pallas import kernels as pk
    from tumseg_torch.models.convert import (state_dict_from_variables,
                                             variables_from_state_dict)
    from tumseg_torch.models.pointnet2_sem_seg import SA_CFGS, get_model
    from tumseg_torch.nn.layers import calibrate_batch_norm

    exact_interp = pk.weighted_interpolate

    def single_pass(idx, weight, points2, fast=False):
        if fast:  # the TPU's one bf16 pass: round both operands
            weight = weight.astype(jnp.bfloat16).astype(jnp.float32)
            points2 = points2.astype(jnp.bfloat16).astype(jnp.float32)
        return exact_interp(idx, weight, points2, fast=False)

    monkeypatch.setattr(pk, "weighted_interpolate", single_pass)
    monkeypatch.setattr(jops, "_IMPL", "pallas")
    x = np.random.default_rng(26).random((1, 256, 6)).astype(np.float32)
    var = jax.tree_util.tree_map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(0), 8, 0))
    model = get_model(8).eval()
    model.load_state_dict(state_dict_from_variables(var), strict=True)
    calibrate_batch_norm(model, torch.from_numpy(x))
    var = variables_from_state_dict(model.state_dict())

    def layer(name):
        return (jax.tree_util.tree_map(jnp.asarray, var["params"][name]),
                jax.tree_util.tree_map(jnp.asarray,
                                       var["batch_stats"][name]))

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)

    j = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    xyz, pts = [_t(x[..., :3])], [_t(x)]
    with torch.inference_mode():
        for i, cfg in enumerate(SA_CFGS, start=1):
            new_j, feat_j, _ = jl.set_abstraction(
                *layer(f"sa{i}"), cfg, j(xyz[-1]), j(pts[-1]),
                training=False, momentum=0.1, fast_gather=True)
            new_t, feat_t = getattr(model, f"sa{i}")(xyz[-1], pts[-1],
                                                     fast_gather=True)
            np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
            close(feat_t, feat_j)
            xyz.append(new_t)
            pts.append(feat_t)
        feat = pts[4]
        for i, lvl in zip([4, 3, 2, 1], [3, 2, 1, 0]):
            skip = pts[lvl] if lvl > 0 else None
            want, _ = jl.feature_propagation(
                *layer(f"fp{i}"), j(xyz[lvl]), j(xyz[lvl + 1]), j(skip),
                j(feat), training=False, momentum=0.1, fast_gather=True)
            got = getattr(model, f"fp{i}")(xyz[lvl], xyz[lvl + 1], skip,
                                           feat, fast_gather=True)
            close(got, want)
            exact = getattr(model, f"fp{i}")(xyz[lvl], xyz[lvl + 1], skip,
                                             feat)
            assert (got - exact).abs().max() > 1e-5  # the fast path ran
            feat = got
