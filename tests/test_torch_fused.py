"""The port's fused ball query + group (``tumseg_torch.ops.fused_ball_group``)
against tumseg's fused Pallas kernels in interpret mode, on the same numpy
inputs, and the switch that routes ``ball_group`` to it.

The fused op's contract is ``query_ball_point`` followed by
``group_points`` of the same mode (``tumseg/ops/pallas/fusedgroup.py:
1-30``): indices identical and the grouped tensor bit for bit, f32 in exact
mode and bf16 in fast mode, for both of tumseg's kernel structures (one k a
grid step, and the unrolled k loop) and for N = 2048, where tumseg's cumsum
runs in two 1024-candidate chunks. Every input holds an empty ball (index
N, row -centre) and short balls (slots repeat the first pick). Shapes stay
small (B=1, S <= 64, K <= 16): the interpreter is slow."""

import os

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


# (N, radius): about 15 candidates a ball, so with K=16 some balls fill and
# some are short
CASES = {256: 0.25, 2048: 0.12}


def _inputs(N, S=64, C=7, seed=30):
    rng = np.random.default_rng(seed)
    xyz = rng.random((1, N, 3)).astype(np.float32)
    new_xyz = xyz[:, rng.choice(N, S, replace=False)].copy()
    new_xyz[:, 0] = 5.0  # an empty ball
    feats = rng.standard_normal((1, N, C - 3)).astype(np.float32)
    src = np.concatenate([xyz, feats], axis=-1)
    return xyz, new_xyz, src


@pytest.mark.parametrize("structure", ["gridk", "unroll"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("N", sorted(CASES))
def test_fused_matches_tumseg_pallas(N, fast, structure):
    from tumseg.ops.pallas.fusedgroup import _make_fused

    K, r = 16, CASES[N]
    xyz, new_xyz, src = _inputs(N)
    jg, ji = _make_fused(r, K, not fast, structure)(
        jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(src))
    grouped, idx = core.fused_ball_group(r, K, _t(xyz), _t(new_xyz), _t(src),
                                         fast)
    assert grouped.dtype == (torch.bfloat16 if fast else torch.float32)
    assert jg.dtype == (jnp.bfloat16 if fast else jnp.float32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_np(grouped), _np(jg))
    # the input has what the test claims: an empty ball, short and full ones
    idx = idx.numpy()[0]
    assert (idx[0] == N).all()
    np.testing.assert_array_equal(_np(grouped)[0, 0, :, :3],
                                  np.broadcast_to(-new_xyz[0, 0], (K, 3)))
    short = (idx[:, -1] == idx[:, 0]) & (idx[:, 0] != N)
    assert short.any() and (idx[:, -1] != idx[:, 0]).any()


@pytest.mark.parametrize("fast", [False, True])
def test_fused_is_query_then_group(fast):
    xyz, new_xyz, src = _inputs(256, seed=31)
    grouped, idx = tops.fused_ball_group(0.25, 16, _t(xyz), _t(new_xyz),
                                         _t(src), fast)
    want_idx = tops.query_ball_point(0.25, 16, _t(xyz), _t(new_xyz))
    assert torch.equal(idx, want_idx) and idx.dtype == torch.int32
    assert torch.equal(grouped, tops.group_points(want_idx, _t(src),
                                                  _t(new_xyz), fast))
    assert not idx.requires_grad


@pytest.mark.parametrize("fast", [False, True])
def test_fused_gradient_is_the_group_gradient(fast):
    xyz, new_xyz, src = _inputs(256, seed=32)
    g = torch.randn(1, 64, 16, 7, generator=torch.Generator().manual_seed(0))
    if fast:
        g = g.bfloat16()
    s_fused = _t(src).requires_grad_()
    grouped, idx = tops.fused_ball_group(0.25, 16, _t(xyz), _t(new_xyz),
                                         s_fused, fast)
    grouped.backward(g)
    s_split = _t(src).requires_grad_()
    tops.group_points(idx, s_split, _t(new_xyz), fast).backward(g)
    assert torch.equal(s_fused.grad, s_split.grad)
    assert torch.equal(s_fused.grad, core.group_points_backward(idx, g, 256,
                                                                fast))


@pytest.mark.parametrize("N,fused", [(256, True), (1024, True), (2048, True),
                                     (1536, False)])
@pytest.mark.parametrize("switch", ["context", "default", "off"])
def test_ball_group_takes_fused_where_tumseg_does(monkeypatch, N, fused,
                                                  switch):
    """ball_group takes the fused op exactly when the switch is on and
    N <= 1024 or N % 1024 == 0 (tumseg/ops/__init__.py:275-289); the
    process default is off and the context manager is scoped."""
    calls = []
    real = tops.fused_ball_group

    def spy(*args, **kwargs):
        calls.append(args[4].shape[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(tops, "fused_ball_group", spy)
    xyz, new_xyz, src = _inputs(N, S=8, seed=33)
    want = core.group_points(core.query_ball_point(0.2, 8, _t(xyz),
                                                   _t(new_xyz)),
                             _t(src), _t(new_xyz), True)
    assert not tops._fused_on()
    if switch == "default":
        monkeypatch.setattr(tops, "_fused_default", False)
        tops.set_fused_group(True)
        got = tops.ball_group(0.2, 8, _t(xyz), _t(new_xyz), _t(src), True)
        tops.set_fused_group(False)
    elif switch == "context":
        with tops.fused_group_enabled():
            got = tops.ball_group(0.2, 8, _t(xyz), _t(new_xyz), _t(src),
                                  True)
            with tops.fused_group_enabled(False):
                assert not tops._fused_on()
            assert tops._fused_on()
    else:
        got = tops.ball_group(0.2, 8, _t(xyz), _t(new_xyz), _t(src), True)
    assert not tops._fused_on()
    assert calls == ([N] if fused and switch != "off" else [])
    assert torch.equal(got, want)


def test_fused_switch_leaves_the_models_unchanged(monkeypatch):
    """Under the switch each SSG set abstraction takes the fused op
    (sample_and_group goes through ball_group) and the MSG ones never do
    (msg_ball_groups keeps the multi-radius query); the log-probs are the
    same bit for bit, in exact and in fast mode."""
    from tumseg_torch import models

    calls = []
    real = tops.fused_ball_group

    def spy(*args, **kwargs):
        calls.append(args[4].shape[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(tops, "fused_ball_group", spy)
    x = torch.from_numpy(np.random.default_rng(34).random(
        (1, 256, 6)).astype(np.float32))
    for name, want_calls in (("pointnet2_sem_seg", [256, 1024, 256, 64]),
                             ("pointnet2_sem_seg_msg", [])):
        torch.manual_seed(0)
        model = models.get_module(name).get_model(8).eval()
        with torch.inference_mode():
            for fast in (False, True):
                off = model(x, fast_gather=fast)[0]
                calls.clear()
                with tops.fused_group_enabled():
                    on = model(x, fast_gather=fast)[0]
                assert calls == want_calls, name
                assert torch.equal(on, off), name


def test_fused_and_fast_wrappers_refuse_cpu_tensors():
    """No wrapper runs its plain version: a CPU tensor is refused, in
    either mode, and nothing is counted."""
    from tumseg_torch.ops import kernels

    xyz, new_xyz, src = (_t(a) for a in _inputs(64, S=4, seed=35))
    kernels.reset_launches()
    for fast in (False, True):
        for call in (lambda: kernels.fused_ball_group(0.2, 4, xyz, new_xyz,
                                                      src, fast),
                     lambda: kernels.group_points(
                         torch.zeros(1, 4, 2, dtype=torch.int32), src,
                         new_xyz, fast),
                     lambda: kernels.group_points_backward(
                         torch.zeros(1, 4, 2, dtype=torch.int32),
                         torch.zeros(1, 4, 2, 7, dtype=torch.bfloat16), 64,
                         fast),
                     lambda: kernels.three_nn_interpolate(xyz, new_xyz,
                                                          new_xyz, fast)):
            with pytest.raises((ValueError, TypeError)):
                call()
    assert not any(kernels.launches.values())
    assert not any(kernels.fast_launches.values())
