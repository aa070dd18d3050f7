"""The last two public names of ``tumseg`` with a counterpart in the port:
``tumseg_torch.ops.group_neighborhoods`` against
``tumseg.ops.group_neighborhoods`` (its XLA composition, exact, atol 0; the
fast mode against ``tumseg``'s Pallas group in interpret mode, bit for bit
as tests/test_torch_fast.py holds the fast group), and
``tumseg_torch.train.metrics.accumulate`` against
``tumseg.train.metrics.accumulate``, which ``TrainEngine``'s eval sums
call."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumseg import ops as jops
from tumseg.train import metrics as jmetrics
from tumseg_torch import ops as tops
from tumseg_torch.train import loop
from tumseg_torch.train import metrics as tmetrics


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


def _inputs(B, N, S, K, C, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, (B, S, K)).astype(np.int32)
    idx[:, 0, :] = N                  # an empty ball: the sentinel
    idx[:, 1, 3:] = idx[:, 1, :1]     # a short ball padded with its first
    src = (rng.standard_normal((B, N, C)) * 3).astype(np.float32)
    new_xyz = rng.standard_normal((B, S, 3)).astype(np.float32)
    return idx, src, new_xyz


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("B,N,S,K,C", [(2, 128, 32, 8, 9), (1, 96, 16, 16, 35),
                                       (3, 64, 8, 32, 3)])
def test_group_neighborhoods_matches_tumseg_exact(B, N, S, K, C,
                                                  monkeypatch):
    monkeypatch.setattr(jops, "_IMPL", "xla")
    idx, src, new_xyz = _inputs(B, N, S, K, C, 31)
    idx[:, 0, :] = 0          # XLA's take clamps; the sentinel is Pallas's
    want = jops.group_neighborhoods(jnp.asarray(idx), jnp.asarray(src),
                                    jnp.asarray(new_xyz))
    got = tops.group_neighborhoods(torch.from_numpy(idx),
                                   torch.from_numpy(src),
                                   torch.from_numpy(new_xyz))
    assert got.dtype == torch.float32 and got.shape == (B, S, K, C)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=0)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("B,N,S,K,C", [(2, 128, 32, 8, 9),
                                       (1, 96, 16, 16, 35)])
def test_group_neighborhoods_matches_tumseg_pallas(B, N, S, K, C, fast,
                                                   monkeypatch):
    monkeypatch.setattr(jops, "_IMPL", "pallas")
    idx, src, new_xyz = _inputs(B, N, S, K, C, 32)
    want = jops.group_neighborhoods(jnp.asarray(idx), jnp.asarray(src),
                                    jnp.asarray(new_xyz), fast_gather=fast)
    got = tops.group_neighborhoods(torch.from_numpy(idx),
                                   torch.from_numpy(src),
                                   torch.from_numpy(new_xyz),
                                   fast_gather=fast)
    assert (got.dtype == torch.bfloat16) is fast
    assert (want.dtype == jnp.bfloat16) is fast
    np.testing.assert_array_equal(_np(got), _np(want))
    assert torch.equal(got, tops.group_points(
        torch.from_numpy(idx), torch.from_numpy(src),
        torch.from_numpy(new_xyz), fast=fast))


def test_accumulate_matches_tumseg():
    rng = np.random.default_rng(33)
    draws = [{k: rng.integers(0, 1000, 8) for k in ("seen", "predicted",
                                                    "correct")}
             for _ in range(4)]
    want = jmetrics.zero_tallies(8)
    want = {k: jnp.asarray(v, jnp.int32) for k, v in want.items()}
    got = {k: torch.zeros(8, dtype=torch.int64) for k in want}
    for t in draws:
        want = jmetrics.accumulate(want, {k: jnp.asarray(v, jnp.int32)
                                          for k, v in t.items()})
        same = tmetrics.accumulate(got, {k: torch.as_tensor(v)
                                         for k, v in t.items()})
        assert same is got
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_engine_sums_eval_tallies_with_accumulate(monkeypatch):
    calls = []
    real = tmetrics.accumulate

    def spy(acc, tallies):
        calls.append(set(acc))
        return real(acc, tallies)

    monkeypatch.setattr(tmetrics, "accumulate", spy)
    t = {k: torch.tensor([1, 2]) for k in loop.TALLIES}
    first = loop._add_tallies(None, t)
    assert first is not t and not calls
    total = loop._add_tallies(first, t)
    assert calls == [set(loop.TALLIES)]
    assert all(torch.equal(total[k], torch.tensor([2, 4])) for k in t)
    assert all(torch.equal(t[k], torch.tensor([1, 2])) for k in t)
