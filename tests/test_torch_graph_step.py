"""The training engine's steps made ready for CUDA graphs, on the CPU.

On the card ``TrainEngine`` captures its steps as CUDA graphs
(``tumseg_torch/utils/graphs.py``); ``chip_smoke.py`` [cg] holds them bit
for bit against the eager steps there. What a capture needs is checked
here, where the steps run eagerly:

- ``confusion_tallies`` counts with fixed-shape ``scatter_add_`` and equals
  ``torch.bincount`` and ``tumseg``'s tallies;
- BN momentum held in device scalars (``BatchNorm.set_momentum``) gives
  the float-momentum step bit for bit, and the engine's step equals one
  jitted ``tumseg`` step within ``tests/test_torch_train.py``'s
  tolerances;
- the engine's persistent, re-seeded generators draw what fresh ones draw,
  and the sampler's split into rounds and selection samples what it did;
- the state_dict keys, a checkpoint's round trip through ``tumseg`` (all
  but ``num_batches_tracked``, which ``tumseg`` does not keep), and
  ``load_state`` moving the optimizer state's addresses, which drops the
  captured graphs (``StepGraphs.check_bindings``), while steps move none.

JAX compiles one step function here (B=2, N=256, 8 classes)."""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tumseg.models import pointnet2_sem_seg as jmodel
from tumseg.train import checkpoint as jckpt
from tumseg.train import loop as jloop
from tumseg.train import metrics as jmetrics
from tumseg_torch import ops
from tumseg_torch.data.device_sampler import DeviceBlockSampler
from tumseg_torch.models.convert import (state_dict_from_variables,
                                         variables_from_state_dict)
from tumseg_torch.models.pointnet2_sem_seg import get_model
from tumseg_torch.nn.layers import BatchNorm
from tumseg_torch.ops import kernels
from tumseg_torch.train import checkpoint as tckpt
from tumseg_torch.train import loop as tloop
from tumseg_torch.train import metrics as tmetrics
from tumseg_torch.utils.graphs import StepGraphs

B, N, C = 2, 256, 8
LR, WD = 1e-3, 1e-4
MOMENTA = (0.1, 0.05, 0.025, 0.0125, 0.01, 0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the suite runs several test
    processes at once, and more threads than cores slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- confusion tallies -------------------------------------------------------

def _tally_case(name):
    r = np.random.default_rng(7)
    target = r.integers(0, C, (B, N))
    if name == "random":
        pred = r.integers(0, C, (B, N))
    elif name == "missing_classes":    # classes 0, 5 and 7 never occur
        target = r.choice([1, 2, 3, 4, 6], (B, N))
        pred = np.where(r.random((B, N)) < 0.5, target,
                        r.choice([1, 2, 6], (B, N)))
    elif name == "all_wrong":
        pred = (target + 1 + r.integers(0, C - 1, (B, N))) % C
    elif name == "all_right":
        pred = target.copy()
    else:                               # one class everywhere, predicted
        target = np.full((B, N), 3)     # as another
        pred = np.full((B, N), 5)
    return pred, target


TALLY_CASES = ("random", "missing_classes", "all_wrong", "all_right",
               "one_class")


@pytest.mark.parametrize("case", TALLY_CASES)
def test_confusion_tallies_equal_bincount(case):
    pred, target = _tally_case(case)
    p, t = torch.from_numpy(pred), torch.from_numpy(target)
    got = tmetrics.confusion_tallies(p, t, C)
    pf, tf = p.reshape(-1), t.reshape(-1)
    want = {"seen": torch.bincount(tf, minlength=C),
            "predicted": torch.bincount(pf, minlength=C),
            "correct": torch.bincount(tf[pf == tf], minlength=C)}
    for k in want:
        assert got[k].dtype == torch.int64 and got[k].shape == (C,)
        assert torch.equal(got[k], want[k]), k
    assert int(got["seen"].sum()) == int(got["predicted"].sum()) == B * N
    if case == "all_wrong":
        assert int(got["correct"].sum()) == 0


@pytest.mark.parametrize("case", TALLY_CASES)
def test_confusion_tallies_match_tumseg(case):
    pred, target = _tally_case(case)
    got = tmetrics.confusion_tallies(torch.from_numpy(pred),
                                     torch.from_numpy(target), C)
    want = jmetrics.confusion_tallies(jnp.asarray(pred), jnp.asarray(target),
                                      C)
    for k in ("seen", "predicted", "correct"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# -- BN momentum and the learning rate as device scalars ---------------------

def _float_momentum_forward(self, x, mesh=None):
    """``BatchNorm.forward`` as it was with a Python-float ``momentum``,
    the reference of the device-scalar one (mesh-free)."""
    dtype = x.dtype
    x = x.to(torch.promote_types(dtype, torch.float32))
    if not self.training:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean) * inv + self.bias).to(dtype)
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dim=dims)
    sqmean = (x * x).mean(dim=dims)
    n = x.numel() // x.shape[-1]
    var = sqmean - mean * mean
    with torch.no_grad():
        m = self.float_momentum
        unbiased = var * (n / max(n - 1, 1))
        self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)
        self.num_batches_tracked += 1
    inv = torch.rsqrt(var + self.eps) * self.weight
    return ((x - mean) * inv + self.bias).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("momentum", MOMENTA)
def test_batch_norm_device_momentum_equals_float(momentum, dtype,
                                                 monkeypatch):
    r = np.random.default_rng(11)
    x = torch.from_numpy(r.standard_normal((2, 50, 8, 16)) * 3 + 1).to(dtype)
    bn = BatchNorm(16)    # f32 parameters and statistics, f64 momenta
    if dtype == torch.float64:
        bn = bn.double()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(r.random(16)))
        bn.running_var.copy_(torch.from_numpy(r.random(16) + 0.5))
    ref = copy.deepcopy(bn)
    bn.set_momentum(momentum)
    y = bn.train()(x)
    monkeypatch.setattr(BatchNorm, "forward", _float_momentum_forward)
    ref.float_momentum = momentum
    y_ref = ref.train()(x)
    assert torch.equal(y, y_ref)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn, name), getattr(ref, name)), name


def test_batch_norm_state_dict_keys_unchanged():
    bn = BatchNorm(4)
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean",
                                     "running_var", "num_batches_tracked"]
    assert {n for n, _ in bn.named_buffers()} == {
        "running_mean", "running_var", "num_batches_tracked", "momentum",
        "momentum_keep"}
    # every model converts to tumseg's variables and back with strict keys
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(
        variables_from_state_dict(model.state_dict())), strict=True)


def test_optimizers_on_the_cpu_keep_float_learning_rates():
    params = [torch.zeros(3, requires_grad=True)]
    for name in ("Adam", "SGD"):
        opt = tloop.make_optimizer(params, name, WD)
        assert isinstance(opt.param_groups[0]["lr"], float)
        assert not opt.param_groups[0].get("capturable", False)
        tloop.set_learning_rate(opt, 2e-3)
        assert opt.param_groups[0]["lr"] == 2e-3
    # a tensor learning rate is filled in place: a graph holds its address
    lr = torch.tensor(1e-3)
    opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    tloop.set_learning_rate(opt, 5e-4)
    assert opt.param_groups[0]["lr"] is lr
    assert float(lr) == np.float32(5e-4)


def _batches(seed, n):
    r = np.random.default_rng(seed)
    return [((r.random((B, N, 6)).astype(np.float32) - np.float32(0.5)),
             r.integers(0, C, (B, N)).astype(np.int32)) for _ in range(n)]


def _float_schedule_step(model, opt, weights, x, t, lr, momentum):
    """The port's train step as it was before the device scalars: the
    learning rate set on every group and a float BN momentum, each step."""
    model.train()
    for group in opt.param_groups:
        group["lr"] = lr
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.float_momentum = momentum
    logp, aux = model(x, fast_gather=False)
    loss = model.loss(logp, t, aux, weights)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach(), (logp.detach().argmax(-1) == t).sum()


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_engine_step_equals_float_schedule_step(name, monkeypatch):
    """The engine's steps (device-scalar momentum, written only when it
    changes) against the float-argument steps, bit for bit, across a change
    of learning rate and momentum."""
    torch.manual_seed(0)
    model = get_model(C)
    w = np.random.default_rng(2).random(C) + 0.5
    eng = tloop.TrainEngine(copy.deepcopy(model), C, w, optimizer=name,
                            weight_decay=WD, device="cpu",
                            augment_rotate=False, exact_gathers=True)
    eng.generator = None
    schedule = [(1e-3, 0.1), (1e-3, 0.1), (7e-4, 0.05)]
    batches = _batches(3, len(schedule))
    got = [eng.train_batch(x, t, lr, m)
           for (x, t), (lr, m) in zip(batches, schedule)]
    monkeypatch.setattr(BatchNorm, "forward", _float_momentum_forward)
    opt = tloop.make_optimizer(model.parameters(), name, WD)
    tw = torch.as_tensor(w, dtype=torch.float32)
    want = [_float_schedule_step(model, opt, tw, torch.from_numpy(x),
                                 torch.from_numpy(t).long(), lr, m)
            for (x, t), (lr, m) in zip(batches, schedule)]
    for (gl, gc), (wl, wc) in zip(got, want):
        assert torch.equal(gl, wl) and torch.equal(gc, wc)
    for a, b in zip(eng.model.state_dict().values(),
                    model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(eng.optimizer.state.values(), opt.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in b)


@pytest.fixture(scope="module")
def one_step():
    """One jitted tumseg train step and the port engine's step on the same
    weights and batch (train-mode BN at momentum 0.05, no draws, exact
    gathers, Adam at lr 2e-3)."""
    lr, momentum = 2e-3, 0.05
    r = np.random.default_rng(1)
    x = r.random((B, N, 6)).astype(np.float32) - np.float32(0.5)
    t = r.integers(0, C, (B, N)).astype(np.int32)
    w = (r.random(C) + 0.5).astype(np.float32)
    var = jax.tree_util.tree_map(np.asarray,
                                 jmodel.init(jax.random.PRNGKey(0), C, 0))
    tx = jloop.make_optimizer("Adam", weight_decay=WD)
    jw = jnp.asarray(w)

    @jax.jit
    def step(params, stats, opt_state, x, t):
        def loss_fn(p):
            logp, aux, new_stats = jmodel.apply(
                {"params": p, "batch_stats": stats}, x, training=True,
                bn_momentum=momentum, rngs={})
            return jmodel.loss(logp, t, aux, jw), new_stats

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(
            params, jax.tree_util.tree_map(lambda u: u * lr, updates))
        return params, new_stats, loss, grads

    params, stats, loss, grads = step(var["params"], var["batch_stats"],
                                      tx.init(var["params"]), jnp.asarray(x),
                                      jnp.asarray(t))
    model = get_model(C)
    model.load_state_dict(state_dict_from_variables(var), strict=True)
    eng = tloop.TrainEngine(model, C, w, weight_decay=WD, device="cpu",
                            augment_rotate=False, exact_gathers=True)
    eng.generator = None
    got_loss, _ = eng.train_batch(x, t, lr, momentum)
    return dict(jax=dict(loss=float(loss), grads=grads, params=params,
                         stats=stats),
                port_loss=float(got_loss), engine=eng)


def test_engine_step_matches_tumseg(one_step):
    """Loss within rtol 1e-4 and the whole gradient within 20% in norm, as
    tests/test_torch_train.py holds the float step."""
    np.testing.assert_allclose(one_step["port_loss"],
                               one_step["jax"]["loss"], rtol=1e-4)
    model = one_step["engine"].model
    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    got = list(tckpt._flatten(variables_from_state_dict(sd)["params"]))
    want = jckpt._flatten_model(one_step["jax"]["grads"])
    assert [p for p, _ in got] == [p for p, _ in want]
    diff = np.concatenate([np.ravel(g - np.asarray(jg))
                           for (_, g), (_, jg) in zip(got, want)])
    ref = np.concatenate([np.ravel(np.asarray(jg)) for _, jg in want])
    assert np.linalg.norm(diff) <= 0.2 * np.linalg.norm(ref)


def test_engine_momentum_updates_running_stats_as_tumseg(one_step):
    """The first set abstraction's first BN, whose input is one f32 GEMM
    away from the batch: its running statistics after the step at momentum
    0.05 within tests/test_torch_train.py's BN tolerance."""
    bn = one_step["engine"].model.sa1.mlp_bns[0]
    stats = one_step["jax"]["stats"]["sa1"][0]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-4)
    assert float(bn.momentum) == 0.05 and float(bn.momentum_keep) == 0.95


# -- persistent generators and the sampler's split ---------------------------

@pytest.fixture(scope="module")
def sampler():
    r = np.random.default_rng(5)
    rooms = []
    for i in range(2):
        xyz = r.random((6000, 3)) * np.array([2.0, 1.5, 3.0]) + i
        rooms.append(xyz)
    labels = [r.integers(0, C, len(p)) for p in rooms]
    extras = [[r.random(len(p)) * 255] for p in rooms]
    return DeviceBlockSampler(rooms, labels, extras, [True], num_point=256,
                              min_block_points=200, device="cpu")


def _engine(sampler, seed=0):
    torch.manual_seed(0)
    return tloop.TrainEngine(get_model(C, 1), C, np.ones(C), seed=seed,
                             device="cpu", sampler=sampler)


def test_reseeded_generators_draw_what_fresh_ones_draw(sampler):
    eng = _engine(sampler, seed=3)
    kept = eng._streams(5, 3)
    draws = [torch.rand(4, generator=g) for g in kept]
    for count, d in zip(range(5, 8), draws):
        fresh = torch.Generator().manual_seed(
            tloop.stream_seed(3, count, None))
        assert torch.equal(d, torch.rand(4, generator=fresh))
    # the same objects, re-seeded, for a shorter and a longer call
    again = eng._streams(5, 2)
    assert all(a is b for a, b in zip(again, kept))
    assert torch.equal(torch.rand(4, generator=again[1]), draws[1])
    longer = eng._streams(9, 4)
    assert longer[:3] == kept and len(eng._gens) == 4
    fresh = torch.Generator().manual_seed(tloop.stream_seed(3, 12, None))
    assert torch.equal(torch.rand(4, generator=longer[3]),
                       torch.rand(4, generator=fresh))


def test_accept_then_draw_select_equals_sample_batches(sampler):
    ids = np.array([[0, 1], [1, 0], [0, 0]], np.int32)

    def gens():
        return [torch.Generator().manual_seed(40 + i) for i in range(3)]
    want = sampler.sample_batches_aux(ids, gens())
    g = gens()
    rid, center, cnt = sampler.accept(ids, g)
    points, labels, sel = sampler.draw_select(rid, center, cnt, g)
    got = (points, labels, center.view(3, 2, 3), cnt.view(3, 2), sel)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_supersteps_of_several_sizes_equal_single_steps(sampler):
    """A 3-step call after a 2-step one (the persistent generators reused
    and one added) against 5 single steps, bit for bit."""
    r = np.random.default_rng(9)
    ids = r.integers(0, 2, (5, B)).astype(np.int32)
    multi, single = _engine(sampler), _engine(sampler)
    lm = torch.cat([multi.train_batch_rooms_multi(ids[:2], LR, 0.1)[0],
                    multi.train_batch_rooms_multi(ids[2:], LR, 0.1)[0]])
    ls = torch.stack([single.train_batch_rooms(i, LR, 0.1)[0] for i in ids])
    assert torch.equal(lm, ls) and bool(torch.isfinite(lm).all())
    for a, b in zip(multi.model.state_dict().values(),
                    single.model.state_dict().values()):
        assert torch.equal(a, b)
    el, et = multi.eval_batch_rooms_multi(ids[:3])
    singles = [single.eval_batch_rooms(i) for i in ids[:3]]
    assert torch.equal(el, torch.stack([l for l, _ in singles]))
    for k in tloop.TALLIES:
        assert torch.equal(et[k], sum(t[k] for _, t in singles))


# -- what a graph holds: keys, bindings, load_state --------------------------

def test_engine_on_the_cpu_has_no_graphs(sampler):
    eng = _engine(sampler)
    assert eng.graphs is None
    assert tloop.TrainEngine(get_model(C), C, np.ones(C), device="cpu",
                             cuda_graphs=False).graphs is None


def test_ops_switches_key_the_graphs():
    base = ops.switches()
    assert base == (False, False, False)
    with ops.plain():
        assert ops.switches()[0]
    with ops.window_enabled():
        assert ops.switches()[1]
    with ops.fused_group_enabled():
        assert ops.switches()[2]
    assert ops.switches() == base


def test_bindings_stable_across_steps_and_moved_by_load_state(sampler,
                                                               tmp_path):
    eng = _engine(sampler)
    eng.train_batch_rooms(np.array([0, 1], np.int32), LR, 0.1)
    bound = eng._bindings()
    eng.train_batch_rooms_multi(np.array([[1, 1], [0, 1]], np.int32), LR,
                                0.05)
    eng.eval_batch_rooms(np.array([0, 0], np.int32))
    assert eng._bindings() == bound      # every step writes in place
    path = str(tmp_path / "ckpt.pth")
    eng.save(path, 3)
    # a captured graph of the engine, as the card would hold one
    graphs = StepGraphs("cpu")
    graphs.check_bindings(bound)
    graphs.graphs["train_rooms"] = object()
    graphs._warm.add("train_rooms")
    graphs.check_bindings(eng._bindings())
    assert "train_rooms" in graphs.graphs
    assert eng.load_state(tckpt.load_checkpoint(path)) == 3
    assert eng._bindings() != bound      # the optimizer state was replaced
    graphs.check_bindings(eng._bindings())
    assert not graphs.graphs and not graphs._warm


def test_checkpoint_round_trips_through_tumseg(sampler, tmp_path):
    """The port's state after two steps -> tumseg's engine -> tumseg's
    checkpoint -> a fresh port engine: every weight, BN running statistic
    and Adam moment equal, and the next step equal bit for bit."""
    eng = _engine(sampler)
    for ids in ([0, 1], [1, 1]):
        eng.train_batch_rooms(np.array(ids, np.int32), LR, 0.1)
    first = str(tmp_path / "port.pth")
    eng.save(first, 2)
    jeng = jloop.TrainEngine(jmodel, C, np.ones(C), optimizer="Adam")
    assert jeng.load_state(jckpt.load_checkpoint(first)) == 2
    second = str(tmp_path / "tumseg.pth")
    jckpt.save_checkpoint(second, epoch=2, variables=jeng.variables(),
                          opt_state=jeng.opt_state)
    back = _engine(sampler)
    assert back.load_state(tckpt.load_checkpoint(second)) == 2
    # tumseg keeps no num_batches_tracked: it comes back as 0
    got, want = back.model.state_dict(), eng.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 0 and int(want[k]) == 2
        else:
            assert torch.equal(got[k], want[k]), k
    for a, b in zip(tckpt.optimizer_leaves(back.optimizer, back.model),
                    tckpt.optimizer_leaves(eng.optimizer, eng.model)):
        np.testing.assert_array_equal(a, b)
    back._step_count = eng._step_count
    ids = np.array([0, 0], np.int32)
    nxt = [e.train_batch_rooms(ids, LR, 0.1)[0] for e in (eng, back)]
    assert torch.equal(*nxt) and math.isfinite(float(nxt[0]))


def test_captured_launches_count_on_replay():
    kernels.reset_launches()
    with kernels.capturing() as tally:
        assert kernels._captured is tally
        tally[0]["group"] += 2
        tally[1]["group"] += 1
    assert kernels._captured is None and kernels.launches["group"] == 0
    for _ in range(3):
        kernels.replayed(tally)
    assert kernels.launches["group"] == 6
    assert kernels.fast_launches["group"] == 3
    kernels.reset_launches()
