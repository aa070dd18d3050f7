"""The rank side of tests/test_torch_mesh_graphs.py: a 2-rank gloo group on
the CPU, spawned once by ``tumseg_torch.parallel.spawn``, runs the mesh's
train, eval, room-id and vote programs twice, once through a stand-in for
``StepGraphs.run`` (:class:`Programs`, which runs each program eagerly) and
once eagerly, and records every collective that the mesh issues and where.
Imports neither JAX nor tumseg: the test process computes tumseg's side."""

import contextlib
import copy
import json
import os

import numpy as np
import torch

from tumseg_torch import models
from tumseg_torch.data.dataset import TestGridDataset
from tumseg_torch.data.device_sampler import DeviceBlockSampler
from tumseg_torch.infer import voting
from tumseg_torch.infer.voting import InferenceRunner
from tumseg_torch.models.convert import state_dict_from_variables
from tumseg_torch.nn.layers import BatchNorm
from tumseg_torch.parallel import mesh as pmesh
from tumseg_torch.train.loop import TrainEngine
from tumseg_torch.utils.graphs import agree_on_key, describe_key

C, N = 8, 256
LR, MOMENTUM = 1e-3, 0.1


class Collectives:
    """Every ``Mesh.all_reduce_`` and ``Mesh.broadcast_`` of this rank as
    (op, where): where is "program" inside a program call, "allowed"
    inside ``broadcast_state`` or a host draw's broadcast, else None."""

    def __init__(self):
        self.where = None
        self.log = []

    @contextlib.contextmanager
    def within(self, where):
        prev, self.where = self.where, where
        try:
            yield
        finally:
            self.where = prev

    def install(self):
        """Wraps the mesh's two collectives and the two callers that may
        issue them outside a program; the stand-in plays a mesh whose
        collectives can be captured."""
        for op in ("all_reduce_", "broadcast_"):
            real = getattr(pmesh.Mesh, op)

            def counted(mesh, *args, _real=real, _op=op, **kw):
                self.log.append((_op, self.where))
                return _real(mesh, *args, **kw)
            setattr(pmesh.Mesh, op, counted)
        for owner, name in ((pmesh, "broadcast_state"),
                            (voting._HostDraws, "next")):
            real = getattr(owner, name)

            def allowed(*args, _real=real, **kw):
                with self.within("allowed"):
                    return _real(*args, **kw)
            setattr(owner, name, allowed)
        pmesh.Mesh.capturable = property(lambda mesh: True)

    def take(self):
        """The log since the last call, and a fresh one."""
        log, self.log = self.log, []
        return log


class Programs:
    """``StepGraphs.run``'s signature: each program runs eagerly, inside
    ``Collectives.within("program")``, and its key is recorded."""

    def __init__(self, collectives):
        self.collectives = collectives
        self.keys = []

    def run(self, key, fn, inputs, generators, bindings):
        bindings()
        self.keys.append(describe_key(key))
        with self.collectives.within("program"):
            return fn(*inputs)


def _np(t):
    """A copy: a CPU tensor's numpy() shares its memory, which a later
    step writes in place."""
    return t.detach().cpu().numpy().copy()


def _state(engine):
    """Parameters, buffers and optimizer state by name, as numpy."""
    model = engine.model
    out = {f"param {n}": _np(p) for n, p in model.named_parameters()}
    out.update({f"buffer {n}": _np(b) for n, b in model.named_buffers()})
    names = {p: n for n, p in model.named_parameters()}
    for p, state in engine.optimizer.state.items():
        out.update({f"{k} {names[p]}": _np(v) for k, v in state.items()
                    if isinstance(v, torch.Tensor)})
    return out


def _flat(out):
    """A call's tensors (nested tuples and dicts) as a list of numpy."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [_np(out)]


def _train_exact(engine, batch):
    """tumseg's ``rngs={}`` SGD step twice (no draws, exact gathers): the
    first step's loss, gradients and BN statistics, then a second step."""
    x, t, w = batch
    engine.generator = None
    out = [engine.train_batch(x, t, LR, MOMENTUM)]
    grads = {n: _np(p.grad) for n, p in engine.model.named_parameters()}
    stats = {f"{n}.{b}": _np(getattr(m, b))
             for n, m in engine.model.named_modules()
             if isinstance(m, BatchNorm)
             for b in ("running_mean", "running_var")}
    out.append(engine.train_batch(x, t, LR, MOMENTUM))
    return dict(calls=[_flat(o) for o in out], grads=grads, stats=stats)


def _train_draws(engine, batch):
    """Adam steps with the engine's draws (rotation, FPS starts, dropout)
    and fast gathers."""
    x, t, _ = batch
    return dict(calls=[_flat(engine.train_batch(x, t, LR, MOMENTUM))
                       for _ in range(2)])


def _eval(engine, batch):
    x, t, _ = batch
    return dict(calls=[_flat(engine.eval_batch(x, t)) for _ in range(2)])


def _rooms(k):
    """Room-id calls of ``k`` steps (k = 1: ``train_batch_rooms``), then
    ``eval_batch_rooms``."""
    def run(engine, batch):
        ids = np.random.default_rng(11).integers(0, 2, (2, k, 4)).astype(
            np.int32)
        calls = []
        for i in ids:
            if k == 1:
                calls.append(engine.train_batch_rooms(i[0], LR, MOMENTUM))
            else:
                calls.append(engine.train_batch_rooms_multi(i, LR, MOMENTUM))
        calls.append(engine.eval_batch_rooms(ids[0, 0]))
        return dict(calls=[_flat(c) for c in calls])
    return run


def _sampler():
    r = np.random.default_rng(5)
    rooms = [np.stack([r.uniform(0, 2, 2000), r.uniform(0, 2, 2000),
                       r.uniform(0, 1, 2000)], 1) for _ in range(2)]
    return DeviceBlockSampler(rooms, [r.integers(0, C, 2000) for _ in rooms],
                              [[], []], [], num_point=N, min_block_points=16,
                              device="cpu")


def _scene():
    r = np.random.default_rng(6)
    n = 3000
    ds = TestGridDataset(num_classes=C, block_points=N, seed=0)
    ds.scene_points_list = [np.stack([r.uniform(0, 3, n), r.uniform(0, 1, n),
                                      r.uniform(0, 2, n)], 1)]
    ds.semantic_labels_list = [r.integers(0, C, n)]
    ds.file_list = ["scene.las"]
    ds.labelweights = np.ones(C, dtype=np.float32)
    return ds


PATHS = {"host": dict(device_features=False),
         "features": dict(device_features=True, device_reblock=False),
         "reblock": dict(device_features=True, device_reblock=True)}


def run(rank, variables, points, target, weight, out_dir):
    """Every scenario on this rank of a 2-rank gloo group; writes this
    rank's program keys to ``out_dir/keys<rank>.json``, returns rank 0's
    results by scenario."""
    mesh = pmesh.make_mesh(2, devices="cpu", backend="gloo")
    out = {"capturable": pmesh.Mesh.capturable.fget(mesh)}
    collectives = Collectives()
    collectives.install()
    state = state_dict_from_variables(variables)
    ssg = models.get_module("pointnet2_sem_seg")
    base = ssg.get_model(C)
    base.load_state_dict(state, strict=True)
    batch = (points, target, weight)
    sampler = _sampler()
    keys = {}

    engine_runs = {
        "train": (_train_exact, dict(optimizer="SGD", augment_rotate=False,
                                     exact_gathers=True)),
        "train_draws": (_train_draws, {}),
        "eval": (_eval, {}),
        "rooms_k1": (_rooms(1), dict(sampler=sampler)),
        "rooms_k4": (_rooms(4), dict(sampler=sampler)),
    }
    for name, (fn, kw) in engine_runs.items():
        res = {}
        for mode in ("programs", "eager"):
            engine = TrainEngine(copy.deepcopy(base), C, weight, seed=3,
                                 device="cpu", mesh=mesh, **kw)
            if mode == "programs":
                engine.graphs = Programs(collectives)
                collectives.take()
            res[mode] = fn(engine, batch)
            res[mode]["state"] = _state(engine)
            if mode == "programs":
                res["log"] = collectives.take()
                keys[name] = engine.graphs.keys
        out[name] = res

    ds = _scene()
    for path, kw in PATHS.items():
        res = {}
        for mode in ("programs", "eager"):
            runner = InferenceRunner(base, C, batch_size=4, device="cpu",
                                     mesh=mesh, seed=2, **kw)
            if mode == "programs":
                runner.graphs = Programs(collectives)
                collectives.take()
            ds._rng = np.random.default_rng(0)   # the same host draws
            labels = runner.infer_scene(ds, 0, 2)
            res[mode] = dict(labels=labels,
                             pool=_np(runner._buffers["pool"]))
            if mode == "programs":
                res["log"] = collectives.take()
                keys[f"vote_{path}"] = runner.graphs.keys
        out[f"vote_{path}"] = res

    # the key check: equal keys pass, a rank-dependent one raises on both
    gen = torch.Generator()
    collectives.take()
    agree_on_key(mesh, "warm-up", ("train", (2, N, 6), gen, None, False))
    try:
        agree_on_key(mesh, "capture", ("train", rank))
        out["differing_key"] = ""
    except RuntimeError as e:
        out["differing_key"] = str(e)
    out["agreed_log"] = collectives.take()

    with open(os.path.join(out_dir, f"keys{rank}.json"), "w") as f:
        json.dump(keys, f)
    return out
