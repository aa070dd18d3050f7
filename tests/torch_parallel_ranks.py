"""The rank side of tests/test_torch_parallel.py: every check that needs a
2-rank gloo group on the CPU, run once in ``tumseg_torch.parallel.spawn``'s
ranks. Imports neither JAX nor tumseg: the test process computes tumseg's
side and compares. :func:`run` returns rank 0's results, numpy arrays and
plain numbers keyed by check."""

import numpy as np
import torch

from tumseg_torch import models
from tumseg_torch.data.dataset import TestGridDataset
from tumseg_torch.data.device_sampler import DeviceBlockSampler
from tumseg_torch.infer.voting import InferenceRunner
from tumseg_torch.models.convert import state_dict_from_variables
from tumseg_torch.models.pointnet_sem_seg import PointNetSemSeg
from tumseg_torch.parallel import mesh as pmesh
from tumseg_torch.parallel.dryrun import exact_step
from tumseg_torch.train.loop import TrainEngine

C = 8


def _np(d):
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def _collectives(mesh):
    """psum / pmean forward and backward on rank-dependent values: rank r
    holds x = (r + 1) * [1, 2] and weights its output by (r + 1)."""
    out = {}
    for name, fn in (("psum", pmesh.psum), ("pmean", pmesh.pmean)):
        x = (torch.tensor([1.0, 2.0]) * (mesh.rank + 1)).requires_grad_()
        y = fn(x, mesh)
        (y * (mesh.rank + 1)).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def _ranks_equal(mesh, params):
    """Whether every rank holds rank 0's parameters bit for bit."""
    flat = torch.cat([p.reshape(-1) for p in params.values()])
    mine = flat.clone()
    same = torch.tensor([float(torch.equal(mesh.broadcast_(flat), mine))])
    return bool(mesh.all_reduce_(same).item() == mesh.size)


def _superstep(mesh):
    """On the mesh, one 2-step room-id call against two single steps."""
    r = np.random.default_rng(5)
    rooms = [np.stack([r.uniform(0, 2, 2000), r.uniform(0, 2, 2000),
                       r.uniform(0, 1, 2000)], 1) for _ in range(2)]
    sampler = DeviceBlockSampler(rooms, [r.integers(0, C, 2000)
                                         for _ in rooms], [[], []], [],
                                 num_point=128, min_block_points=16,
                                 device="cpu")
    ids = np.array([[0, 1, 1, 0], [1, 1, 0, 0]], np.int32)
    engines = []
    for _ in range(2):
        torch.manual_seed(1)
        engines.append(TrainEngine(models.get_module("pointnet2_sem_seg")
                                   .get_model(C), C, np.ones(C), seed=0,
                                   device="cpu", sampler=sampler, mesh=mesh))
    multi, single = engines
    try:    # a ragged batch raises before any collective, on every rank
        multi.train_batch_rooms(np.array([0, 1, 0], np.int32), 1e-3, 0.1)
        ragged = ""
    except ValueError as e:
        ragged = str(e)
    losses = multi.train_batch_rooms_multi(ids, 1e-3, 0.1)[0]
    singles = torch.stack([single.train_batch_rooms(i, 1e-3, 0.1)[0]
                           for i in ids])
    same = all(torch.equal(a, b) for a, b in
               zip(multi.model.state_dict().values(),
                   single.model.state_dict().values()))
    return dict(losses=losses.numpy(), singles=singles.numpy(),
                state_equal=same, ragged=ragged)


def _votes(mesh):
    """Labels of the three vote paths on the mesh and in one process."""
    r = np.random.default_rng(6)
    n = 3000
    ds = TestGridDataset(num_classes=C, block_points=128, seed=0)
    ds.scene_points_list = [np.stack([r.uniform(0, 3, n), r.uniform(0, 1, n),
                                      r.uniform(0, 2, n)], 1)]
    ds.semantic_labels_list = [r.integers(0, C, n)]
    ds.file_list = ["scene.las"]
    ds.labelweights = np.ones(C, dtype=np.float32)
    torch.manual_seed(3)
    model = models.get_module("pointnet2_sem_seg").get_model(C)
    out = {}
    for path, kw in (("host", dict(device_features=False)),
                     ("features", dict(device_features=True,
                                       device_reblock=False)),
                     ("reblock", dict(device_features=True,
                                      device_reblock=True))):
        labels = []
        for m in (mesh, None):
            ds._rng = np.random.default_rng(0)   # the same host draws
            labels.append(InferenceRunner(model, C, batch_size=4,
                                          device="cpu", mesh=m,
                                          **kw).infer_scene(ds, 0, 2))
        out[path] = labels
    return out


def _regularizer(mesh):
    """PointNet's loss on the mesh (rank r holds rows 2r, 2r + 1) against
    the loss of all four rows, and its gradients divided by the mesh size
    against the full gradients' rows."""
    r = np.random.default_rng(7)
    logp = torch.log_softmax(torch.as_tensor(
        r.standard_normal((4, 16, C)), dtype=torch.float32), -1)
    target = torch.as_tensor(r.integers(0, C, (4, 16)))
    trans = torch.as_tensor(r.standard_normal((4, 64, 64)) * 0.1 +
                            np.eye(64), dtype=torch.float32)
    weight = torch.as_tensor(r.random(C) + 0.5, dtype=torch.float32)
    rows = mesh.rows(4)
    local = trans[rows].clone().requires_grad_()
    loss = PointNetSemSeg.loss(logp[rows], target[rows], local, weight,
                               mesh=mesh)
    loss.backward()
    full = trans.clone().requires_grad_()
    want = PointNetSemSeg.loss(logp, target, full, weight)
    want.backward()
    return dict(loss=float(loss), want=float(want),
                grad=(local.grad / mesh.size).numpy(),
                want_grad=full.grad[rows].numpy())


def run(rank, variables, points, target, weight):
    """Every check on this rank of a 2-rank gloo group. ``variables`` are
    tumseg's SSG variables (numpy), ``points``/``target``/``weight`` the
    global batch of the step held against tumseg's."""
    mesh = pmesh.make_mesh(2, devices="cpu", backend="gloo")
    ssg = models.get_module("pointnet2_sem_seg")
    state = state_dict_from_variables(variables)
    out = dict(collectives=_collectives(mesh))
    steps = {}
    for name, m, k in (("mesh", mesh, 1), ("one", None, 1),
                       ("mesh3", mesh, 3)):
        model = ssg.get_model(C)
        model.load_state_dict(state, strict=True)
        steps[name] = exact_step(model, points, target, weight, mesh=m,
                                 steps=k, optimizer="SGD")
    out["step"] = {name: dict(losses=s["losses"], grads=_np(s["grads"]),
                              params=_np(s["params"]), stats=_np(s["stats"]))
                   for name, s in steps.items() if name != "mesh3"}
    out["ranks_equal"] = _ranks_equal(mesh, steps["mesh3"]["params"])
    out["superstep"] = _superstep(mesh)
    out["ragged"] = out["superstep"].pop("ragged")
    out["votes"] = _votes(mesh)
    out["regularizer"] = _regularizer(mesh)
    return out
