"""The port's multi-device dry run (``__graft_entry__.dryrun_multichip``,
``__graft_entry__.py:81-230``), with that check's bounds:

1. one SSG train step on the mesh (rotation, random FPS starts, dropout):
   a finite loss;
2. on the mesh, a ``k``-step device-pipeline call against ``k`` single
   steps: losses within 2e-5 relative;
3. votes on the mesh (device re-blocking) against the same votes in one
   process: at most 0.1% of labels differ;
4. a PointNet + SGD step with no augmentation on the mesh against one
   process (8 blocks a rank, of distinct scales): loss within 1e-5
   relative, parameters within 5e-4.

On an NCCL mesh of CUDA devices the engine's steps and the votes run as
CUDA graphs with their collectives inside, as they do for the CLIs.

``python -m tumseg_torch.parallel.dryrun N [DEVICE] [BACKEND]`` runs it.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np
import torch

from tumseg_torch import models
from tumseg_torch.nn.layers import BatchNorm
from tumseg_torch.parallel import mesh as pmesh
from tumseg_torch.train.loop import TrainEngine

C, N = 8, 128


def exact_step(model: torch.nn.Module, points, target, weight,
               mesh: Optional[pmesh.Mesh] = None, steps: int = 1,
               optimizer: str = "Adam", device="cpu", lr: float = 1e-3,
               momentum: float = 0.1) -> Dict:
    """``steps`` train steps of ``TrainEngine`` on one global batch with
    deterministic draws (FPS from index 0, no dropout, no rotation) and
    exact gathers, ``tumseg``'s ``rngs={}`` step; on a ``mesh`` each rank
    takes its rows. -> {losses, grads (the step-1 gradient by parameter
    name, averaged over the ranks), params and stats (the state after the
    last step: parameters, BN running means and variances by name)}."""
    eng = TrainEngine(model, C, weight, optimizer=optimizer,
                      augment_rotate=False, exact_gathers=True, seed=0,
                      device=device, mesh=mesh)
    eng.generator = None
    losses, grads = [], None
    for _ in range(steps):
        losses.append(float(eng.train_batch(points, target, lr, momentum)[0]))
        if grads is None:
            grads = {n: p.grad.detach().clone()
                     for n, p in eng.model.named_parameters()}
    stats = {f"{n}.{b}": getattr(m, b).detach().clone()
             for n, m in eng.model.named_modules() if isinstance(m, BatchNorm)
             for b in ("running_mean", "running_var")}
    params = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
    return dict(losses=losses, grads=grads, params=params, stats=stats)


def max_distance(a: Dict, b: Dict) -> float:
    """The largest |a - b| over the tensors of two dicts of one layout."""
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def _checks(mesh: pmesh.Mesh) -> Dict:
    from tumseg_torch.data.dataset import TestGridDataset
    from tumseg_torch.data.device_sampler import DeviceBlockSampler
    from tumseg_torch.infer.voting import InferenceRunner

    dev = mesh.device
    ssg = models.get_module("pointnet2_sem_seg")
    rng = np.random.default_rng(0)
    B = mesh.size
    torch.manual_seed(0)
    engine = TrainEngine(ssg.get_model(C), C, np.ones(C), seed=0, device=dev,
                         mesh=mesh)
    points = rng.random((B, N, 6)).astype(np.float32)
    target = rng.integers(0, C, (B, N)).astype(np.int64)
    loss, correct = engine.train_batch(points, target, 1e-3, 0.1)
    loss, correct = float(loss), int(correct)
    if not np.isfinite(loss):
        raise AssertionError("multichip train step produced non-finite loss")

    # the device pipeline: on the mesh, a k-step call against k single steps
    rooms_xyz = [np.stack([rng.uniform(0, 2, 2000), rng.uniform(0, 2, 2000),
                           rng.uniform(0, 1, 2000)], 1) for _ in range(2)]
    rooms_lab = [rng.integers(0, C, 2000) for _ in range(2)]
    sampler = DeviceBlockSampler(rooms_xyz, rooms_lab, [[], []], [],
                                 num_point=N, block_size=1.0,
                                 min_block_points=16, device=dev)

    def dev_engine():
        torch.manual_seed(1)
        return TrainEngine(ssg.get_model(C), C, np.ones(C), seed=0,
                           device=dev, sampler=sampler, mesh=mesh)

    room_ids = (np.arange(B) % 2).astype(np.int32)
    eng_a = dev_engine()
    per_step = [float(eng_a.train_batch_rooms(room_ids, 1e-3, 0.1)[0])
                for _ in range(2)]
    losses_k = dev_engine().train_batch_rooms_multi(
        np.stack([room_ids, room_ids]), 1e-3, 0.1)[0]
    losses_k = losses_k.cpu().numpy().astype(np.float64)
    if not (np.all(np.isfinite(per_step)) and np.all(np.isfinite(losses_k))):
        raise AssertionError("device-pipeline multichip step produced "
                             "non-finite losses")
    d_superstep = float(np.max(np.abs(losses_k - np.asarray(per_step))))
    if d_superstep > 2e-5 * max(1.0, float(np.max(np.abs(losses_k)))):
        raise AssertionError(f"superstep diverged from per-step steps on "
                             f"the mesh: {losses_k} vs {per_step}")

    # votes on the mesh against one process
    n_scene = 4000
    ds = TestGridDataset(num_classes=C, block_points=N, seed=0)
    ds.scene_points_list = [np.stack(
        [rng.uniform(0, 2, n_scene), rng.uniform(0, 1, n_scene),
         rng.uniform(0, 2, n_scene)], 1)]
    ds.semantic_labels_list = [rng.integers(0, C, n_scene)]
    ds.file_list = ["dryrun.las"]
    ds.labelweights = np.ones(C, dtype=np.float32)
    preds = [InferenceRunner(engine.model, C, batch_size=B, device=dev,
                             mesh=m, device_features=True,
                             device_reblock=True).infer_scene(ds, 0, 1)
             for m in (mesh, None)]
    pred = preds[0]
    if not (pred.shape == (n_scene,) and pred.min() >= 0 and pred.max() < C):
        raise AssertionError("mesh votes out of range")
    vote_mismatch = int(np.sum(pred != preds[1]))
    if vote_mismatch > max(1, n_scene // 1000):
        raise AssertionError(
            f"mesh votes disagree with one process's on {vote_mismatch}/"
            f"{n_scene} points: beyond reduction-order ties")

    # a PointNet + SGD step with no augmentation, mesh against one process,
    # on 8 blocks a rank of distinct scales: the STNs' fc batch norms over
    # [B, C] divide by the spread of the blocks' global features, which for
    # a rank's one random block in [0, 1)^3 (tumseg's B = n_devices) is
    # below the rounding of the conv batch norms' sums, so any change of
    # summation order moves the log-probs by ~0.5 in f32
    pn = models.get_module("pointnet_sem_seg")
    pts_v = (rng.random((8 * B, N, 6))
             * (1.0 + np.arange(8 * B))[:, None, None]).astype(np.float32)
    tgt_v = rng.integers(0, C, (8 * B, N)).astype(np.int64)
    runs = []
    for m in (mesh, None):
        torch.manual_seed(2)
        runs.append(exact_step(pn.get_model(C), pts_v, tgt_v, np.ones(C),
                               mesh=m, optimizer="SGD", device=dev))
    l_mesh, l_one = runs[0]["losses"][0], runs[1]["losses"][0]
    d_loss = abs(l_mesh - l_one)
    if d_loss > 1e-5 * max(1.0, abs(l_one)):
        raise AssertionError(f"mesh train step loss {l_mesh} != one "
                             f"process's {l_one}")
    d_params = max_distance(runs[0]["params"], runs[1]["params"])
    if not d_params < 5e-4:
        raise AssertionError(f"mesh vs one-process params after a step: "
                             f"max|d| = {d_params}")

    summary = dict(loss=loss, correct=correct, dev_pipeline_loss=per_step[0],
                   vote_classes=int(np.unique(pred).size),
                   vote_mismatch=vote_mismatch, n_scene=n_scene,
                   d_loss=d_loss, d_params=d_params, d_superstep=d_superstep)
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): loss={loss:.4f} "
              f"correct={correct} dev_pipeline_loss={per_step[0]:.4f} "
              f"vote_scan_pred_classes={summary['vote_classes']}")
        print(f"mesh_vs_single: ok (train dloss={d_loss:.2e} "
              f"max_dparam={d_params:.2e}; vote labels agree on "
              f"{n_scene - vote_mismatch}/{n_scene} pts ({vote_mismatch} "
              f"reduction-order ties allowed <=0.1%); superstep_vs_per_step "
              f"dloss={d_superstep:.2e})")
    return summary


def _rank(rank, device, backend):
    return _checks(pmesh.make_mesh(devices=device, backend=backend))


def dryrun_multichip(n_devices: int, device=None,
                     backend: Optional[str] = None) -> Dict:
    """The dry run on a mesh of ``n_devices`` ranks; returns rank 0's
    numbers. ``device`` puts every rank on that device (ranks that share
    one card); by default rank r takes ``cuda:r``, or the CPU without CUDA.
    ``backend`` defaults to NCCL on CUDA and gloo on the CPU; gloo on a card
    is asked for by name. Inside a process group of ``n_devices`` ranks
    this process runs as its rank; a mesh of one runs here on a one-rank
    group; a larger one spawns its ranks."""
    cpu = (torch.device(device).type == "cpu" if device is not None
           else not torch.cuda.is_available())
    backend = backend or ("gloo" if cpu else "nccl")
    if torch.distributed.is_initialized():
        return _checks(pmesh.make_mesh(n_devices, devices=device,
                                       backend=backend))
    if n_devices == 1:
        try:
            return _checks(pmesh.make_mesh(1, devices=device,
                                           backend=backend))
        finally:
            pmesh.close_mesh()
    return pmesh.spawn(_rank, n_devices, (device, backend), backend=backend,
                       threads=1 if cpu else None)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]), *sys.argv[2:4])
