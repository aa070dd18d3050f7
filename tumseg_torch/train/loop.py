"""The port's training engine and epoch loop (``tumseg/train/loop.py``).

Same behaviour as ``tumseg``'s host-pipeline path:
- LR schedule ``lr = max(base * decay^(epoch // step), 1e-5)`` and BN
  momentum ``m = max(0.1 * 0.5^(epoch // step), 0.01)``;
- Adam with betas (0.9, 0.999), eps 1e-8 and weight decay added to the
  gradient before the moments (torch's ``Adam(weight_decay=...)`` is optax's
  ``add_decayed_weights -> scale_by_adam``), or SGD with momentum 0.9 and no
  decay (``optax.trace(0.9)``);
- a z-rotation of every batch, a random FPS start per stage and dropout,
  all drawn from the engine's ``torch.Generator`` on the device;
- f32 weights and, unless ``exact_gathers``, single-pass bf16 gathers in
  the train step (``fast_gather``: the neighbourhood groups store bf16, the
  interpolations round their operands to bf16), as ``tumseg``'s engine
  trains on its accelerator (``tumseg/train/loop.py:85, 126``);
- ``compute_dtype`` (``--bf16``: ``torch.bfloat16``), ``tumseg``'s compute
  dtype, in the train step and in eval; eval passes no ``fast_gather``, so
  it gathers exactly in f32 compute and takes the single-pass bf16 gathers
  under a compute dtype (``tumseg/train/loop.py:147-150``). The weights,
  their gradients, Adam and the checkpoints stay f32;
- per-epoch eval with per-class IoU and mIoU, a checkpoint every 5 epochs
  and on the best mIoU, and the accuracy / loss / IoU charts.

On a CUDA device every step runs as a captured CUDA graph
(``tumseg_torch.utils.graphs``), the counterpart of ``tumseg``'s ``jax.jit``
steps: a room-id call of k steps is one replay, its batches' selection
included, as ``tumseg``'s ``lax.scan`` superstep is one dispatch. The
learning rate and the BN momentum are device scalars written in place
(``tumseg``'s ``jnp.float32(lr)``, ``jnp.float32(momentum)``), so one graph
serves every epoch. A replayed step equals the eager one bit for bit;
``TrainEngine(cuda_graphs=False)``, the counterpart of ``jax.disable_jit``,
runs the same steps eagerly. On the CPU the steps are eager. Per-step
losses and correct counts stay on the device and are read back once an
epoch, as ``tumseg`` does.

With a ``DeviceBlockSampler`` (``sampler=``) the engine also takes batches
that are only room ids (``train_batch_rooms``, ``eval_batch_rooms`` and
their ``_multi`` forms over ``[k, B]`` ids): the blocks are sampled and
featurized on the device. The random streams keep ``tumseg``'s structure
(``tumseg/train/loop.py:159-169, 407-415``): train step ``s`` draws its
blocks, then its rotation, FPS starts and dropout, from one generator
seeded from ``(seed, s)``, and eval call ``e`` from one seeded from
``(seed, 2^31 + e)``. So ``k`` single steps equal one ``k``-step call, eval
never moves the training stream, and the host path's ``generator`` is left
alone. The engine keeps one generator a step of its largest call and
re-seeds them for each call, so a graph registers them once.

With a ``mesh`` (``tumseg_torch.parallel``, one process a device) the engine
trains as ``tumseg``'s sharded engine does (``tumseg/train/loop.py:83-270,
289-430``): every rank takes its contiguous ``B / size`` rows of the global
batch, parameters, BN statistics and optimizer state are replicated (rank
0's broadcast at construction and after :meth:`TrainEngine.load_state`),
BatchNorm ``pmean``'s its batch moments, the loss ``psum``'s its numerator
and denominator, the gradients are averaged over the ranks, and the correct
counts and eval tallies are ``psum``'d, so every rank reads the global
numbers. Each rank draws from its own streams, the counterpart of
``fold_axis``: room-id step ``s`` from ``(seed, s, rank)``, so a ``k``-step
call still equals ``k`` single steps on the mesh. On an NCCL mesh of CUDA
devices (``Mesh.capturable``, what ``--num_devices`` spawns on GPUs) every
step is a CUDA graph as on one device, with its collectives inside: the
BatchNorms' ``pmean``s, the loss's ``psum``s and their backward
all-reduces, the flat gradient all-reduce and the ``psum``'d corrects and
tallies, as ``tumseg``'s ``jax.jit(shard_map(step))`` holds them
(``tumseg/train/loop.py:221-265``); a room-id call of k steps is one replay
after its rejection rounds, whose row split stays on the host. On a gloo
mesh (the CPU, or ranks that share one card) the steps run eagerly: gloo's
collectives cannot be captured.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from tumseg_torch import ops
from tumseg_torch.utils.progress import progress
from tumseg_torch.data.augment import rotate_z
from tumseg_torch.data.device_sampler import RoomBatch
from tumseg_torch.models.convert import (state_dict_from_variables,
                                         variables_from_state_dict)
from tumseg_torch.nn.layers import BatchNorm
from tumseg_torch.parallel import mesh as pmesh
from tumseg_torch.train import checkpoint as ckpt
from tumseg_torch.train import metrics as M
from tumseg_torch.utils.graphs import StepGraphs
from tumseg_torch.utils.profiling import span

LEARNING_RATE_CLIP = 1e-5
MOMENTUM_ORIGINAL = 0.1
MOMENTUM_DECCAY = 0.5
MOMENTUM_FLOOR = 0.01


def lr_schedule(epoch: int, base_lr: float, lr_decay: float,
                step_size: int) -> float:
    return max(base_lr * (lr_decay ** (epoch // step_size)), LEARNING_RATE_CLIP)


def bn_momentum_schedule(epoch: int, step_size: int) -> float:
    m = MOMENTUM_ORIGINAL * (MOMENTUM_DECCAY ** (epoch // step_size))
    return max(m, MOMENTUM_FLOOR)


def make_optimizer(params, name: str = "Adam",
                   weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """``tumseg``'s optimizers; the engine sets the learning rate on every
    step (:func:`set_learning_rate`). On a CUDA device the learning rate is
    a device scalar, ``tumseg``'s ``jnp.float32(lr)``, and the update is one
    that a CUDA graph can hold: Adam ``capturable`` (its step count and
    bias correction f32 device tensors), SGD the fused kernel (the foreach
    one reads a tensor learning rate back to the host). The CPU build
    refuses ``capturable``: there the learning rate is a float and Adam's
    bias correction is computed in double."""
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    card = device.type == "cuda"
    lr = torch.tensor(1e-3, device=device) if card else 1e-3
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay, capturable=card)
    return torch.optim.SGD(params, lr=lr, momentum=0.9, fused=card or None)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate: a device scalar is filled in place."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


TALLIES = ("seen", "predicted", "correct")


def _add_tallies(total, t):
    return dict(t) if total is None else M.accumulate(total, t)


# the count of a rank's host-path stream on a mesh: above every train step
# (< 2^31) and eval call (2^31 + e) count
HOST_STREAM = 1 << 32


def stream_seed(seed: int, count: int, rank=None) -> int:
    """The seed of the room-id step or eval call ``count``'s generator,
    the counterpart of ``fold_in(PRNGKey(seed), count)``; on a mesh also
    of the rank, as ``fold_axis`` folds the device's index."""
    entropy = [int(seed) % 2 ** 64, int(count)]
    if rank is not None:
        entropy.append(int(rank))
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


class TrainEngine:
    """Holds the model, its optimizer and the random stream of training.
    ``exact_gathers`` (default False, as in ``tumseg``) makes the train step
    gather exactly too; ``compute_dtype`` (None: f32) is the model's compute
    dtype in the train step and in eval; ``sampler`` (a
    ``DeviceBlockSampler`` on the engine's device) enables the room-id
    steps. With a ``mesh`` the engine runs on ``mesh.device`` and
    ``device`` is not read. Setting ``generator`` to None makes the host
    path's steps draw nothing (FPS from index 0, no dropout; with
    ``augment_rotate=False``), ``tumseg``'s ``rngs={}``.

    On a CUDA device each step runs as a CUDA graph (``self.graphs``, a
    :class:`StepGraphs`): the first call of a step's shape warms it up
    eagerly, the second captures it, and every call from then on is one
    replay. On a ``mesh`` that holds for an NCCL mesh (``mesh.capturable``),
    whose graphs hold the step's collectives; a gloo mesh runs its steps
    eagerly. ``cuda_graphs=False`` is ``tumseg``'s ``jax.disable_jit``: the
    same steps, eager, bit for bit what the graphs compute. A step that
    finds a parameter, buffer or optimizer state tensor replaced since the
    last call (:meth:`load_state` replaces the optimizer state; the weights
    it copies in place) drops the graphs, which are captured again; on a
    mesh every rank does so on the same call."""

    def __init__(self, model: torch.nn.Module, num_classes: int,
                 train_weights: np.ndarray, optimizer: str = "Adam",
                 weight_decay: float = 1e-4, augment_rotate: bool = True,
                 seed: int = 0, device="cuda", exact_gathers: bool = False,
                 compute_dtype=None, sampler=None, mesh=None,
                 cuda_graphs: bool = True):
        self.mesh = mesh
        self.rank = None if mesh is None else mesh.rank
        if mesh is not None:
            device = mesh.device
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.num_classes = num_classes
        self.augment_rotate = augment_rotate
        self.exact_gathers = exact_gathers
        self.compute_dtype = compute_dtype
        self.weights = torch.as_tensor(
            np.asarray(train_weights, dtype=np.float32), device=self.device)
        self.optimizer = make_optimizer(self.model.parameters(), optimizer,
                                        weight_decay)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(
            seed if mesh is None else stream_seed(seed, HOST_STREAM,
                                                  self.rank))
        self.seed = seed
        self.sampler = sampler
        self._step_count = 0
        self._eval_count = 0
        self._gens = []         # the room-id calls' generators, re-seeded
        self._momentum = None   # the momentum in the BNs' scalars
        # on a mesh, broadcast_state also makes the communicator that the
        # graphs' collectives use, before any capture
        self.graphs = (StepGraphs(self.device, mesh=mesh)
                       if cuda_graphs and self.device.type == "cuda"
                       and (mesh is None or mesh.capturable) else None)
        if mesh is not None:
            pmesh.broadcast_state(self.model, mesh)

    def load_state(self, state: Dict) -> int:
        """Model weights and (if saved) optimizer state from a loaded
        ``tumseg-ckpt-v2`` checkpoint; returns its epoch."""
        self.model.load_state_dict(
            state_dict_from_variables(state["model_state_dict"]))
        if state.get("optimizer_state_dict") is not None:
            ckpt.load_optimizer_leaves(self.optimizer, self.model,
                                       state["optimizer_state_dict"])
        if self.mesh is not None:
            pmesh.broadcast_state(self.model, self.mesh, self.optimizer)
        return state.get("epoch", 0)

    def variables(self) -> Dict:
        return variables_from_state_dict(self.model.state_dict())

    def save(self, path: str, epoch: int, class_avg_iou=None) -> None:
        """On a mesh rank 0 writes, and every rank returns once it has."""
        ckpt.save_checkpoint(
            path, epoch=epoch, variables=self.variables(),
            opt_leaves=ckpt.optimizer_leaves(self.optimizer, self.model),
            class_avg_iou=class_avg_iou, mesh=self.mesh)

    def _put(self, points, target):
        """This rank's rows of a global batch, on the device."""
        if self.mesh is not None:
            points, target = pmesh.shard_batch(self.mesh, (points, target))
        return (torch.as_tensor(points, dtype=torch.float32).to(self.device),
                torch.as_tensor(target).to(self.device, torch.long))

    def _check_mesh_divisible(self, b: int) -> None:
        """A batch must tile the mesh axis (``tumseg/train/loop.py:
        351-364``): a ragged ``drop_last=False`` tail raises here, with what
        to do about it."""
        if self.mesh is not None and b % self.mesh.size:
            raise ValueError(
                "room-id batch of %d rows cannot shard over the %d-device "
                "'%s' mesh axis; use a drop_last=True loader (the CLI "
                "default) or pad the tail to a multiple of %d"
                % (b, self.mesh.size, pmesh.DATA_AXIS, self.mesh.size))

    def _set_schedule(self, lr: float, momentum: float) -> None:
        """Writes the step's learning rate, and its BN momentum when that
        changed (the BNs' scalars are the engine's alone; the optimizer's
        groups may be reloaded), into the scalars that the steps read."""
        set_learning_rate(self.optimizer, lr)
        if self._momentum != momentum:
            for m in self.model.modules():
                if isinstance(m, BatchNorm):
                    m.set_momentum(momentum)
            self._momentum = momentum

    def _bindings(self) -> tuple:
        """The addresses of the tensors that a captured step reads or
        writes in place. A mesh step keeps nothing else: its collectives'
        buffers, the flat gradient one included, are the graph's own."""
        tensors = [*self.model.parameters(), *self.model.buffers(),
                   self.weights]
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                tensors.append(group["lr"])
        for state in self.optimizer.state.values():
            tensors += [v for v in state.values()
                        if isinstance(v, torch.Tensor)]
        return tuple(t.data_ptr() for t in tensors)

    def _run(self, key: tuple, fn, inputs, generators):
        """``fn(*inputs)``: eager, or the CUDA graph of ``key`` and of every
        Python value that the step reads."""
        if self.graphs is None:
            return fn(*inputs)
        key += (self.compute_dtype, self.exact_gathers, self.augment_rotate,
                ops.switches())
        return self.graphs.run(key, fn, inputs, generators, self._bindings)

    def train_batch(self, points, target, lr: float, momentum: float):
        """One step: rotate, forward, the model's loss, backward, optimizer.
        Returns (loss, correct) as device tensors."""
        points, target = self._put(points, target)
        self._set_schedule(lr, momentum)
        self.model.train()
        gen = self.generator
        return self._run(
            ("train", tuple(points.shape), tuple(target.shape), gen),
            lambda p, t: self._train_step(p, t, gen), (points, target),
            [] if gen is None else [gen])

    def _train_step(self, points, target, generator):
        if self.augment_rotate:
            angles = torch.rand(points.shape[0], generator=generator,
                                device=self.device) * (2 * math.pi)
            points = torch.cat([rotate_z(points[..., :3], angles),
                                points[..., 3:]], dim=-1)
        mesh = self.mesh
        logp, aux = self.model(points, generator=generator,
                               fast_gather=not self.exact_gathers,
                               compute_dtype=self.compute_dtype, mesh=mesh)
        loss = self.model.loss(logp, target, aux, self.weights, mesh=mesh)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            pmesh.all_reduce_gradients(self.model.parameters(), mesh)
        self.optimizer.step()
        correct = (logp.detach().argmax(-1) == target).sum()
        if mesh is not None:
            correct = pmesh.psum(correct, mesh)
        return loss.detach(), correct

    @torch.no_grad()
    def eval_batch(self, points, target):
        """-> (loss, {seen, predicted, correct}) as device tensors. The
        gathers resolve as in ``tumseg``'s eval step: exact in f32 compute,
        single-pass bf16 under a compute dtype."""
        points, target = self._put(points, target)
        self.model.eval()

        def step(points, target):
            loss, tallies = self._eval_step(points, target)
            return (loss, *(tallies[k] for k in TALLIES))
        loss, *tallies = self._run(
            ("eval", tuple(points.shape), tuple(target.shape)), step,
            (points, target), [])
        return loss, dict(zip(TALLIES, tallies))

    def _eval_step(self, points, target):
        logp, aux = self.model(points, compute_dtype=self.compute_dtype)
        loss = self.model.loss(logp, target, aux, self.weights,
                               mesh=self.mesh)
        tallies = M.confusion_tallies(logp.argmax(-1), target,
                                      self.num_classes)
        if self.mesh is not None:
            tallies = {k: pmesh.psum(t, self.mesh) for k, t in tallies.items()}
        return loss, tallies

    # -- room-id steps: blocks sampled on the device ---------------------------

    def _streams(self, first: int, k: int):
        """The k generators of a call, re-seeded for counts ``first`` ...
        ``first + k - 1``: the draws of k fresh generators so seeded."""
        while len(self._gens) < k:
            self._gens.append(torch.Generator(device=self.device))
        for count, g in enumerate(self._gens[:k], start=first):
            g.manual_seed(stream_seed(self.seed, count, self.rank))
        return self._gens[:k]

    def _local_rooms(self, room_ids_k) -> np.ndarray:
        """This rank's columns of ``[k, B]`` room ids."""
        room_ids_k = np.asarray(room_ids_k)
        if self.mesh is None:
            return room_ids_k
        self._check_mesh_divisible(room_ids_k.shape[1])
        return room_ids_k[:, self.mesh.rows(room_ids_k.shape[1])]

    def train_batch_rooms(self, room_ids, lr: float, momentum: float):
        """One train step from ``[B]`` room ids: the blocks are sampled on
        the device. Returns (loss, correct) as device tensors."""
        losses, corrects = self.train_batch_rooms_multi(
            np.asarray(room_ids)[None], lr, momentum)
        return losses[0], corrects[0]

    def train_batch_rooms_multi(self, room_ids_k, lr: float, momentum: float):
        """k train steps from ``[k, B]`` room ids, the same run as k calls
        of :meth:`train_batch_rooms`: the k batches' rejection rounds first
        (one readback a round for all of them), then their selection and
        the k steps, one CUDA graph on the card. Returns ([k] losses, [k]
        corrects) on the device. Under a profiler it is the span
        ``tumseg.train.call``, request id the call's first step count."""
        with span("tumseg.train.call", self._step_count):
            room_ids_k = self._local_rooms(room_ids_k)
            k, B = room_ids_k.shape
            gens = self._streams(self._step_count, k)
            self._step_count += k
            self._set_schedule(lr, momentum)
            self.model.train()
            accepted = self.sampler.accept(room_ids_k, gens)

            def steps(rid, center, cnt):
                points, target, _ = self.sampler.draw_select(rid, center, cnt,
                                                              gens)
                out = [self._train_step(points[i], target[i], g)
                       for i, g in enumerate(gens)]
                return (torch.stack([l for l, _ in out]),
                        torch.stack([c for _, c in out]))
            return self._run(("train_rooms", k, B, self.sampler), steps,
                             accepted, gens)

    def eval_batch_rooms(self, room_ids):
        """One eval call from ``[B]`` room ids -> (loss, tallies)."""
        losses, tallies = self.eval_batch_rooms_multi(
            np.asarray(room_ids)[None])
        return losses[0], tallies

    def eval_batch_rooms_multi(self, room_ids_k):
        """k eval calls from ``[k, B]`` room ids -> ([k] losses, summed
        tallies); eval call e draws from the stream ``2^31 + e``, disjoint
        from the training steps'."""
        room_ids_k = self._local_rooms(room_ids_k)
        k, B = room_ids_k.shape
        gens = self._streams((1 << 31) + self._eval_count + 1, k)
        self._eval_count += k
        self.model.eval()
        accepted = self.sampler.accept(room_ids_k, gens)

        def steps(rid, center, cnt):
            with torch.no_grad():
                points, target, _ = self.sampler.draw_select(rid, center,
                                                              cnt, gens)
                losses, tallies = [], None
                for i in range(k):
                    loss, t = self._eval_step(points[i], target[i])
                    losses.append(loss)
                    tallies = _add_tallies(tallies, t)
            return (torch.stack(losses), *(tallies[n] for n in TALLIES))
        losses, *tallies = self._run(("eval_rooms", k, B, self.sampler),
                                     steps, accepted, gens)
        return losses, dict(zip(TALLIES, tallies))


class _SuperstepBuffer:
    """Groups same-shape room-id batches into k-step calls. A batch of
    another shape (a ``drop_last=False`` tail) first drains the pending
    group through the per-step call, so ``fit(superstep>1)`` accepts any
    loader. ``add`` and ``drain`` return the calls' raw (loss, aux)
    results."""

    def __init__(self, k, multi_fn, step_fn):
        self.k, self.multi_fn, self.step_fn = k, multi_fn, step_fn
        self.buf = []

    def add(self, room_ids, *args):
        ids = np.asarray(room_ids)
        out = self.drain(*args) if (self.buf and
                                    ids.shape != self.buf[0].shape) else []
        self.buf.append(ids)
        if len(self.buf) == self.k:
            out.append(self.multi_fn(np.stack(self.buf), *args))
            self.buf = []
        return out

    def drain(self, *args):
        out = [self.step_fn(ids, *args) for ids in self.buf]
        self.buf = []
        return out


def fit(engine: TrainEngine, train_loader, eval_loader, *, start_epoch: int,
        end_epoch: int, learning_rate: float, lr_decay: float, step_size: int,
        batch_size: int, num_point: int, checkpoints_dir, model_name: str,
        seg_label_to_cat: Dict, log_string=print, superstep: int = 1):
    """The epoch loop of ``tumseg/train/loop.py:fit``. Returns
    (accuracyChart, MLChart, IoUChart).

    A loader may yield ``(points, target)`` batches (the host pipeline) or
    :class:`RoomBatch` (the device pipeline, the engine's room-id steps).
    ``superstep`` > 1 groups that many room-id batches into one
    ``*_multi`` call: the same run, one readback a rejection round for all
    of them; the epoch's tail goes through the per-step calls."""
    num_classes = engine.num_classes
    accuracy_chart, ml_chart, iou_chart = [], [], []
    best_iou = 0.0
    global_epoch = 0

    for epoch in range(start_epoch, end_epoch):
        log_string("**** Epoch %d (%d/%s) ****"
                   % (global_epoch + 1, epoch + 1, end_epoch))
        lr = lr_schedule(epoch, learning_rate, lr_decay, step_size)
        log_string("Learning rate:%f" % lr)
        momentum = bn_momentum_schedule(epoch, step_size)
        print("BN momentum updated to: %f" % momentum)

        num_batches = len(train_loader)
        total_seen = 0
        losses, corrects = [], []
        room_buf = _SuperstepBuffer(superstep, engine.train_batch_rooms_multi,
                                    engine.train_batch_rooms)
        t0 = time.time()
        for batch in progress(train_loader, total=num_batches, desc="train"):
            if not isinstance(batch, RoomBatch):
                results = [engine.train_batch(*batch, lr, momentum)]
            elif superstep > 1:
                results = room_buf.add(batch.room_ids, lr, momentum)
            else:
                results = [engine.train_batch_rooms(batch.room_ids, lr,
                                                    momentum)]
            for loss, correct in results:
                losses.append(loss.reshape(-1))
                corrects.append(correct.reshape(-1))
            total_seen += batch_size * num_point
        for loss, correct in room_buf.drain(lr, momentum):
            losses.append(loss.reshape(-1))
            corrects.append(correct.reshape(-1))
        # one readback an epoch, which also waits for the last step
        loss_sum = float(torch.cat(losses).sum()) if losses else 0.0
        total_correct = int(torch.cat(corrects).sum()) if corrects else 0
        train_time = time.time() - t0
        if num_batches:
            log_string("Training mean loss: %f" % (loss_sum / num_batches))
            log_string("Training accuracy: %f"
                       % (total_correct / float(total_seen)))
            log_string("Training points/sec: %.0f"
                       % (total_seen / max(train_time, 1e-9)))

        if epoch % 5 == 0:
            savepath = str(checkpoints_dir) + "/model.pth"
            log_string("Saving at %s" % savepath)
            engine.save(savepath, epoch)

        log_string("---- EPOCH %03d EVALUATION ----" % (global_epoch + 1))
        eval_batches = len(eval_loader)
        device_tallies = None
        eval_losses = []
        eval_seen = 0
        eval_buf = _SuperstepBuffer(superstep, engine.eval_batch_rooms_multi,
                                    engine.eval_batch_rooms)
        for batch in progress(eval_loader, total=eval_batches, desc="eval"):
            if not isinstance(batch, RoomBatch):
                results = [engine.eval_batch(*batch)]
            elif superstep > 1:
                results = eval_buf.add(batch.room_ids)
            else:
                results = [engine.eval_batch_rooms(batch.room_ids)]
            for loss, t in results:
                eval_losses.append(loss.reshape(-1))
                device_tallies = _add_tallies(device_tallies, t)
            eval_seen += batch_size * num_point
        for loss, t in eval_buf.drain():
            eval_losses.append(loss.reshape(-1))
            device_tallies = _add_tallies(device_tallies, t)

        if eval_batches:
            tallies = M.accumulate_host(M.zero_tallies(num_classes),
                                        device_tallies)
            eval_loss_sum = float(torch.cat(eval_losses).sum())
            iou = M.iou_from_tallies(tallies)
            miou = float(np.mean(iou))
            eval_acc = float(tallies["correct"].sum() / float(eval_seen))
            log_string("eval mean loss: %f" % (eval_loss_sum / eval_batches))
            log_string("eval point avg class IoU: %f" % miou)
            log_string("eval point accuracy: %f" % eval_acc)
            log_string("eval point avg class acc: %f"
                       % M.class_avg_accuracy(tallies))

            labelweights = tallies["seen"] / max(tallies["seen"].sum(), 1)
            iou_str = "------- IoU --------\n"
            for l in range(num_classes):
                iou_str += "class %s weight: %.3f, IoU: %.3f \n" % (
                    seg_label_to_cat[l] + " " * (14 - len(seg_label_to_cat[l])),
                    labelweights[l], iou[l])
            log_string(iou_str)

            if miou >= best_iou:
                best_iou = miou
                savepath = str(checkpoints_dir) + model_name
                log_string("Saving at %s" % savepath)
                engine.save(savepath, epoch, class_avg_iou=miou)
            log_string("Best mIoU: %f" % best_iou)

            accuracy_chart.append(eval_acc)
            ml_chart.append(eval_loss_sum / eval_batches)
            iou_chart.append(best_iou)
        global_epoch += 1

    return accuracy_chart, ml_chart, iou_chart
