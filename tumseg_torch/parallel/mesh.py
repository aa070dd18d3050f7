"""The 1-D ``data`` mesh on ``torch.distributed``
(``tumseg/parallel/mesh.py``).

``tumseg`` shards the batch (or a vote's blocks) over the devices of a 1-D
mesh axis and replicates parameters, BN statistics and optimizer state; XLA
inserts the ``psum``/``pmean`` collectives. The port runs one process a
device, PyTorch's own idiom for that mesh: a :class:`Mesh` is this process's
rank of a process group, with its device, and the batch's leading axis is
split into contiguous per-rank slices, as ``P(DATA_AXIS)`` splits it.

The collectives are ``all_reduce(SUM)`` and ``broadcast`` only, so gloo
carries them on CUDA tensors as well as NCCL does: two gloo ranks can share
one card. :func:`psum` and :func:`pmean` are autograd functions whose
backward is the all-reduce SUM of the cotangent. Each rank's gradient is
then ``size`` times its share of the true one, and
:func:`all_reduce_gradients` averages them.

NCCL's collectives on a CUDA device can be captured into a CUDA graph
(:attr:`Mesh.capturable`), gloo's cannot. On such a mesh the training
engine and the serving runner capture their programs with the collectives
inside (``tumseg_torch.utils.graphs``), as ``tumseg``'s ``shard_map``
programs hold their ``psum``s: :func:`psum`'s buffers and
:func:`all_reduce_gradients`' flat buffer are then allocated in the graph's
memory pool and the all-reduces run on the graph's stream. The group is
made as for eager use: ``ProcessGroupNCCL``'s watchdog and async error
handling stay at PyTorch's defaults, under which the card's captures hold
(``chip_smoke.py`` [y]).

:func:`initialize_distributed` keeps ``tumseg``'s explicit opt-in: a process
joins a group only when given a coordinator (flag or
``TUMSEG_COORDINATOR_ADDRESS``) together with its process count and id.
``torchrun``'s environment is not read. :func:`spawn` starts the ranks of
one host.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"

_distributed_initialized = False


@dataclass(frozen=True)
class Mesh:
    """This process's place on the ``data`` axis: ``size`` ranks, this one
    ``rank``, on ``device``, in the process ``group``."""

    size: int
    rank: int
    device: torch.device
    group: object = None

    @property
    def capturable(self) -> bool:
        """Whether this mesh's collectives can run inside a CUDA graph:
        NCCL on a CUDA device (:func:`collectives_capturable`)."""
        return collectives_capturable(dist.get_backend(self.group),
                                      self.device)

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` rows (``n % size == 0``)."""
        if n % self.size:
            raise ValueError(
                "a batch of %d rows cannot shard over the %d-device '%s' "
                "mesh axis" % (n, self.size, DATA_AXIS))
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def _on_device(self, t: torch.Tensor):
        """(tensor the backend can take, whether it is a copy): NCCL takes
        CUDA tensors only."""
        if (dist.get_backend(self.group) == "nccl"
                and t.device != self.device):
            return t.to(self.device), True
        return t, False

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        buf, copied = self._on_device(t)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        if copied:
            t.copy_(buf)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        buf, copied = self._on_device(t)
        dist.broadcast(buf, src=src, group=self.group)
        if copied:
            t.copy_(buf)
        return t

    def barrier(self) -> None:
        """Waits for every rank (an all-reduce of one element)."""
        self.all_reduce_(torch.zeros(1, device=self.device))

    def broadcast_array(self, arr: Optional[np.ndarray], dtype) -> np.ndarray:
        """Rank 0's numpy array (``arr``, ignored elsewhere) on every rank,
        as ``dtype``."""
        shape = torch.zeros(8, dtype=torch.int64, device=self.device)
        if self.rank == 0:
            arr = np.ascontiguousarray(arr, dtype=dtype)
            shape[0] = arr.ndim
            shape[1:1 + arr.ndim] = torch.as_tensor(arr.shape)
        self.broadcast_(shape)
        dims = [int(v) for v in shape[1:1 + int(shape[0])].tolist()]
        if self.rank == 0:
            data = torch.as_tensor(arr, device=self.device)
        else:
            data = torch.empty(dims, dtype=torch.from_numpy(
                np.zeros(0, dtype)).dtype, device=self.device)
        return self.broadcast_(data).cpu().numpy()

    def broadcast_int(self, value: Optional[int]) -> int:
        """Rank 0's integer on every rank; rank 0 draws one from the
        system's entropy when ``value`` is None."""
        if self.rank == 0 and value is None:
            value = int(np.random.SeedSequence().generate_state(
                1, np.uint32)[0]) >> 1
        t = torch.tensor([0 if value is None else int(value)],
                         dtype=torch.int64, device=self.device)
        return int(self.broadcast_(t).item())


def collectives_capturable(backend: str, device) -> bool:
    """Whether collectives of ``backend`` on ``device`` can be captured into
    a CUDA graph: NCCL's on a CUDA device (NCCL >= 2.9.6, which every CUDA
    build of PyTorch 2 ships). gloo's run on the host and cannot."""
    return backend == "nccl" and torch.device(device).type == "cuda"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group at ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes`` (idempotent).

    Explicit opt-in only: it joins when given ``coordinator_address`` or
    ``TUMSEG_COORDINATOR_ADDRESS``, and then needs the process count and id
    (arguments or ``TUMSEG_NUM_PROCESSES`` / ``TUMSEG_PROCESS_ID``). With no
    coordinator it is a no-op returning False. ``backend`` defaults to NCCL
    when CUDA is available and gloo otherwise."""
    global _distributed_initialized
    if _distributed_initialized:
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("TUMSEG_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    if num_processes is None and os.environ.get("TUMSEG_NUM_PROCESSES"):
        num_processes = int(os.environ["TUMSEG_NUM_PROCESSES"])
    if process_id is None and os.environ.get("TUMSEG_PROCESS_ID"):
        process_id = int(os.environ["TUMSEG_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed: coordinator_address requires explicit "
            "num_processes and process_id (--num_processes/--process_id or "
            "TUMSEG_NUM_PROCESSES/TUMSEG_PROCESS_ID)")
    dist.init_process_group(backend=backend or default_backend(),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    _distributed_initialized = True
    return True


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def local_devices(n: int, cpu: bool = False):
    """The devices of ``n`` ranks on this host: ``cpu`` ``n`` times, or
    ``cuda:0`` .. ``cuda:n-1``, which must exist."""
    if cpu:
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"a mesh of {n} devices needs {n} CUDA devices; "
                         f"this host has {count}")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, devices=None,
              backend: Optional[str] = None) -> Mesh:
    """This rank's :class:`Mesh` over the process group.

    ``devices`` gives each rank's device, indexed by rank, or one device for
    every rank (ranks that share one card); by default rank ``r`` takes
    ``cuda:r``, or the CPU when CUDA is not available. Asking for more CUDA
    devices than exist raises. Without a group (no
    :func:`initialize_distributed`), a mesh of one device makes a one-rank
    group on a free local port; a larger one raises. The group's size must
    be ``n_devices`` when given."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} devices needs a process group: call "
                "initialize_distributed (or spawn) in every rank first")
        dist.init_process_group(
            backend=backend or default_backend(),
            init_method=f"tcp://localhost:{free_port()}", world_size=1,
            rank=0)
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices on a process group "
                         f"of {size} ranks")
    if devices is None:
        devices = (local_devices(size) if torch.cuda.is_available()
                   else local_devices(size, cpu=True))
    if isinstance(devices, (str, torch.device)):
        device = torch.device(devices)
    else:
        devices = list(devices)
        if len(devices) < size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        device = torch.device(devices[rank])
    return Mesh(size=size, rank=rank, device=device,
                group=dist.group.WORLD)


def close_mesh() -> None:
    """Leaves the process group, so that another can be made."""
    global _distributed_initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _distributed_initialized = False


class _PSum(torch.autograd.Function):
    """The sum over the ranks; its backward sums the cotangent over the
    ranks, the adjoint of the sum of every rank's objective. Each direction
    all-reduces a fresh copy, which inside a capture comes from the graph's
    pool; the backward's all-reduce, issued by autograd, lands in the
    graph as the forward's does."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(
            g.clone(memory_format=torch.contiguous_format)), None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``lax.psum`` over the mesh axis."""
    return _PSum.apply(x, mesh)


def pmean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``lax.pmean`` over the mesh axis."""
    return psum(x, mesh) / mesh.size


def all_reduce_gradients(params, mesh: Mesh) -> None:
    """Every parameter's gradient averaged over the ranks (one all-reduce
    of a flat buffer). Under :func:`psum`'s backward each rank holds
    ``size`` times its share of the gradient, so the mean is the gradient of
    the global loss. The flat buffer is made on each call (inside a capture,
    in the graph's pool) and only device work follows, so a step can hold
    it."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce_(flat).div_(mesh.size)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def broadcast_state(module: torch.nn.Module, mesh: Mesh,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Rank 0's parameters, buffers and optimizer state on every rank."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            mesh.broadcast_(t.data)
        if optimizer is not None:
            for state in optimizer.state.values():
                for v in state.values():
                    if isinstance(v, torch.Tensor):
                        mesh.broadcast_(v)


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous rows of a batch (an array or tensor, or a
    tuple or list of them, all with the same leading axis)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, b) for b in batch)
    return batch[mesh.rows(batch.shape[0])]


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``arr`` along ``axis`` to a multiple of ``multiple`` by repeating
    the last row; returns (padded, original_length)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_block = np.take(arr, [-1] * rem, axis=axis)
    return np.concatenate([arr, pad_block], axis=axis), n


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank, fn, nprocs, address, backend, threads, out, args):
    if threads is not None:
        torch.set_num_threads(threads)
    initialize_distributed(address, nprocs, rank, backend=backend)
    try:
        result = fn(rank, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        close_mesh()


def spawn(fn, nprocs: int, args: Sequence = (), backend: Optional[str] = None,
          threads: Optional[int] = None, timeout: Optional[float] = None):
    """Runs ``fn(rank, *args)`` in ``nprocs`` new processes (``torch.
    multiprocessing`` spawn), each one rank of a process group on a free
    local port (``backend`` as in :func:`initialize_distributed`), with
    ``threads`` intra-op threads when given. Returns rank 0's result; a rank
    that fails raises here and ends the others, and so does ``timeout``
    seconds passing first (``TimeoutError``)."""
    import time

    import torch.multiprocessing as mp

    fd, out = tempfile.mkstemp(suffix=".pkl")
    os.close(fd)
    try:
        ctx = mp.spawn(_spawned, nprocs=nprocs, join=False,
                       args=(fn, nprocs, f"localhost:{free_port()}", backend,
                             threads, out, tuple(args)))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout} s")
        with open(out, "rb") as f:
            return pickle.load(f)
    finally:
        os.unlink(out)


def run_cli(run, args, device: torch.device):
    """The CLIs' mesh (``tumseg/cli/train.py:248-258``): ``run(args,
    mesh)`` on this process, or on ``--num_devices`` spawned ranks.

    ``--num_devices D`` > 1 with no coordinator starts D ranks on this host,
    rank r on ``cuda:r`` (all on the CPU with ``--gpu cpu``, one intra-op
    thread each), and returns rank 0's result. With a coordinator this
    process joins as rank ``--process_id`` of ``--num_processes`` on
    ``device``, and the mesh spans every process. NCCL carries a CUDA mesh,
    gloo a CPU one."""
    cpu = device.type == "cpu"
    backend = "gloo" if cpu else "nccl"
    coordinator = (args.coordinator_address
                   or os.environ.get("TUMSEG_COORDINATOR_ADDRESS"))
    n = args.num_devices or 1
    if coordinator is None and n > 1:
        devices = local_devices(n, cpu=cpu)
        return spawn(_cli_rank, n, (run, args, devices), backend=backend,
                     threads=1 if cpu else None)
    if initialize_distributed(args.coordinator_address, args.num_processes,
                              args.process_id, backend=backend):
        return run(args, make_mesh(args.num_devices, devices=device))
    return run(args, None)


def _cli_rank(rank, run, args, devices):
    return run(args, make_mesh(len(devices), devices=devices))
