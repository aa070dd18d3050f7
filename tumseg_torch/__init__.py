"""tumseg_torch — the PyTorch/CUDA port of tumseg for NVIDIA Hopper.

The JAX package ``tumseg`` stays the reference. This package imports
``torch`` and never ``jax`` nor anything of ``tumseg``: it keeps its own
copies of ``tumseg``'s framework-free modules (LAS I/O, the datasets,
geometric features, the batch loader, label tables, writers, the viewer),
which ``tests/test_torch_data.py`` pins to the originals.

- ``tumseg_torch.ops``       point ops: hand-written CUDA kernels on CUDA
                             tensors, plain PyTorch versions on CPU tensors
- ``tumseg_torch.nn``        set abstraction, feature propagation and
                             PointNet modules
- ``tumseg_torch.models``    model registry (``pointnet2_sem_seg``, MSG,
                             PointNet, the frozen variants) and weight
                             conversion from and to ``tumseg``
- ``tumseg_torch.data``      LAS I/O, the block and grid datasets, the host
                             loader, the device block sampler, augmentations
- ``tumseg_torch.train``     ``TrainEngine``/``fit``, ``tumseg-ckpt-v2``
                             checkpoints, metric tallies
- ``tumseg_torch.infer``     whole-scene voting inference
- ``tumseg_torch.parallel``  the ``data`` mesh on ``torch.distributed``
- ``tumseg_torch.utils``     labels, timing, progress, profiling, debug
- ``tumseg_torch.viz``       label and point-cloud writers, the viewer
- ``tumseg_torch.tools``     the soak and trained-model mIoU tools, and the
                             kernels' probes
- ``tumseg_torch.cli``       ``python -m tumseg_torch.cli.train`` and
                             ``python -m tumseg_torch.cli.test``
                             (``tumseg-torch-train``, ``tumseg-torch-test``)
"""
