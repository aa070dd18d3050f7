"""tumseg_torch — the PyTorch/CUDA port of tumseg for NVIDIA Hopper.

The JAX package ``tumseg`` stays the reference. This package imports
``torch`` and never ``jax``; it reuses ``tumseg``'s framework-free modules
(LAS I/O, the grid dataset, geometric features, label tables, writers) by
import.

- ``tumseg_torch.ops``     point ops: hand-written CUDA kernels on CUDA
                           tensors, plain PyTorch versions on CPU tensors
- ``tumseg_torch.nn``      set abstraction / feature propagation modules
- ``tumseg_torch.models``  model registry (``pointnet2_sem_seg``) and weight
                           conversion from and to ``tumseg``
- ``tumseg_torch.train``   ``tumseg-ckpt-v2`` checkpoints, metric tallies
- ``tumseg_torch.infer``   whole-scene voting inference
- ``tumseg_torch.cli``     ``python -m tumseg_torch.cli.test``
"""
