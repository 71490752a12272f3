"""metamaps_tpu_torch — the PyTorch / CUDA port of ``metamaps_tpu``.

The JAX package stays the reference; this package reproduces its main path,
``mapDirectly`` on one shard followed by ``classify``, with PyTorch tensors
on an explicit device:

- sketch, index lookup, L1 candidate regions and L2 event construction are
  plain torch ops (``metamaps_tpu_torch.ops``);
- the L2 event sweep, the one Pallas kernel on that path, is a hand-written
  CUDA kernel for Hopper (``csrc/l2_sweep.cu``, wrapper
  ``metamaps_tpu_torch.ops.l2_sweep``), as are the repository's other
  Pallas sweep kernels (row-block, eager, ablation), which the sweep bench
  (``metamaps_tpu_torch.profiling.sweep_bench``) drives;
- ``classify`` runs its EM rounds in float64 on the device
  (``metamaps_tpu_torch.engine.em``);
- the host code (index build, serial oracle, mapping orchestration, IO,
  statistics, taxonomy, synthetic data) has its own copies in this package.

Nothing in this package imports ``jax`` or ``metamaps_tpu``.
"""

__version__ = "0.1.0"
