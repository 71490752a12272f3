"""metamaps_tpu_torch — the PyTorch / CUDA port of ``metamaps_tpu``.

The JAX package stays the reference; this package reproduces its main path,
``mapDirectly`` on one shard followed by ``classify``, with PyTorch tensors
on an explicit device:

- sketch, index lookup, L1 candidate regions and L2 event construction are
  plain torch ops (``metamaps_tpu_torch.ops``);
- the L2 event sweep, the one Pallas kernel on that path, is a hand-written
  CUDA kernel for Hopper (``csrc/l2_sweep.cu``, wrapper
  ``metamaps_tpu_torch.ops.l2_sweep``);
- the host code that the JAX package cannot import without ``jax`` (index
  build, serial oracle, mapping orchestration) has jax-free copies under
  ``metamaps_tpu_torch.engine``; everything else (IO, statistics, taxonomy,
  EM) is imported from ``metamaps_tpu`` unchanged.

Nothing in this package imports ``jax``.
"""

__version__ = "0.1.0"
