"""shimmer-tpu-torch: the PyTorch / CUDA port of shimmer-tpu.

A second package beside ``shimmer_tpu`` (the JAX reference, which stays as
it is).  Module paths mirror the reference: ``shimmer_tpu/X/y.py`` has its
counterpart at ``shimmer_tpu_torch/X/y.py``.  Plain device code is torch
tensor code; the one hand-written kernel on the forward render path is the
BVH8 traversal (``ops/traverse.py`` + ``csrc/traverse.cu``), built with
nvcc for Hopper (sm_90a) at first use.

The package imports ``torch`` and never ``jax``.  The host-only BVH
builders (``shimmer_tpu.ops.bvh``, ``shimmer_tpu.ops.bvh8`` and
``shimmer_tpu.native``) import only numpy and ctypes and are shared with
the reference, not copied.
"""

__version__ = "0.1.0"
