"""shimmer-tpu-torch: the PyTorch / CUDA port of shimmer-tpu.

A second package beside ``shimmer_tpu`` (the JAX reference, which stays as
it is).  Module paths mirror the reference: ``shimmer_tpu/X/y.py`` has its
counterpart at ``shimmer_tpu_torch/X/y.py``.  Plain device code is torch
tensor code; the hand-written kernels on the forward render path are the
BVH8 traversals (``ops/traverse.py`` over ``csrc/traverse.cu``), built
with nvcc for Hopper (sm_90a) at first use.
Entry points that take ``device=None`` run on the CUDA card, and raise
where there is none; the CPU runs the plain torch versions only when the
caller asks for it (``device="cpu"``).

The package imports ``torch`` and never ``jax`` or anything of
``shimmer_tpu``.  It keeps its own copies of the reference's host-only
pieces: the BVH builders (``ops/bvh.py``, ``ops/bvh8.py``), the native SAH
builder (``native/``, built with g++ at first use) and the spectral data
tables (``spectra/data/``).
"""

__version__ = "0.1.0"
