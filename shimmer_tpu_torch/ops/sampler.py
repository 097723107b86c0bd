"""ZSobol's per-lane arithmetic on the card: the wrappers of
``csrc/sampler.cu``.

* :func:`zsobol_start` -- ``ZSobolSampler.start_pixel_sample``: the
  Morton word, the sample index and the first dimension of each lane;
* :func:`zsobol_draw` -- ``ZSobolSampler.get_1d`` (width 1) and
  ``get_2d`` (width 2): the draws and the advanced dimension.

One launch a call, bit for bit the torch version in ``samplers.py``
(which the CPU runs, and which the parity tests hold to the reference).
The outputs keep the port's int64 carriers of uint32 words
(``ops/rng.py``).  The wrappers take CUDA tensors only: the sampler
chooses by the tensors' device, and nothing falls back.  Each counts its
launches in ``.launches`` by kernel, a draw's by its width.  The kernel
library ``sampler`` is built at first use by the port's shared nvcc build
(``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from shimmer_tpu_torch.ops import cuda_build
from shimmer_tpu_torch.ops.rng import MASK32

_lock = threading.Lock()
_lib = None


def _library():
    """The ``sampler`` library with its C signatures, built and loaded at
    first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cuda_build.load("sampler")
            p, ci, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
            lib.shimmer_zsobol_start.argtypes = [p, p, i64, u32, i64, ci, u32, p, p, p, p]
            lib.shimmer_zsobol_draw.argtypes = [p, p, i64, u32, ci, ci, ci, ci, p, p, p]
            lib.shimmer_zsobol_start.restype = ci
            lib.shimmer_zsobol_draw.restype = ci
            _lib = lib
        return _lib


def _check_on_card(name: str, x, dtype, shape):
    if x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}: the ZSobol kernels take CUDA tensors")
    cuda_build.check_tensor(name, x, dtype, shape, x.device)


def zsobol_start(pixel_xy, sample_index, log2_spp: int, dim0: int = 0):
    """``(morton, sample_index, dim)`` of the lanes at ``pixel_xy`` ((...,
    2) int32, contiguous), each int64 of ``pixel_xy.shape[:-1]``.
    ``sample_index``: an int, or an int64 tensor on the same card of one
    element or of ``pixel_xy.shape[:-1]``."""
    if pixel_xy.dim() < 1 or pixel_xy.shape[-1] != 2:
        raise ValueError(f"pixel_xy must be (..., 2), got shape {tuple(pixel_xy.shape)}")
    _check_on_card("pixel_xy", pixel_xy, torch.int32, pixel_xy.shape)
    if not 0 <= dim0 <= MASK32:
        raise ValueError(f"dim0 {dim0} is not a uint32 word")
    shape = pixel_xy.shape[:-1]
    n = pixel_xy.numel() // 2
    si, si_stride, si_value = None, 0, 0
    if isinstance(sample_index, torch.Tensor):
        si_stride = 0 if sample_index.numel() == 1 else 1
        cuda_build.check_tensor("sample_index", sample_index, torch.int64,
                                sample_index.shape if si_stride == 0 else shape,
                                pixel_xy.device)
        si = sample_index
    else:
        si_value = int(sample_index) & MASK32
    morton = torch.empty(shape, dtype=torch.int64, device=pixel_xy.device)
    si_out = torch.empty_like(morton)
    dim = torch.empty_like(morton)
    cuda_build.raise_on_error(_library().shimmer_zsobol_start(
        pixel_xy.data_ptr(), None if si is None else si.data_ptr(), si_stride, si_value, n,
        log2_spp, dim0, morton.data_ptr(), si_out.data_ptr(), dim.data_ptr(),
        cuda_build.stream_of(pixel_xy)), "zsobol_start")
    if n:
        zsobol_start.launches["zsobol_start"] += 1
    return morton, si_out, dim


zsobol_start.launches = {"zsobol_start": 0}


def zsobol_draw(morton, dim, seed: int, log2_spp: int, n_base4_digits: int, index_bits: int,
                width: int):
    """``(u, dim + width)`` of the lanes at (``morton``, ``dim``) (int64
    carriers of one shape, contiguous, on the card): ``u`` float32 of that
    shape (width 1) or of it with a last axis of 2 (width 2)."""
    _check_on_card("morton", morton, torch.int64, morton.shape)
    cuda_build.check_tensor("dim", dim, torch.int64, morton.shape, morton.device)
    if width not in (1, 2):
        raise ValueError(f"width must be 1 or 2, got {width}")
    n = morton.numel()
    u = torch.empty((*morton.shape, 2) if width == 2 else morton.shape, dtype=torch.float32,
                    device=morton.device)
    dim_out = torch.empty_like(dim)
    cuda_build.raise_on_error(_library().shimmer_zsobol_draw(
        morton.data_ptr(), dim.data_ptr(), n, seed & MASK32, log2_spp, n_base4_digits,
        index_bits, width, u.data_ptr(), dim_out.data_ptr(), cuda_build.stream_of(morton)),
        "zsobol_draw")
    if n:
        zsobol_draw.launches[f"zsobol_draw<{width}>"] += 1
    return u, dim_out


zsobol_draw.launches = {"zsobol_draw<1>": 0, "zsobol_draw<2>": 0}

WRAPPERS = (zsobol_start, zsobol_draw)


def launch_counts() -> dict:
    """Kernel launches by kernel name, over both wrappers."""
    return {k: v for w in WRAPPERS for k, v in w.launches.items()}


def reset_launches():
    for w in WRAPPERS:
        w.launches = dict.fromkeys(w.launches, 0)
