"""Global numeric configuration (port of ``shimmer_tpu/config.py``).

Every device tensor in the port is float32, as in the reference.  numpy
inputs are converted with an explicit dtype (:func:`f32`, :func:`i32`):
``torch.from_numpy`` keeps float64 as float64, which would silently
promote whole ray buffers.  Entry points that build tensors take
``device=None`` to mean the CUDA card (:func:`resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch

# Largest float32 below 1 (shimmer_tpu/config.py).
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: ``device`` as given, else the
    CUDA card.  Without a card, ``device=None`` raises; the CPU is used
    only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "benchmark.reference.frozen runs on a CUDA card and none is available; "
            'pass device="cpu" to run the plain torch versions on the CPU'
        )
    return torch.device("cuda")


def f32(x, device=None) -> torch.Tensor:
    """numpy / scalar / tensor -> float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def i32(x, device=None) -> torch.Tensor:
    """numpy / scalar / tensor -> int32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.from_numpy(np.array(x, np.int32)).to(device)
