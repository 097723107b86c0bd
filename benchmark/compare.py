"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference's recomputation (``benchmark/reference/``).
Each loop's ``check`` returns {name: {"value", "limit"}} from these, and
a run is correct when every value is at most its limit.

Each limit is the configuration's: its file's ``limits`` holds them by
loop kind, set from the readings ``PERF.md`` gives.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

SAMPLED_PIXELS = 8192
REL_TOL = 1e-4
ABS_FLOOR = 1e-6


def limits(config: dict, kind: str) -> dict:
    """The configuration's limits for the check of loop ``kind``."""
    return config["limits"][kind]


def sample_pixels(resolution, seed: int, k: int, device) -> torch.Tensor:
    """(k, 2) int32 distinct pixels drawn from ``seed``."""
    w, h = resolution
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    flat = rng.choice(w * h, size=min(k, w * h), replace=False)
    return torch.from_numpy(np.stack([flat % w, flat // w], -1).astype(np.int32)).to(device)


def pixel_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per pixel, the largest relative gap of a channel."""
    return ((got - want).abs() / (want.abs() + ABS_FLOOR)).amax(-1)


def frames_numbers(got: torch.Tensor, want: torch.Tensor, limit: dict) -> dict:
    """The compared number of sampled pixels ``got`` against the
    reference's ``want``, both (K, 3), beside its limit: the share of
    pixels with a channel off by more than ``REL_TOL`` of the
    reference's."""
    gaps = pixel_gaps(got, want)
    off = 100.0 * float((gaps > REL_TOL).float().mean())
    print(f"pixel gaps: largest {float(gaps.max())!r}, median {float(gaps.median())!r}, off at "
          f"1e-5 {100.0 * float((gaps > 1e-5).float().mean())!r}%, at 1e-3 "
          f"{100.0 * float((gaps > 1e-3).float().mean())!r}%", file=sys.stderr)
    return {"off_pixels_pct": {"value": off, "limit": limit["off_pixels_pct"]}}


# Leaves (material rows) whose reference gradient norm is under this share
# of the median row's (the mean of the middle two for an even count) are
# nought to rounding, and left out of the gradient and change comparisons.
NOUGHT_GRAD = 1e-3


def norm_gaps(got: torch.Tensor, want: torch.Tensor, keep: torch.Tensor) -> float:
    """The worst kept row's gap between the program's norm and the
    reference's, over the larger of that row's reference norm and the
    median row's."""
    g, w = got.double().norm(dim=-1), want.double().norm(dim=-1)
    scale = torch.maximum(w, torch.quantile(w, 0.5))
    return float(((g - w).abs() / scale)[keep].max())


def grad_numbers(got: dict, ref: dict, limit: dict) -> dict:
    """The compared numbers of the program's first steps ``got`` against
    the reference's ``ref`` (each with ``losses``, one a step, ``grad``,
    the first step's gradient, ``change``, the parameters' change over
    the steps, and ``before``), beside their limits: the worst step's
    relative loss gap, and the worst kept row's gap of gradient and of
    change norms."""
    rg = ref["grad"].double().norm(dim=-1)
    keep = rg >= NOUGHT_GRAD * torch.quantile(rg, 0.5)
    loss_gap = max(abs(g - r) / abs(r) for g, r in zip(got["losses"], ref["losses"],
                                                         strict=True))
    out = {
        "loss_gap": {"value": loss_gap, "limit": limit["loss_gap"]},
        "grad_gap": {"value": norm_gaps(got["grad"], ref["grad"], keep),
                     "limit": limit["grad_gap"]},
        "change_gap": {"value": norm_gaps(got["change"], ref["change"], keep),
                       "limit": limit["change_gap"]},
    }
    print(f"check grad_steps: losses {got['losses']!r} against {ref['losses']!r}; gradient rows "
          f"{got['grad'].tolist()} against {ref['grad'].tolist()}; change rows "
          f"{got['change'].tolist()} against {ref['change'].tolist()}; rows kept {keep.tolist()}; "
          f"starting rows equal {bool(torch.equal(got['before'], ref['before']))}",
          file=sys.stderr)
    return out
