"""Per-wave render checkpoints (port of ``shimmer_tpu/utils/checkpoint.py``).

A checkpoint is exact: the film accumulators (FilmState) and the wave
cursor.  The sampler is a counter-based stream keyed by (pixel,
sample_index), so no RNG state needs saving; resuming replays the
remaining (wave, block) pairs and gives bit-identical film planes.

Format, shared with the reference (either package reads the other's
files): one ``.npz`` written atomically (a temporary file and
``os.replace``) holding ``rgb_sum``, ``weight_sum``, ``rgb_splat``, the
spp cursor ``spp_done`` and ``fingerprint``, the JSON text of the render
configuration as uint8 bytes.  A fingerprint mismatch makes the file
stale: it is ignored with a warning, not an error.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class RenderCheckpointer:
    """Atomic ``.npz`` checkpoints of (FilmState, wave cursor)."""

    def __init__(self, path, fingerprint: dict | None = None):
        self.path = os.fspath(path)
        self.fingerprint = json.dumps(fingerprint or {}, sort_keys=True, default=str)

    def save(self, film_state, spp_done: int) -> None:
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    rgb_sum=_host(film_state.rgb_sum),
                    weight_sum=_host(film_state.weight_sum),
                    rgb_splat=_host(film_state.rgb_splat),
                    spp_done=np.int64(spp_done),
                    fingerprint=np.frombuffer(self.fingerprint.encode(), dtype=np.uint8),
                )
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self):
        """``(dict of the three film planes as numpy arrays, spp_done)``,
        or None when the file is absent, stale (fingerprint mismatch) or
        unreadable."""
        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path) as z:
                fp = bytes(z["fingerprint"]).decode()
                if fp != self.fingerprint:
                    warnings.warn(f"checkpoint fingerprint mismatch - ignoring {self.path}")
                    return None
                return (
                    {"rgb_sum": z["rgb_sum"], "weight_sum": z["weight_sum"],
                     "rgb_splat": z["rgb_splat"]},
                    int(z["spp_done"]),
                )
        except (OSError, ValueError, KeyError) as e:
            warnings.warn(f"unreadable checkpoint {self.path}: {e}")
            return None

    def remove(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
