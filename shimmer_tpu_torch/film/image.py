"""Host image container and writers (port of ``shimmer_tpu/film/image.py``:
``Image`` with ``write`` to PFM and PNG, and the PFM reader).

An image is a numpy (H, W, C) float32 array in linear RGB.  PFM is written
bottom-up and little-endian, as the reference writes it; PNG is 8-bit sRGB
through PIL.  EXR needs imageio, which the port does not use: it raises,
as the reference does where imageio is absent.  Reading other formats
waits for the texture slice.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def linear_to_srgb(v):
    """sRGB encoding of linear values clipped to [0, 1]."""
    v = np.clip(v, 0.0, 1.0)
    return np.where(v <= 0.0031308, v * 12.92, 1.055 * v ** (1.0 / 2.4) - 0.055)


class Image:
    """(H, W, C) float32 linear-space image."""

    def __init__(self, data):
        data = np.asarray(data, np.float32)
        if data.ndim == 2:
            data = data[..., None]
        self.data = data

    @property
    def resolution(self):
        """(width, height)"""
        return (self.data.shape[1], self.data.shape[0])

    @property
    def n_channels(self):
        return self.data.shape[-1]

    @staticmethod
    def read(path: str | Path) -> "Image":
        path = Path(path)
        if path.suffix.lower() == ".pfm":
            return Image(_read_pfm(path))
        raise NotImplementedError(f"reading {path.suffix} images is not ported yet")

    def write(self, path: str | Path):
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix == ".pfm":
            _write_pfm(path, self.data)
        elif suffix == ".png":
            from PIL import Image as PILImage

            arr = self.data[..., :3] if self.n_channels >= 3 else self.data[..., 0]
            enc = np.clip(linear_to_srgb(np.asarray(arr, np.float64)), 0, 1)
            PILImage.fromarray((enc * 255.0 + 0.5).astype(np.uint8)).save(path)
        elif suffix == ".exr":
            raise NotImplementedError("writing .exr needs imageio, which the port does not use")
        else:
            raise ValueError(f"unsupported image format: {suffix}")


def _read_pfm(path: Path) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError("not a PFM file")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        data = np.frombuffer(f.read(w * h * channels * 4), dtype="<f4" if scale < 0 else ">f4")
        img = data.reshape(h, w, channels)
        # PFM scanlines are bottom-up.
        return (np.ascontiguousarray(img[::-1]) * np.float32(abs(scale))).astype(np.float32)


def _write_pfm(path: Path, data: np.ndarray):
    """Bottom-up little-endian PFM."""
    h, w = data.shape[:2]
    c = data.shape[2] if data.ndim == 3 else 1
    if c not in (1, 3):
        data = data[..., :3]
        c = 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if c == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.000000\n")
        f.write(np.ascontiguousarray(data[::-1], "<f4").tobytes())
