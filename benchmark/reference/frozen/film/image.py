"""Host image container, reading, writing and MIP pyramids (port of
``shimmer_tpu/film/image.py``).

An image is a numpy (H, W, C) float32 array in linear RGB.  PFM is read and
written bottom-up and little-endian, as the reference does; PNG, JPEG,
TGA, BMP and WebP are read through PIL with the sRGB decode, and PNG is
written as 8-bit sRGB.  PIL is imported only where an image of those
formats is read or written, so a machine without it still reads PFM.  EXR
needs imageio, which the port does not use: it raises, as the reference
does where imageio is absent.  ``generate_pyramid`` resamples to powers of
two and box-filters down, as the reference's texture pyramids are made.
"""

from __future__ import annotations

import enum
from pathlib import Path

import numpy as np

from benchmark.reference.frozen.color.color import linear_to_srgb, srgb_to_linear


class WrapMode(enum.Enum):
    REPEAT = "repeat"
    CLAMP = "clamp"
    BLACK = "black"
    OCTAHEDRAL_SPHERE = "octahedralsphere"


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
        """PFM as stored; 8- and 16-bit formats through PIL, normalized and
        sRGB-decoded (an alpha channel stays linear)."""
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix == ".pfm":
            return Image(_read_pfm(path))
        if suffix in (".png", ".jpg", ".jpeg", ".tga", ".bmp", ".webp"):
            from PIL import Image as PILImage

            arr = np.asarray(PILImage.open(path))
            if arr.dtype == np.uint8:
                arr = arr.astype(np.float32) / 255.0
            elif arr.dtype == np.uint16:
                arr = arr.astype(np.float32) / 65535.0
            else:
                arr = arr.astype(np.float32)
            if arr.ndim == 3 and arr.shape[-1] == 4:
                arr = np.concatenate([srgb_to_linear(arr[..., :3]), arr[..., 3:]], axis=-1)
            else:
                arr = srgb_to_linear(arr)
            return Image(arr)
        if suffix == ".exr":
            raise NotImplementedError("reading .exr needs imageio, which the port does not use")
        raise ValueError(f"unsupported image format: {suffix}")

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

    def bilerp(self, uv, wrap: WrapMode = WrapMode.REPEAT):
        """Host bilinear sample at uv in [0, 1]^2."""
        w, h = self.resolution
        x = np.asarray(uv)[..., 0] * w - 0.5
        y = np.asarray(uv)[..., 1] * h - 0.5
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        dx = (x - x0)[..., None]
        dy = (y - y0)[..., None]

        def texel(xi, yi):
            xi, yi, ok = _wrap_coords(xi, yi, w, h, wrap)
            return np.where(ok[..., None], self.data[yi, xi], 0.0)

        return (
            (1 - dx) * (1 - dy) * texel(x0, y0)
            + dx * (1 - dy) * texel(x0 + 1, y0)
            + (1 - dx) * dy * texel(x0, y0 + 1)
            + dx * dy * texel(x0 + 1, y0 + 1)
        )

    def generate_pyramid(self) -> list["Image"]:
        """The MIP pyramid: resampled to powers of two, then repeated 2x box
        downsampling to 1x1."""
        img = self._to_pow2()
        levels = [img]
        while max(img.resolution) > 1:
            img = img._downsample_2x()
            levels.append(img)
        return levels

    def _to_pow2(self) -> "Image":
        w, h = self.resolution
        nw = 1 << (w - 1).bit_length() if w > 1 else 1
        nh = 1 << (h - 1).bit_length() if h > 1 else 1
        if (nw, nh) == (w, h):
            return self
        return self.resize(nw, nh)

    def resize(self, nw: int, nh: int) -> "Image":
        """Bilinear resample with clamped edges."""
        ys = (np.arange(nh) + 0.5) / nh
        xs = (np.arange(nw) + 0.5) / nw
        uv = np.stack(np.meshgrid(xs, ys), axis=-1)
        return Image(self.bilerp(uv, WrapMode.CLAMP))

    def _downsample_2x(self) -> "Image":
        d = self.data
        h, w = d.shape[:2]
        nh, nw = max(1, h // 2), max(1, w // 2)
        if h > 1 and w > 1:
            out = (
                d[0 : 2 * nh : 2, 0 : 2 * nw : 2]
                + d[1 : 2 * nh : 2, 0 : 2 * nw : 2]
                + d[0 : 2 * nh : 2, 1 : 2 * nw : 2]
                + d[1 : 2 * nh : 2, 1 : 2 * nw : 2]
            ) * 0.25
        elif h > 1:
            out = (d[0 : 2 * nh : 2] + d[1 : 2 * nh : 2]) * 0.5
        else:
            out = (d[:, 0 : 2 * nw : 2] + d[:, 1 : 2 * nw : 2]) * 0.5
        return Image(out)


def _wrap_coords(x, y, w, h, wrap: WrapMode):
    ok = np.ones(np.shape(x), bool)
    if wrap == WrapMode.REPEAT:
        x = np.mod(x, w)
        y = np.mod(y, h)
    elif wrap == WrapMode.CLAMP:
        x = np.clip(x, 0, w - 1)
        y = np.clip(y, 0, h - 1)
    elif wrap == WrapMode.BLACK:
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        x = np.clip(x, 0, w - 1)
        y = np.clip(y, 0, h - 1)
    elif wrap == WrapMode.OCTAHEDRAL_SPHERE:
        # Reflect across the edges of the equal-area square, with its flip.
        assert w == h
        under_x = x < 0
        over_x = x >= w
        x = np.where(under_x, -1 - x, np.where(over_x, 2 * w - 1 - x, x))
        y = np.where(under_x | over_x, h - 1 - y, y)
        under_y = y < 0
        over_y = y >= h
        y = np.where(under_y, -1 - y, np.where(over_y, 2 * h - 1 - y, y))
        x = np.where(under_y | over_y, w - 1 - x, x)
    return x, y, ok


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
