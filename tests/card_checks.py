"""What the ``card``-marked tests share: the fixture that finds the card,
the image agreement criterion between the card and the CPU, and the
traversal's launch counters.

The card tests live beside each layer's CPU tests, in
``tests/test_torch_*_card.py``.  Each skips without a CUDA card.
tests/conftest.py imports JAX, which the card's machine lacks, so this
module is not a conftest: the card files import it, and the suite runs on
the card with

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_*_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from shimmer_tpu_torch.ops import sampler as zk
from shimmer_tpu_torch.ops import traverse as tv
from shimmer_tpu_torch.ops.traverse import TraverseConfig

# Image agreement between two renders of the same seeds (the CPU tests use
# the same criteria against the JAX reference): at least 99% of pixels
# within rtol 1e-3 / atol 1e-4 and image means within 1e-3 relative.  The
# margin covers a path that branches differently on a last-ulp difference
# of a transcendental (CUDA and CPU math libraries differ there), a tie
# between two triangles at the same t that another traversal order breaks
# the other way, and the run-to-run order of the film's atomic scatter-add.
PIXEL_RTOL, PIXEL_ATOL, PIXEL_FRAC, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3

# The small renders: the render path at the bench's depth and lane pool.
SMALL_RES = (64, 48)
SMALL_SPP = 4
MAX_DEPTH = 5
BLOCK = 1 << 17

# The traversal configurations on the render path, by launch-counter name.
CONFIGS = {
    "v1": TraverseConfig("v1", "watertight", "slot"),
    "v2": TraverseConfig("v2", "watertight", "slot"),
    "v1_mt": TraverseConfig("v1", "mt", "slot"),
    "v1_min": TraverseConfig("v1", "watertight", "min"),
}


@pytest.fixture(scope="session")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)


def as_image(img) -> np.ndarray:
    return img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def assert_images_agree(card_img, cpu_img):
    """Both images finite and lit, and within the agreement criterion."""
    a, b = as_image(card_img), as_image(cpu_img)
    for name, img in (("card", a), ("cpu", b)):
        assert np.isfinite(img).all() and img.mean() > 0, f"bad {name} image"
    close = np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(axis=-1)
    assert close.mean() >= PIXEL_FRAC, f"{close.mean():.4f} of pixels agree"
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(b.mean())), 1e-12)
    assert mean_rel <= MEAN_RTOL, f"image means {a.mean()} and {b.mean()}"


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| / |b|, with |b| floored at 1e-6 of max |b|."""
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6 * np.abs(b).max())))


def reset_launches():
    tv.traverse_raw.launches = dict.fromkeys(tv.KERNEL_NAMES, 0)
    tv.traverse_raw_plain.calls = 0
    zk.reset_launches()


def launches(expect: str = "v1") -> int:
    """The launches of kernel ``expect`` since reset_launches(); fails
    unless it launched, nothing else launched and the plain traversal
    never ran."""
    counts = dict(tv.traverse_raw.launches)
    assert counts[expect] > 0, f"the {expect} kernel was not launched"
    others = {k: v for k, v in counts.items() if k != expect and v}
    assert not others, f"other kernels launched: {others}"
    assert tv.traverse_raw_plain.calls == 0, "the plain traversal ran on the card"
    return counts[expect]
