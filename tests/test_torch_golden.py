"""Golden images through the port: each committed scene
(tests/scenes/*.pbrt) parsed by the port's loader and rendered on the CPU
at its in-file settings (64x64, 16 spp, depth 4/5/6), held against its
committed image (tests/scenes/golden_*.npz) at tests/test_golden.py's
tolerances: mean relative error < 0.01 and p99 < 0.05, each relative to
the golden's mean absolute value.  All of a scene's samples run in one
wave.  On one CPU thread the renders take ~17, ~12 and ~13 s, none over
a minute, so none is marked slow.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from shimmer_tpu_torch.loading.parser import parse_file
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
from shimmer_tpu_torch.render import render

torch.set_num_threads(1)

SCENES_DIR = Path(__file__).parent / "scenes"


@pytest.mark.parametrize("name", ["diffuse_box", "conductor_env", "dielectric"])
def test_golden(name):
    golden = np.load(SCENES_DIR / f"golden_{name}.npz")["image"]
    builder = SceneBuilder(search_dir=SCENES_DIR)
    parse_file(str(SCENES_DIR / f"{name}.pbrt"), builder)
    job = builder.create(device="cpu")
    image, state = render(job.scene, job.camera, job.film, job.sampler,
                          integrator=job.integrator, spp=job.spp, max_depth=job.max_depth,
                          wave_spp=job.spp)
    img = image.numpy()
    assert img.shape == golden.shape
    assert np.isfinite(img).all()
    assert (state.weight_sum.numpy() == job.spp).all()
    scale = max(float(np.abs(golden).mean()), 1e-6)
    diff = np.abs(img - golden)
    mean_rel = diff.mean() / scale
    p99_rel = np.quantile(diff, 0.99) / scale
    print(f"{name}: mean_rel {mean_rel:.3e} p99_rel {p99_rel:.3e}")
    assert mean_rel < 0.01, f"{name}: mean drift {mean_rel:.4f}"
    assert p99_rel < 0.05, f"{name}: p99 drift {p99_rel:.4f}"
