"""Scene files through the port's pbrt-v4 loader and CLI on the card:

* the three committed golden scenes (analytic spheres beside triangles)
  rendered on the card under v1 at their in-file settings and held to
  tests/scenes/golden_*.npz at tests/test_golden.py's tolerances;
* the bench scene as a scene file (the sphere mesh a binary PLY, three
  analytic spheres), with textures and an image environment light, with
  delta lights and homogeneous media (in a fog with a smoke box, in the
  fog alone, without media), with bilinear patches and two-level
  instances, and tests/test_parser.py's instanced and bilinear scenes:
  each rendered at 64x48, 4 spp through ``cli.main`` on the card, the PFM
  it writes equal to the image ``render`` returned, that image against
  the file loaded and rendered on the CPU, and the v1 launches an iteration
  counted where the scene fixes them (four with interface media: the
  merged trace and three shadow-march rounds; else one);
* the textured scene's render repeated on the card: the film states
  ``torch.equal`` (the film accumulates by scatter-add).

Marked ``card``; run on the card as tests/card_checks.py says.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import card_scenes as cs
from card_checks import (  # noqa: F401  (card: a fixture)
    BLOCK,
    CONFIGS,
    SMALL_RES,
    SMALL_SPP,
    assert_images_agree,
    card,
    launches,
    reset_launches,
)
from shimmer_tpu_torch import cli
from shimmer_tpu_torch import render as render_module
from shimmer_tpu_torch.bench_scene import BENCH_TRIS, make_displaced_sphere
from shimmer_tpu_torch.film.image import Image
from shimmer_tpu_torch.loading.parser import parse_file
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder

pytestmark = pytest.mark.card

GOLDEN_DIR = Path(__file__).parent / "scenes"
GOLDEN_SCENES = ("diffuse_box", "conductor_env", "dielectric")
# tests/test_golden.py's tolerances: mean and 99th percentile of the
# absolute difference, relative to the golden's mean absolute value.
GOLDEN_MEAN_REL, GOLDEN_P99_REL = 0.01, 0.05
WAVE_SPP = 16

# Scene file -> its text and the v1 launches an iteration (None: not fixed).
SCENES = {
    "loaded": (cs.loaded_scene_text(SMALL_RES, SMALL_SPP), None),
    "textured": (cs.textured_scene_text(SMALL_RES, SMALL_SPP), None),
    **{f"media_{v}": (cs.media_scene_text(SMALL_RES, SMALL_SPP, v), 4 if v == "interface" else 1)
       for v in cs.MEDIA_VARIANTS},
    "instanced": (cs.instanced_scene_text(SMALL_RES, SMALL_SPP), 1),
    **{name: (text, 1) for name, text in cs.PARSER_SCENES.items()},
}


@pytest.mark.parametrize("name", GOLDEN_SCENES)
def test_golden_scene_on_the_card(card, name):
    builder = SceneBuilder(search_dir=GOLDEN_DIR)
    parse_file(str(GOLDEN_DIR / f"{name}.pbrt"), builder)
    job = builder.create(device=card, traverse=CONFIGS["v1"])
    reset_launches()
    img, _ = render_module.render(job.scene, job.camera, job.film, job.sampler,
                                  integrator=job.integrator, spp=job.spp,
                                  max_depth=job.max_depth, wave_spp=WAVE_SPP, pixel_block=BLOCK)
    launches("v1")
    img = img.cpu().numpy()
    golden = np.load(GOLDEN_DIR / f"golden_{name}.npz")["image"]
    assert img.shape == golden.shape and np.isfinite(img).all()
    scale = max(float(np.abs(golden).mean()), 1e-6)
    diff = np.abs(img - golden)
    assert diff.mean() / scale < GOLDEN_MEAN_REL
    assert np.quantile(diff, 0.99) / scale < GOLDEN_P99_REL


@pytest.fixture(scope="module")
def scene_dir(card, tmp_path_factory):
    """A directory holding the bench sphere's PLY and the textures."""
    d = tmp_path_factory.mktemp("scenes")
    cs.write_ply(d / cs.LOADED_PLY, *make_displaced_sphere(BENCH_TRIS))
    cs.write_texture_files(d)
    return d


def render_through_cli(monkeypatch, scene_file: Path, pfm: Path) -> dict:
    """``cli.main`` on ``scene_file`` on the card at the small renders' wave
    and pool, its own render call watched: the image and film state it
    returned, its stats and the call itself."""
    real_render, seen = render_module.render, {}

    def watched_render(*args, **kwargs):
        kwargs.pop("collect_stats", None)
        image, state, stats = real_render(*args, **kwargs, collect_stats=True)
        seen.update(image=image.cpu().numpy(), state=state, stats=stats, args=args,
                    kwargs=kwargs)
        return image, state

    monkeypatch.setattr(render_module, "render", watched_render)
    rc = cli.main([str(scene_file), "--outfile", str(pfm), "--wave-spp", str(SMALL_SPP),
                   "--pixel-block", str(BLOCK), "--quiet", "--device", "cuda"])
    monkeypatch.undo()
    assert rc == 0
    return seen


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_file_through_the_cli_on_the_card(scene_dir, monkeypatch, name):
    text, per_iter = SCENES[name]
    scene_file = scene_dir / f"{name}.pbrt"
    scene_file.write_text(text)
    pfm = scene_dir / f"{name}.pfm"
    reset_launches()
    seen = render_through_cli(monkeypatch, scene_file, pfm)
    if seen["args"][0].has_triangles:
        n = launches("v1")
        if per_iter is not None:
            assert n == per_iter * int(seen["stats"]["iters"])
    assert np.array_equal(Image.read(pfm).data, seen["image"])

    scene = seen["args"][0]
    if name.startswith("media_"):
        variant = name.removeprefix("media_")
        assert scene.has_interface_media == (variant == "interface")
        assert (scene.media is None) == (variant == "delta")
    # The CPU loads the file itself and renders it at the CLI's settings.
    builder = SceneBuilder(search_dir=scene_dir)
    parse_file(str(scene_file), builder)
    job = builder.create(device="cpu")
    kwargs = {k: v for k, v in seen["kwargs"].items() if k != "progress"}
    cpu, _ = render_module.render(job.scene, job.camera, job.film, job.sampler, **kwargs)
    assert_images_agree(seen["image"], cpu)

    if name == "textured":
        _, again, _ = render_module.render(*seen["args"], **seen["kwargs"], collect_stats=True)
        for field in ("rgb_sum", "weight_sum", "rgb_splat"):
            assert torch.equal(getattr(again, field), getattr(seen["state"], field)), field
