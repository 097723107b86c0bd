"""The slice as a whole: the port's wavefront render of the bench scene
against the reference's, on the CPU at 24x16 pixels, 2 spp, depth 5.

The reference runs ``make_wavefront_renderer`` (XLA traversal on the CPU);
the port runs the same estimator through its plain traversal, on tables
carried across with ``scene_from_numpy`` and on tables from its own
builders.  The sampler is counter-based, so the two renders agree per
sample up to float32 rounding (XLA contracts FMAs, transcendentals differ
in the last ulp).  Criteria, as chip_smoke.py uses them: images finite
with a positive mean, at least 99% of pixels within rtol 1e-3 / atol 1e-4,
image means within 1e-3 relative; the margin covers a path that branches
differently on a last-ulp difference.  The traced-ray count must match
exactly.

The material slice renders the material bench scene
(bench_scene.build_material_bench_scene) the same way, one case per table
variant: the mix of rough gold and dispersive BK7 over a coated-diffuse
floor; BK7 over a rough constant-eta glass floor; a coated conductor over
a thin-dielectric floor.  The reference scene is built by the reference's
build_scene from the same material dicts and dense spectra table.

The slice runs under every traversal configuration (ops/traverse.py
TraverseConfig) against the same reference render: v2 and the min-id
winner change only which of two triangles at an exact tie wins, and
Moller-Trumbore leaves change hit decisions only at triangle edges, where
the re-intersection gate turns a disagreement into a miss.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from shimmer_tpu.lights import lights as jlt
from shimmer_tpu.render import make_wavefront_renderer as jax_wavefront
from shimmer_tpu.render import pixel_blocks as jax_blocks
from shimmer_tpu.render import render as jax_render
from shimmer_tpu.samplers import ZSobolSampler as JaxZSobol
from shimmer_tpu.scene_builder import build_scene as jax_build_scene
from shimmer_tpu.spectra.spectrum import ConstantSpectrum as JaxConstant
from shimmer_tpu_torch import bench_scene
from shimmer_tpu_torch.convert import scene_from_numpy
from shimmer_tpu_torch.ops.traverse import TraverseConfig
from shimmer_tpu_torch.render import make_wavefront_renderer as torch_wavefront
from shimmer_tpu_torch.render import pixel_blocks as torch_blocks
from shimmer_tpu_torch.render import render as torch_render
from shimmer_tpu_torch.samplers import ZSobolSampler as TorchZSobol
from torch_parity import ensure_reference_sah, jax_scene_to_numpy

torch.set_num_threads(1)

RES = (24, 16)
SPP = 2
DEPTH = 5
N_TRIS = 1280


@pytest.fixture(scope="module")
def scenes():
    ensure_reference_sah()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BENCH_RES", f"{RES[0]}x{RES[1]}")
        jscene, jcam, jfilm, _ = bench.build_bench_scene(N_TRIS)
    tscene, tcam, tfilm = bench_scene.build_bench_scene(N_TRIS, RES, device="cpu")
    arrays, census = jax_scene_to_numpy(jscene)
    return {
        "jax": (jscene, jcam, jfilm),
        "torch": (tscene, tcam, tfilm),
        "converted": (scene_from_numpy(arrays, census, device="cpu"), tcam, tfilm),
    }


@pytest.fixture(scope="module")
def jax_wave(scenes):
    jscene, jcam, jfilm = scenes["jax"]
    wave = jax_wavefront(jscene, jcam, jfilm, JaxZSobol(SPP, RES), max_depth=DEPTH,
                         with_stats=True)
    blocks, valids = jax_blocks(jfilm, RES[0] * RES[1])
    state, stats = wave(jfilm.init_state(), jnp.arange(SPP, dtype=jnp.uint32),
                        blocks[0], valids[0])
    return np.asarray(jfilm.get_image(state)), float(stats["rays"]), float(stats["iters"])


def assert_images_agree(img, ref):
    assert np.isfinite(img).all() and np.isfinite(ref).all()
    assert img.mean() > 0 and ref.mean() > 0
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-4).all(axis=-1)
    print(f"fraction of pixels that differ: {1.0 - close.mean():.6f}")
    assert close.mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.parametrize("tables", ["converted", "torch"])
def test_wavefront_matches_reference(scenes, jax_wave, tables):
    ref, rays, iters = jax_wave
    tscene, tcam, tfilm = scenes[tables]
    wave = torch_wavefront(tscene, tcam, tfilm, TorchZSobol(SPP, RES), max_depth=DEPTH)
    blocks, valids = torch_blocks(tfilm, RES[0] * RES[1], device="cpu")
    state, stats = wave(tfilm.init_state("cpu"), torch.arange(SPP), blocks[0], valids[0])
    assert float(stats["rays"]) == rays
    assert float(stats["iters"]) == iters
    assert_images_agree(tfilm.get_image(state).numpy(), ref)


def test_render_two_pixel_blocks_with_padding(scenes):
    """render() over 2 pixel blocks of 200 (16 padded lanes)."""
    jscene, jcam, jfilm = scenes["jax"]
    tscene, tcam, tfilm = scenes["converted"]
    block = 200
    assert torch_blocks(tfilm, block, device="cpu")[0].shape[0] == 2
    ref, _ = jax_render(jscene, jcam, jfilm, JaxZSobol(SPP, RES), spp=SPP, max_depth=DEPTH,
                        wave_spp=SPP, pixel_block=block)
    img, state, stats = torch_render(tscene, tcam, tfilm, TorchZSobol(SPP, RES), spp=SPP,
                                     max_depth=DEPTH, wave_spp=SPP, pixel_block=block,
                                     collect_stats=True)
    assert (state.weight_sum.numpy() == SPP).all()  # every pixel got SPP samples
    assert stats["rays"] > 0
    assert_images_agree(img.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "config",
    [("v1", "watertight", "slot"), ("v2", "watertight", "slot"), ("v1", "mt", "slot"),
     ("v1", "watertight", "min"), ("v1", "mt", "min")],
    ids=["v1", "v2", "v1_mt", "v1_min", "v1_mt_min"],
)
def test_wavefront_under_each_traverse_config(scenes, jax_wave, config):
    ref, rays, iters = jax_wave
    tscene, tcam, tfilm = scenes["torch"]
    tris = tscene.triangles.with_traverse(TraverseConfig(*config))
    tscene = dataclasses.replace(tscene, triangles=tris)
    wave = torch_wavefront(tscene, tcam, tfilm, TorchZSobol(SPP, RES), max_depth=DEPTH)
    blocks, valids = torch_blocks(tfilm, RES[0] * RES[1], device="cpu")
    state, stats = wave(tfilm.init_state("cpu"), torch.arange(SPP), blocks[0], valids[0])
    assert float(stats["rays"]) == rays
    assert float(stats["iters"]) == iters
    assert_images_agree(tfilm.get_image(state).numpy(), ref)


def _jax_material_scene(scenes, variant):
    """The reference's build_scene over the bench triangles, with the
    material bench scene's material dicts, dense spectra table and the
    bench lights."""
    jscene, jcam, jfilm = scenes["jax"]
    n_tri = int(np.asarray(jscene.triangles.orig_indices).shape[0])
    lights = [
        {"kind": jlt.AREA, "spectrum": JaxConstant(1.0), "scale": 15.0, "shape_kind": 1,
         "shape_idx": n_tri - 2 + k}
        for k in range(2)
    ] + [{"kind": jlt.UNIFORM_INFINITE, "spectrum": jfilm.colorspace.illuminant,
          "photometric": True, "scale": 0.3}]
    return jax_build_scene(
        triangles=jscene.triangles,
        materials=bench_scene.material_bench_materials(variant),
        lights=lights,
        spectra_table=bench_scene.material_bench_spectra(),
        render_from_world=jcam.camera_transform.render_from_world(),
    )


@pytest.fixture(scope="module")
def material_renders(scenes):
    """Per variant: the reference's image, rays and iterations, and the
    port's scenes from both table builders."""
    jscene, jcam, jfilm = scenes["jax"]
    blocks, valids = jax_blocks(jfilm, RES[0] * RES[1])
    jitted = None
    out = {}
    for variant in bench_scene.MATERIAL_VARIANTS:
        jm = _jax_material_scene(scenes, variant)
        if jitted is None:
            wave = jax_wavefront(jm, jcam, jfilm, JaxZSobol(SPP, RES), max_depth=DEPTH,
                                 with_stats=True)
            # The wave function's jitted body takes the scene as a traced
            # argument; the variants share one census, so they share one
            # compile through it.
            jitted = inspect.getclosurevars(wave).nonlocals["_wave"]
        state, stats = jitted(jm, jfilm.init_state(), jnp.arange(SPP, dtype=jnp.uint32),
                              blocks[0], valids[0])
        arrays, census = jax_scene_to_numpy(jm)
        out[variant] = {
            "ref": (np.asarray(jfilm.get_image(state)), float(stats["rays"])),
            "converted": scene_from_numpy(arrays, census, device="cpu"),
            "torch": bench_scene.build_material_bench_scene(N_TRIS, RES, variant, device="cpu")[0],
        }
    return out


@pytest.mark.parametrize("tables", ["converted", "torch"])
@pytest.mark.parametrize("variant", list(bench_scene.MATERIAL_VARIANTS))
def test_material_slice_matches_reference(scenes, material_renders, variant, tables):
    """Every material kind of the dispatch, rendered: conductor, dielectric
    (spectral and constant eta), thin dielectric, both coats and the mix."""
    ref, rays = material_renders[variant]["ref"]
    tscene = material_renders[variant][tables]
    _, tcam, tfilm = scenes["torch"]
    assert tscene.materials.has_dispersion and tscene.spectra_table is not None
    wave = torch_wavefront(tscene, tcam, tfilm, TorchZSobol(SPP, RES), max_depth=DEPTH)
    blocks, valids = torch_blocks(tfilm, RES[0] * RES[1], device="cpu")
    state, stats = wave(tfilm.init_state("cpu"), torch.arange(SPP), blocks[0], valids[0])
    assert float(stats["rays"]) == rays
    assert_images_agree(tfilm.get_image(state).numpy(), ref)

