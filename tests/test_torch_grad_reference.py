"""tests/test_grad.py::TestGradients' cases in the port against the
reference: the port's value and AD against the reference's
``jax.value_and_grad`` run op by op, at 8x8, 2 spp, depth 2, within rtol
1e-3 (tests/torch_grad.py says why this size and why op by op).  The
texture's two parameters (one texel, the whole atlas shifted) go through
one pass, the texel set to its value plus the shift.  A fifth case holds
a scene with interreflection, where Russian roulette matters."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import dataclasses

import pytest
import torch

from torch_grad import (CASES, SMALL, ad_vs_reference, case_scenes, check_sign, jax_camera,
                        jax_film, jax_mean_radiance, port_camera, port_film, port_mean_radiance,
                        replace, set_entry)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["diffuse_reflectance", "emission_scale", "conductor_roughness"])
def test_ad_matches_reference(name):
    case = CASES[name]
    jscene, scene = case_scenes(name)
    (g,) = ad_vs_reference(case.port_f(scene, jscene, *SMALL), case.jax_f(jscene, *SMALL),
                           case.theta0(jscene))
    check_sign(case, g)


def test_texture_ad_matches_reference():
    texel_case, atlas_case = CASES["texture_texel"], CASES["texture_whole_atlas"]
    jscene, scene = case_scenes("texture_texel")
    res, spp, depth = SMALL
    cam, film = port_camera(jax_camera(res)), port_film(res)
    jcam, jfilm = jax_camera(res), jax_film(res)
    texel, rows = texel_case.entry(jscene), atlas_case.entry(jscene)

    def f(t, shift):
        atlas = set_entry(scene.textures.atlas, rows, shift, add=True)
        atlas = set_entry(atlas, texel, t + shift)
        return port_mean_radiance(replace(scene, "textures", atlas=atlas), cam, film, spp, depth)

    def jf(t, shift):
        atlas = jscene.textures.atlas.at[rows].add(shift).at[texel].set(t + shift)
        texs = dataclasses.replace(jscene.textures, atlas=atlas)
        return jax_mean_radiance(dataclasses.replace(jscene, textures=texs), jcam, jfilm, spp,
                                 depth)

    g_texel, g_all = ad_vs_reference(f, jf, texel_case.theta0(jscene), 0.0)
    check_sign(texel_case, g_texel)
    check_sign(atlas_case, g_all)


def test_interreflection_ad_matches_reference():
    """tests/test_grad.py's triangle scene (a displaced grid over a floor
    under a quad light): light bounces between the grid and the floor, so
    Russian roulette (from the second bounce on) decides paths that carry
    light, and its detached survival probability matters (at depth 3, one
    more than the other cases, so a path can go grid, floor, grid).  The
    spheres above are convex: their second bounce always escapes."""
    import dataclasses

    import test_grad
    from shimmer_tpu.cameras import PerspectiveCamera as JaxPerspective
    from torch_grad import jax_film, port_camera, port_scene
    from torch_parity import ensure_reference_sah

    ensure_reference_sah()
    jscene, jcam64, _ = test_grad.TestProductionScaleGradients._tri_scene()
    res, spp, depth = SMALL
    jcam = JaxPerspective(jcam64.camera_transform, (res, res), fov=42.0)
    scene, cam, film = port_scene(jscene), port_camera(jcam, fov=42.0), port_film(res)

    def f(theta):
        refl = set_entry(scene.materials.reflectance, (0, 1), theta)
        return port_mean_radiance(replace(scene, "materials", reflectance=refl), cam, film, spp,
                                  depth + 1)

    def jf(theta):
        mats = dataclasses.replace(
            jscene.materials, reflectance=jscene.materials.reflectance.at[0, 1].set(theta))
        return jax_mean_radiance(dataclasses.replace(jscene, materials=mats), jcam,
                                 jax_film(res), spp, depth + 1)

    (g,) = ad_vs_reference(f, jf, float(scene.materials.reflectance[0, 1]))
    assert abs(g) > 1e-6
