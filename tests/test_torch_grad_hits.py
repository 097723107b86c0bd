"""``differentiable_hits`` in the port (a case the reference has no test
of): the gradient of the mean radiance with respect to the height of one
corner of a floor quad.  The quad's outer edges stay out of view and its
diagonal does not move (the corner is not on it), so the mean is smooth
in the height.  A point light above the floor and a dim uniform
environment light it: neither has an edge that a reflected ray could
cross as the floor tilts (an area light's would put a boundary term into
the finite difference that AD through detached visibility does not
have).  The scene is built by the reference with
``build_triangle_scene(..., differentiable_hits=True)`` and carried
across with ``scene_from_numpy``.

- The port's AD against its central finite difference (h 1e-2, rtol
  2e-2) at 12x12, 32 spp, depth 3, and nonzero.
- The port's value and AD against the reference's op by op at 8x8, 2 spp,
  depth 2, within rtol 1e-3 (tests/torch_grad.py).
- With the flag off the hit rebuild reads the attribute rows on a
  detached ray, so no gradient reaches the vertex pool, and the forward
  value is the same bits.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import dataclasses

import numpy as np
import pytest
import torch

from shimmer_tpu.color.colorspace import get_named_color_space as jax_colorspace
from shimmer_tpu.lights import lights as jlt
from shimmer_tpu.materials import material as jmtl
from shimmer_tpu.scene_builder import build_scene as jax_build_scene
from shimmer_tpu.shapes.mesh import TriangleMesh
from shimmer_tpu.shapes.triangle import build_triangle_scene as jax_build_triangles
from shimmer_tpu.spectra.spectrum import ConstantSpectrum as JaxConstant
from torch_grad import (FD_SIZE, SMALL, ad_vs_reference, jax_camera, jax_film,
                        jax_mean_radiance, port_camera, port_film, port_mean_radiance,
                        port_scene, replace, set_entry)
from torch_parity import ensure_reference_sah

torch.set_num_threads(1)

EYE, LOOK = (0.0, 2.0, -3.0), (0.0, 0.0, 1.0)
# Vertex 1 of the floor, (10, 0, -10), behind and beside the camera; the
# triangles are (0, 1, 2) and (0, 2, 3), so the diagonal is 0-2.
VERTEX = (1, 1)


def _jax_scene(differentiable_hits, height=None):
    """The reference scene; ``height`` rebuilds it with the corner's
    render-space height moved (tables, BVH and all)."""
    r2w = jax_camera(FD_SIZE[0], EYE, LOOK).camera_transform.render_from_world()
    floor = TriangleMesh(r2w, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                         np.array([[-10, 0, -10], [10, 0, -10], [10, 0, 10], [-10, 0, 10]],
                                  np.float32)).as_scene_dict(0)
    if height is not None:
        floor["p"] = np.array(floor["p"], np.float32)
        floor["p"][VERTEX] = height
    tris = jax_build_triangles([floor], differentiable_hits=differentiable_hits)
    cs = jax_colorspace("srgb")
    return jax_build_scene(
        triangles=tris,
        materials=[{"kind": jmtl.DIFFUSE, "reflectance": [0.5, 0.45, 0.4]}],
        lights=[{"kind": jlt.POINT, "spectrum": JaxConstant(30.0), "position": (0.0, 3.0, 1.0)},
                {"kind": jlt.UNIFORM_INFINITE, "spectrum": cs.illuminant, "scale": 0.2}],
        render_from_world=r2w,
    )


@pytest.fixture(scope="module")
def scenes():
    ensure_reference_sah()
    jscene = _jax_scene(True)
    scene = port_scene(jscene)
    assert scene.triangles.differentiable_hits
    return jscene, scene


def _port_f(scene, res, spp, depth):
    cam, film = port_camera(jax_camera(res, EYE, LOOK)), port_film(res)

    def f(theta):
        p = set_entry(scene.triangles.p, VERTEX, theta)
        return port_mean_radiance(replace(scene, "triangles", p=p), cam, film, spp, depth)

    return f


def test_vertex_gradient_matches_fd(scenes):
    """The finite difference rebuilds the scene at each height: with the
    old BVH, shadow rays from a floor moved below its old plane would be
    blocked by the old floor."""
    _, scene = scenes
    theta0 = float(scene.triangles.p[VERTEX])
    res, spp, depth = FD_SIZE
    cam, film = port_camera(jax_camera(res, EYE, LOOK)), port_film(res)
    th = torch.tensor(theta0, requires_grad=True)
    (g_ad,) = torch.autograd.grad(_port_f(scene, res, spp, depth)(th), th)
    h = 1e-2
    hi, lo = (float(torch.tensor(theta0) + s * h) for s in (1, -1))
    with torch.no_grad():
        f_hi, f_lo = (port_mean_radiance(port_scene(_jax_scene(True, y)), cam, film, spp, depth)
                      for y in (hi, lo))
    g_fd = float((f_hi - f_lo) / (2.0 * h))
    assert np.isfinite(float(g_ad))
    np.testing.assert_allclose(float(g_ad), g_fd, rtol=2e-2, err_msg=f"ad={float(g_ad)} fd={g_fd}")
    assert abs(float(g_ad)) > 1e-6


def test_vertex_gradient_matches_reference(scenes):
    jscene, scene = scenes
    res, spp, depth = SMALL
    jcam, jfilm = jax_camera(res, EYE, LOOK), jax_film(res)

    def jf(theta):
        tris = dataclasses.replace(jscene.triangles, p=jscene.triangles.p.at[VERTEX].set(theta))
        return jax_mean_radiance(dataclasses.replace(jscene, triangles=tris), jcam, jfilm, spp,
                                 depth)

    (g,) = ad_vs_reference(_port_f(scene, res, spp, depth), jf, float(scene.triangles.p[VERTEX]))
    assert abs(g) > 1e-6


def test_without_the_flag_no_gradient_reaches_the_vertices(scenes):
    _, scene = scenes
    res, spp, depth = SMALL
    cam, film = port_camera(jax_camera(res, EYE, LOOK)), port_film(res)
    p = scene.triangles.p.clone().requires_grad_(True)
    plain = replace(scene, "triangles", p=p, differentiable_hits=False)
    v_plain = port_mean_radiance(plain, cam, film, spp, depth)
    assert not v_plain.requires_grad
    v_diff = port_mean_radiance(replace(scene, "triangles", p=p), cam, film, spp, depth)
    assert v_diff.requires_grad
    assert torch.equal(v_plain, v_diff.detach())


@pytest.mark.parametrize("differentiable_hits", [False, True])
def test_reintersection_detaches_the_ray_without_the_flag(scenes, differentiable_hits):
    """The hit rebuild's ray: without the flag, a hit's t, point and uv
    carry no ray gradient (the reference's stop_gradient); only wo does.
    With it, they all do.  The traversal itself never sees a ray
    that requires grad (``traverse_raw`` raises on one)."""
    from shimmer_tpu_torch.ops.traverse import traverse_raw
    from shimmer_tpu_torch.shapes.triangle import triangle_scene_intersect

    _, scene = scenes
    tris = replace(scene, "triangles", differentiable_hits=differentiable_hits).triangles
    n = 64
    ys, xs = torch.meshgrid(torch.linspace(-0.5, 0.5, 8), torch.linspace(-0.5, 0.5, 8),
                            indexing="ij")
    d = torch.stack([xs.reshape(-1), torch.full((n,), -1.0), ys.reshape(-1) + 0.5], -1)
    o = torch.zeros((n, 3)).requires_grad_(True)
    d = d.requires_grad_(True)
    si = triangle_scene_intersect(tris, o, d, torch.full((n,), torch.inf))
    assert bool(si.valid.all())
    assert si.wo.requires_grad
    for name in ("t", "p", "uv"):
        assert getattr(si, name).requires_grad == differentiable_hits, name
    with pytest.raises(ValueError, match="requires grad"):
        traverse_raw(tris, o, d.detach(), torch.full((n,), torch.inf))
