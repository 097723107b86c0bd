"""The bench scene of ``bench.py``, built with the port.

A subdivided, displaced icosphere (327,680 triangles at the bench size)
above a floor quad, lit by an emissive quad and a uniform infinite light,
seen by a 40-degree perspective camera; three diffuse materials.  The
geometry generator is ``bench.py::make_displaced_sphere``, repeated here
so that the port and ``chip_smoke.py`` do not import the reference's
benchmark script (tests hold the two generators equal).

Two legs, as in ``bench.py``: ``bench`` (``BENCH_TRIS``, the main render)
and ``large`` (``LARGE_TRIS`` = 1,310,720 sphere triangles, the leg of
``bench.py::streaming_benchmark``, whose BVH8 table of about 157 MB no
longer fits the H100's 50 MB L2).

The material bench scene (``build_material_bench_scene``) is the same
geometry and lights with the material kinds of the wavefront's dispatch,
built in code from the named IOR spectra: by default the sphere is a mix
of rough gold and dispersive BK7 glass and the floor a coated diffuse;
its other variants put the table's other rows on the sphere and floor.
"""

from __future__ import annotations

import numpy as np

from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.scene_builder import build_scene
from shimmer_tpu_torch.shapes.mesh import TriangleMesh, quad_mesh
from shimmer_tpu_torch.shapes.triangle import build_triangle_scene
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum, named_spectrum

BENCH_TRIS = 300_000
LARGE_TRIS = 1_310_720
BENCH_RESOLUTION = (1280, 720)


def make_displaced_sphere(n_tris_target: int):
    """Subdivided icosahedron (smallest 20*4^k >= target) with
    multi-octave sinusoidal displacement.  Returns (verts f32, faces i32)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    while faces.shape[0] < n_tris_target:
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        e_sorted = np.sort(e, axis=1)
        keys = e_sorted[:, 0] * (1 << 32) + e_sorted[:, 1]
        _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
        mid_idx = len(verts) + inv
        new_verts = 0.5 * (verts[e_sorted[:, 0]] + verts[e_sorted[:, 1]])[first]
        new_verts /= np.linalg.norm(new_verts, axis=1, keepdims=True)
        nf = len(faces)
        m01, m12, m20 = mid_idx[:nf], mid_idx[nf : 2 * nf], mid_idx[2 * nf :]
        f = faces
        faces = np.concatenate(
            [
                np.stack([f[:, 0], m01, m20], 1),
                np.stack([f[:, 1], m12, m01], 1),
                np.stack([f[:, 2], m20, m12], 1),
                np.stack([m01, m12, m20], 1),
            ]
        )
        verts = np.concatenate([verts, new_verts])
    p = verts
    disp = (
        0.12 * np.sin(7.0 * p[:, 0]) * np.sin(9.0 * p[:, 1])
        + 0.06 * np.sin(17.0 * p[:, 2] + 1.3) * np.cos(13.0 * p[:, 0])
        + 0.03 * np.sin(31.0 * p[:, 1] + 4.0)
    )
    verts = p * (1.0 + disp[:, None])
    return verts.astype(np.float32), faces.astype(np.int32)


def bench_camera_film(resolution=BENCH_RESOLUTION):
    cs = get_named_color_space("srgb")
    # float32 inputs, as bench.py hands look_at float32 arrays.
    eye, look, up = (
        np.array(v, np.float32) for v in ([0.0, 0.6, -3.2], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    )
    ct = CameraTransform(Transform.look_at(eye, look, up))
    cam = PerspectiveCamera(ct, resolution, fov=40.0)
    film = RgbFilm(resolution, BoxFilter(), PixelSensor(cs), cs)
    return cam, film


def bench_meshes(n_tris: int, render_from_world: Transform) -> list[dict]:
    """Mesh dicts of the bench scene, in render space."""
    verts, faces = make_displaced_sphere(n_tris)
    mesh = TriangleMesh(render_from_world, faces, verts)
    floor = quad_mesh(render_from_world, [-8, -1.3, -8], [8, -1.3, -8], [8, -1.3, 8], [-8, -1.3, 8])
    lightq = quad_mesh(
        render_from_world, [-1.0, 4.0, -1.0], [1.0, 4.0, -1.0], [1.0, 4.0, 1.0], [-1.0, 4.0, 1.0]
    )
    return [
        mesh.as_scene_dict(0),
        floor.as_scene_dict(1),
        lightq.as_scene_dict(2, area_light_id=np.array([0, 1], np.int32)),
    ]


BENCH_MATERIALS = (
    {"kind": mtl.DIFFUSE, "reflectance": [0.55, 0.45, 0.35]},
    {"kind": mtl.DIFFUSE, "reflectance": [0.4, 0.4, 0.42]},
    {"kind": mtl.DIFFUSE, "reflectance": [0.0, 0.0, 0.0]},
)


def bench_lights(n_tri_total: int, colorspace) -> list[dict]:
    """Two area-light triangles (the emissive quad, the last two
    triangles) and a photometric uniform infinite light."""
    return [
        {
            "kind": lt.AREA,
            "spectrum": ConstantSpectrum(1.0),
            "scale": 15.0,
            "shape_kind": lt.TRIANGLE_SHAPE,
            "shape_idx": n_tri_total - 2 + k,
        }
        for k in range(2)
    ] + [
        {
            "kind": lt.UNIFORM_INFINITE,
            "spectrum": colorspace.illuminant,
            "photometric": True,
            "scale": 0.3,
        }
    ]


# Rows of the material bench scene's dense spectra table.
MATERIAL_SPECTRA = ("metal-Au-eta", "metal-Au-k", "glass-BK7", "metal-Cu-eta", "metal-Cu-k")
_GOLD = {"kind": mtl.CONDUCTOR, "eta_spec": 0, "k_spec": 1, "uroughness": 0.08,
         "vroughness": 0.08}
_BK7 = {"kind": mtl.DIELECTRIC, "eta_spec": 2}
_COATED_COPPER = {"kind": mtl.COATED_CONDUCTOR, "eta_spec": 3, "k_spec": 4, "eta_float": 1.5,
                  "uroughness": 0.05, "vroughness": 0.05, "bot_uroughness": 0.1,
                  "bot_vroughness": 0.1, "thickness": 0.01}
_THIN = {"kind": mtl.THIN_DIELECTRIC, "eta_float": 1.5}
_ROUGH_GLASS = {"kind": mtl.DIELECTRIC, "eta_float": 1.5, "uroughness": 0.1, "vroughness": 0.1}
_COATED_DIFFUSE = {"kind": mtl.COATED_DIFFUSE, "reflectance": [0.4, 0.4, 0.42],
                   "eta_float": 1.5, "thickness": 0.01}
_GOLD_GLASS_MIX = {"kind": mtl.MIX, "mix_amount": 0.5, "mix_m1": 3, "mix_m2": 4}
# Rows 2-9 of its material table; rows 0 (the sphere) and 1 (the floor)
# depend on the variant.  Every variant's table holds every kind, so the
# variants share one census.
_MATERIAL_ROWS = (BENCH_MATERIALS[2], _GOLD, _BK7, _COATED_COPPER, _THIN, _ROUGH_GLASS,
                  _GOLD_GLASS_MIX, _COATED_DIFFUSE)
# Variant -> (sphere, floor).
MATERIAL_VARIANTS = {
    "mix": (_GOLD_GLASS_MIX, _COATED_DIFFUSE),
    "dispersive": (_BK7, _ROUGH_GLASS),
    "coated": (_COATED_COPPER, _THIN),
}


def material_bench_spectra() -> np.ndarray:
    """(5, 471) float32 dense table of ``MATERIAL_SPECTRA``."""
    return np.stack([named_spectrum(name).to_dense() for name in MATERIAL_SPECTRA])


def material_bench_materials(variant: str = "mix") -> list[dict]:
    """Material dicts of the material bench scene: the variant's sphere
    and floor, then the light and the rows every variant carries (a rough
    gold conductor, smooth BK7 glass, a coated conductor over copper, a
    thin dielectric, a rough constant-eta dielectric, the gold / glass mix
    and a coated diffuse)."""
    sphere, floor = MATERIAL_VARIANTS[variant]
    return [dict(m) for m in (sphere, floor, *_MATERIAL_ROWS)]


def _build(n_tris, resolution, materials, spectra_table, device):
    cam, film = bench_camera_film(resolution)
    r2w = cam.camera_transform.render_from_world()
    tris = build_triangle_scene(bench_meshes(n_tris, r2w), device=device)
    n_tri_total = int(tris.orig_indices.shape[0])
    scene = build_scene(
        tris,
        materials=materials,
        lights=bench_lights(n_tri_total, film.colorspace),
        spectra_table=spectra_table,
    )
    return scene, cam, film


def build_bench_scene(n_tris: int = BENCH_TRIS, resolution=BENCH_RESOLUTION, device=None):
    """Returns (scene, camera, film) with the tables on ``device`` (default:
    the CUDA card), packed for ``TraverseConfig()``; another configuration
    is ``scene.triangles.with_traverse(cfg)``."""
    return _build(n_tris, resolution, [dict(m) for m in BENCH_MATERIALS], None, device)


def build_material_bench_scene(n_tris: int = BENCH_TRIS, resolution=BENCH_RESOLUTION,
                               variant: str = "mix", device=None):
    """The bench geometry and lights with ``material_bench_materials(variant)``
    over ``material_bench_spectra()``.  Returns (scene, camera, film) as
    ``build_bench_scene`` does."""
    return _build(n_tris, resolution, material_bench_materials(variant),
                  material_bench_spectra(), device)
