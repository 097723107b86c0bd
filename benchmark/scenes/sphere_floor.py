"""The bench scene (``scene: sphere_floor``): a displaced, subdivided
icosphere above a floor quad, lit by an emissive quad (two area-light
triangles) and a uniform infinite light, from the benchmark's own copy
of the bench-scene generator.  Both sides build their tables (BVH,
material table, spectra) themselves from the same arrays.
"""

from __future__ import annotations

import numpy as np

from benchmark.scene import camera_film


def make_displaced_sphere(n_tris_target: int):
    """Subdivided icosahedron (smallest 20*4^k >= target) with multi-octave
    sinusoidal displacement.  Returns (verts f32, faces i32)."""
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


def geometry(config: dict) -> dict:
    """The arrays both sides build from: the sphere's (verts, faces) and
    the floor's and light's quad corners."""
    g = config["geometry"]
    verts, faces = make_displaced_sphere(int(g["sphere_tris"]))
    return {"sphere": (verts, faces), "floor": g["floor"], "light_quad": g["light_quad"]}


def _material(api, m: dict) -> dict:
    out = dict(m)
    out["kind"] = getattr(api.material, m["kind"].upper())
    return out


def build(api, config: dict, geom: dict, device):
    cam, film, cs = camera_film(api, config)
    r2w = cam.camera_transform.render_from_world()
    verts, faces = geom["sphere"]
    meshes = [
        api.mesh.TriangleMesh(r2w, faces, verts).as_scene_dict(0),
        api.mesh.quad_mesh(r2w, *geom["floor"]).as_scene_dict(1),
        api.mesh.quad_mesh(r2w, *geom["light_quad"]).as_scene_dict(
            2, area_light_id=np.array([0, 1], np.int32)),
    ]
    tris = api.triangle.build_triangle_scene(meshes, device=device)
    n_tri_total = int(tris.orig_indices.shape[0])
    lt = config["lights"]
    lights = [
        {"kind": api.lights.AREA, "spectrum": api.spectrum.ConstantSpectrum(lt["area_radiance"]),
         "scale": float(lt["area_scale"]), "shape_kind": api.lights.TRIANGLE_SHAPE,
         "shape_idx": n_tri_total - 2 + k}
        for k in range(2)
    ] + [{"kind": api.lights.UNIFORM_INFINITE, "spectrum": cs.illuminant, "photometric": True,
          "scale": float(lt["infinite_scale"])}]
    spectra = config.get("spectra") or []
    table = (np.stack([api.spectrum.named_spectrum(n).to_dense() for n in spectra])
             if spectra else None)
    scene = api.scene_builder.build_scene(
        tris, materials=[_material(api, m) for m in config["materials"]], lights=lights,
        spectra_table=table, device=device)
    return scene, cam, film

