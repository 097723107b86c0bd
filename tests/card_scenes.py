"""The scene files of the card tests, written in code: the bench scene
through the loader (``loaded``), with textures and an image environment
light (``textured``), with delta lights and homogeneous media (``media``),
with bilinear patches and two-level instances (``instanced``), the parser
tests' small scenes (``PARSER_SCENES``) and the feature scenes of the
samplers, filters, cameras, render spaces and color spaces
(``FEATURE_SCENES``).  Each is written at the small size the card tests
render, beside the bench sphere's mesh as a binary PLY (``write_ply``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from card_checks import MAX_DEPTH, SMALL_RES, SMALL_SPP
from shimmer_tpu_torch.film.image import Image

LOADED_PLY = "bench_sphere.ply"


def write_ply(path: Path, verts: np.ndarray, faces: np.ndarray):
    """Binary little-endian PLY: float32 x y z, uchar-counted int32 faces."""
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    face_rows = np.zeros(len(faces), np.dtype([("n", "u1"), ("v", "<i4", 3)]))
    face_rows["n"] = 3
    face_rows["v"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        f.write(face_rows.tobytes())


def loaded_scene_text(res, spp: int) -> str:
    """The bench scene as a pbrt-v4 file: the bench camera, the sphere
    mesh from the PLY, the floor, the emissive quad and the infinite
    light, with three analytic spheres beside the mesh."""
    return f"""# The bench scene of bench.py as a scene file, with three analytic spheres.
LookAt 0 0.6 -3.2  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]
Sampler "zsobol" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{MAX_DEPTH}]
PixelFilter "box"
WorldBegin
LightSource "infinite" "float scale" [0.3]
Material "diffuse" "rgb reflectance" [0.55 0.45 0.35]
Shape "plymesh" "string filename" "{LOADED_PLY}"
Material "diffuse" "rgb reflectance" [0.4 0.4 0.42]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-8 -1.3 -8  8 -1.3 -8  8 -1.3 8  -8 -1.3 8]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [15 15 15]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-1 4 -1  1 4 -1  1 4 1  -1 4 1]
AttributeEnd
AttributeBegin
  Material "dielectric" "float eta" [1.5]
  Translate -1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
      "float roughness" [0.08]
  Translate 1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [40 36 30]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Translate 0.6 1.5 -1.4
  Shape "sphere" "float radius" [0.12]
AttributeEnd
"""

# The textures are written as PFM (the card's machine has no PIL) with few
# colors at every MIP level, so the host's RGB fit (one fit per unique
# color) stays short: a checker with power-of-two cells (two colors, then
# their average), a gray sky (every gray texel fits as one color, whatever
# its brightness) with a warm sun, and two-color stripes.
CHECKER_RES, ROUGH_RES, SKY_SHAPE = 2048, 1024, (1024, 2048)
SKY_LEVELS = 200


def write_texture_files(d: Path):
    """The textured scene's images: checker.pfm (2048^2 RGB), rough.pfm (1024^2
    float), stripes.pfm (256x64 RGB), bumps.pfm (512^2 float), amount.pfm
    (256^2 float) and sky.pfm (2048x1024 lat-long, at most SKY_LEVELS + 1
    colors)."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:CHECKER_RES, 0:CHECKER_RES]
    cell = ((xx // 64 + yy // 64) % 2).astype(bool)
    checker = np.where(cell[..., None], np.float32([0.8, 0.75, 0.7]),
                       np.float32([0.15, 0.2, 0.3])).astype(np.float32)
    Image(checker).write(d / "checker.pfm")
    yy, xx = np.mgrid[0:ROUGH_RES, 0:ROUGH_RES] / ROUGH_RES
    rough = 0.05 + 0.2 * (1.0 + np.sin(40.0 * xx) * np.cos(23.0 * yy))
    Image(rough.astype(np.float32)).write(d / "rough.pfm")
    stripes = np.where((np.arange(256) // 16 % 2).astype(bool)[None, :, None],
                       np.float32([0.7, 0.2, 0.1]), np.float32([0.1, 0.3, 0.6]))
    Image(np.broadcast_to(stripes, (64, 256, 3)).astype(np.float32)).write(d / "stripes.pfm")
    Image(rng.uniform(0.0, 1.0, (512, 512)).astype(np.float32)).write(d / "bumps.pfm")
    Image(rng.uniform(0.0, 1.0, (256, 256)).astype(np.float32)).write(d / "amount.pfm")
    h, w = SKY_SHAPE
    theta = (np.arange(h) + 0.5) / h * np.pi
    level = np.round((0.15 + 0.85 * np.sin(theta) ** 4) * SKY_LEVELS) / SKY_LEVELS
    sky = np.repeat(np.repeat(level[:, None, None], w, 1), 3, 2).astype(np.float32) * 0.8
    yy, xx = np.mgrid[0:h, 0:w]
    sun = (yy - 0.3 * h) ** 2 + (xx - 0.6 * w) ** 2 < (0.015 * h) ** 2
    sky[sun] = [40.0, 32.0, 22.0]
    Image(sky).write(d / "sky.pfm")


def textured_scene_text(res, spp: int) -> str:
    """The loaded scene with textures and an image environment light
    in place of the uniform one: the floor a 2048^2 checker (trilinear,
    uv), the mesh a coated diffuse with cylindrical stripes and a bump
    map, the gold sphere's roughness a 1024^2 EWA map through a scale
    texture, the glass sphere a mix of that gold and a direction-mix
    diffuse with a textured amount."""
    return f"""# The loaded scene with textures and an image environment light.
LookAt 0 0.6 -3.2  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]
Sampler "zsobol" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{MAX_DEPTH}]
PixelFilter "box"
WorldBegin
AttributeBegin
  Rotate -90 1 0 0
  LightSource "infinite" "string filename" "sky.pfm" "float scale" [0.6]
AttributeEnd
Texture "checks" "spectrum" "imagemap" "string filename" "checker.pfm"
    "string filter" "trilinear" "float uscale" [4] "float vscale" [4]
Texture "rough" "float" "imagemap" "string filename" "rough.pfm" "string filter" "ewa"
Texture "half" "float" "constant" "float value" [0.5]
Texture "gold_rough" "float" "scale" "texture tex" "rough" "texture scale" "half"
Texture "stripes" "spectrum" "imagemap" "string filename" "stripes.pfm"
    "string mapping" "cylindrical" "string filter" "bilinear"
Texture "bumps" "float" "imagemap" "string filename" "bumps.pfm" "float scale" [0.002]
Texture "amount" "float" "imagemap" "string filename" "amount.pfm" "string filter" "bilinear"
Texture "tint" "spectrum" "directionmix" "rgb tex1" [0.7 0.2 0.2] "rgb tex2" [0.2 0.3 0.8]
    "vector3 dir" [0 1 0]
MakeNamedMaterial "gold" "string type" "conductor" "spectrum eta" "metal-Au-eta"
    "spectrum k" "metal-Au-k" "texture roughness" "gold_rough"
MakeNamedMaterial "tinted" "string type" "diffuse" "texture reflectance" "tint"
Material "coateddiffuse" "texture reflectance" "stripes" "texture displacement" "bumps"
    "float roughness" [0.05]
Shape "plymesh" "string filename" "{LOADED_PLY}"
Material "diffuse" "texture reflectance" "checks"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-8 -1.3 -8  8 -1.3 -8  8 -1.3 8  -8 -1.3 8] "point2 uv" [0 0 1 0 1 1 0 1]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [15 15 15]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-1 4 -1  1 4 -1  1 4 1  -1 4 1]
AttributeEnd
AttributeBegin
  Material "mix" "string materials" ["gold" "tinted"] "texture amount" "amount"
  Translate -1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  NamedMaterial "gold"
  Translate 1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [40 36 30]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Translate 0.6 1.5 -1.4
  Shape "sphere" "float radius" [0.12]
AttributeEnd
"""


FOG_SIGMA_A, FOG_SIGMA_S = 0.03, 0.12
# The box (half-width 1.15, turned 45 degrees about y, so that the glass
# and gold spheres stay outside it) and its faces, outward.
BOX_LO, BOX_HI = (-1.15, -1.25, -1.15), (1.15, 1.2, 1.15)
_BOX_FACES = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]
MEDIA_VARIANTS = ("interface", "exterior", "delta")


def box_mesh_text(lo, hi) -> str:
    """A 12-triangle box with outward normals as a trianglemesh."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    p = np.array([[hi[0] if i & 1 else lo[0], hi[1] if i & 2 else lo[1],
                   hi[2] if i & 4 else lo[2]] for i in range(8)])
    idx = []
    for a, b, c, d in _BOX_FACES:
        for tri in ((a, b, c), (a, c, d)):
            n = np.cross(p[tri[1]] - p[tri[0]], p[tri[2]] - p[tri[0]])
            outward = n @ (p[list(tri)].mean(0) - (lo + hi) / 2) > 0
            idx.extend(tri if outward else tri[::-1])
    pts = " ".join(f"{x:g}" for x in p.ravel())
    return (f'Shape "trianglemesh" "integer indices" [{" ".join(map(str, idx))}]\n'
            f'      "point3 P" [{pts}]')


def media_scene_text(res, spp: int, variant: str = "interface") -> str:
    """The loaded scene with a point, a spot and a distant light; the
    ``interface`` variant in an exterior fog with the smoke box around the
    bench sphere, ``exterior`` in the fog alone, ``delta`` without media."""
    fog = variant in ("interface", "exterior")
    media = f"""MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [{FOG_SIGMA_A} {FOG_SIGMA_A} {FOG_SIGMA_A}]
    "rgb sigma_s" [{FOG_SIGMA_S} {FOG_SIGMA_S} {FOG_SIGMA_S}] "float g" [0.2]
MakeNamedMedium "smoke" "string type" "homogeneous" "rgb sigma_a" [0.15 0.2 0.3]
    "rgb sigma_s" [0.9 0.9 0.9] "float g" [0.6]
MediumInterface "" "fog"
""" if fog else ""
    box = f"""AttributeBegin
  Rotate 45 0 1 0
  MediumInterface "smoke" "fog"
  Material "interface"
  {box_mesh_text(BOX_LO, BOX_HI)}
AttributeEnd
""" if variant == "interface" else ""
    return f"""# The loaded scene with delta lights ({variant}).
{media}LookAt 0 0.6 -3.2  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]
Sampler "zsobol" "integer pixelsamples" [{spp}]
Integrator "volpath" "integer maxdepth" [{MAX_DEPTH}]
PixelFilter "box"
WorldBegin
{'MediumInterface "" ""' if fog else ""}
LightSource "infinite" "float scale" [0.3]
LightSource "point" "point3 from" [-2 2.5 -2] "rgb I" [10 10 10]
LightSource "spot" "point3 from" [2.5 3.5 -2.5] "point3 to" [0 0 0] "blackbody I" [3000]
    "float coneangle" [25] "float conedeltaangle" [5] "float scale" [30]
LightSource "distant" "point3 from" [0 1 0] "point3 to" [-0.3 0 0.2] "rgb L" [1.5 1.4 1.2]
Material "diffuse" "rgb reflectance" [0.55 0.45 0.35]
Shape "plymesh" "string filename" "{LOADED_PLY}"
Material "diffuse" "rgb reflectance" [0.4 0.4 0.42]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-8 -1.3 -8  8 -1.3 -8  8 -1.3 8  -8 -1.3 8]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [15 15 15]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-1 4 -1  1 4 -1  1 4 1  -1 4 1]
AttributeEnd
{box}AttributeBegin
  Material "dielectric" "float eta" [1.5]
  Translate -1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
      "float roughness" [0.08]
  Translate 1.55 -0.8 -0.9
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [40 36 30]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Translate 0.6 1.5 -1.4
  Shape "sphere" "float radius" [0.12]
AttributeEnd
"""


N_INSTANCES = 24
WALL_GRID = 4   # the back wall's patches a side
# tests/test_parser.py::TestCreate::test_instanced_scene_renders and
# ::TestBilinearMesh::test_bilinearmesh_parses_to_patches at their in-file
# sizes, with the zsobol sampler in place of the independent one.
PARSER_SCENES = {
    "test_instanced_scene_renders": """
Film "rgb" "integer xresolution" [12] "integer yresolution" [12]
Sampler "zsobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
Camera "perspective" "float fov" [50]
WorldBegin
Material "diffuse" "rgb reflectance" [0.6 0.6 0.6]
ObjectBegin "blade"
  Shape "trianglemesh"
    "integer indices" [0 1 2  0 2 3]
    "point3 P" [-0.4 0 2  0.4 0 2  0.4 0.8 2  -0.4 0.8 2]
ObjectEnd
ObjectInstance "blade"
Translate 1 0 0
ObjectInstance "blade"
Translate -2 0 0
ObjectInstance "blade"
LightSource "infinite" "rgb L" [0.5 0.5 0.5]
""",
    "test_bilinearmesh_parses_to_patches": """
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
Sampler "zsobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
Camera "perspective" "float fov" [45]
WorldBegin
Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
Shape "bilinearmesh"
    "integer indices" [0 1 2 3]
    "point3 P" [-1 -1 2   1 -1 2   -1 1 2   1 1 2]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Shape "bilinearmesh"
      "integer indices" [0 1 2 3]
      "point3 P" [-0.5 2 -0.5  0.5 2 -0.5  -0.5 2 0.5  0.5 2 0.5]
AttributeEnd
LightSource "infinite" "rgb L" [0.2 0.2 0.2]
""",
}


def instance_placements() -> list[tuple[float, float, float, float]]:
    """(x, z, scale, degrees about y) of the 24 balls: two rings around
    the bench sphere, on an arc that leaves the camera's side open."""
    out = []
    for i in range(N_INSTANCES):
        r = 1.9 if i % 2 == 0 else 2.8
        theta = np.deg2rad(-130.0 + i * 260.0 / (N_INSTANCES - 1))
        scale = 0.15 + 0.2 * ((7 * i) % N_INSTANCES) / (N_INSTANCES - 1)
        out.append((r * np.sin(theta), r * np.cos(theta), scale, 15.0 * i))
    return out


def wall_patch_text() -> str:
    """The back wall: a WALL_GRID x WALL_GRID bilinearmesh whose vertices
    alternate 0.3 in front of and behind z = 3.2, so every patch is
    twisted, with uvs over the grid."""
    k = WALL_GRID + 1
    pts, uvs, idx = [], [], []
    for j in range(k):
        for i in range(k):
            pts.append((-4.5 + 9.0 * i / WALL_GRID, -1.3 + 4.5 * j / WALL_GRID,
                        3.2 + 0.3 * (-1) ** (i + j)))
            uvs.append((i / WALL_GRID, j / WALL_GRID))
    for j in range(WALL_GRID):
        for i in range(WALL_GRID):
            v = j * k + i
            idx.extend((v, v + 1, v + k, v + k + 1))
    return (f'Shape "bilinearmesh" "integer indices" [{" ".join(map(str, idx))}]\n'
            f'      "point3 P" [{" ".join(f"{x:g}" for p in pts for x in p)}]\n'
            f'      "point2 uv" [{" ".join(f"{x:g}" for p in uvs for x in p)}]')


def instanced_scene_text(res, spp: int) -> str:
    """The loaded scene's camera, infinite light and bench sphere (world
    triangles), 24 instances of an object holding the same PLY and a
    small glass sphere, a planar patch floor, a twisted patch wall under a
    conductor, and a patch quad light beside the triangle quad light."""
    instances = "\n".join(
        f"AttributeBegin\n  Translate {x:.4f} {-1.3 + s:.4f} {z:.4f}\n  Rotate {a:g} 0 1 0\n"
        f"  Scale {s:.4f} {s:.4f} {s:.4f}\n  ObjectInstance \"ball\"\nAttributeEnd"
        for x, z, s, a in instance_placements())
    return f"""# The loaded scene with instances, patches and a patch light.
LookAt 0 0.6 -3.2  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]
Sampler "zsobol" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{MAX_DEPTH}] "string lightsampler" "power"
PixelFilter "box"
WorldBegin
LightSource "infinite" "float scale" [0.3]
Material "diffuse" "rgb reflectance" [0.55 0.45 0.35]
Shape "plymesh" "string filename" "{LOADED_PLY}"
ObjectBegin "ball"
  Material "diffuse" "rgb reflectance" [0.3 0.5 0.6]
  Shape "plymesh" "string filename" "{LOADED_PLY}"
  AttributeBegin
    Material "dielectric" "float eta" [1.5]
    Translate 0 1.45 0
    Shape "sphere" "float radius" [0.3]
  AttributeEnd
ObjectEnd
{instances}
Material "diffuse" "rgb reflectance" [0.4 0.4 0.42]
Shape "bilinearmesh" "integer indices" [0 1 2 3]
    "point3 P" [-8 -1.3 -8  8 -1.3 -8  -8 -1.3 8  8 -1.3 8]
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Cu-eta" "spectrum k" "metal-Cu-k"
      "float roughness" [0.1]
  {wall_patch_text()}
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [15 15 15]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-1 4 -1  1 4 -1  1 4 1  -1 4 1]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [20 18 15]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "bilinearmesh" "integer indices" [0 1 2 3]
      "point3 P" [-2.2 3 -0.6  -1.2 3 -0.6  -2.2 3 0.4  -1.2 3 0.4]
AttributeEnd
"""


# The feature scenes, each holding the features its name lists:
# (before Camera, Camera, Sampler, PixelFilter, extra Film parameters).
FEATURE_SCENES = {
    "independent_gaussian_orthographic_screenwindow_cameraspace_rec2020": (
        'ColorSpace "rec2020"\nOption "string rendercoordsys" "camera"',
        'Camera "orthographic" "float screenwindow" [-2.4 2.4 -1.8 1.8]',
        'Sampler "independent"', 'PixelFilter "gaussian"', ""),
    "stratified_mitchell_spherical_equalarea_worldspace_iso_whitebalance": (
        'Option "string rendercoordsys" "world"',
        'Camera "spherical" "string mapping" "equalarea"',
        'Sampler "stratified"', 'PixelFilter "mitchell"',
        '"float iso" [200] "float whitebalance" [5000]'),
    "sinc_spherical_equirect_disablepixeljitter": (
        'Option "bool disablepixeljitter" true',
        'Camera "spherical" "string mapping" "equirect"',
        'Sampler "zsobol"', 'PixelFilter "sinc"', ""),
    "triangle_thinlens_screenwindow_disablewavelengthjitter": (
        'Option "bool disablewavelengthjitter" true',
        'Camera "perspective" "float fov" [45] "float lensradius" [0.08] '
        '"float focaldistance" [3.4] "float screenwindow" [-1.2 1.1 -0.8 0.9]',
        'Sampler "zsobol"', 'PixelFilter "triangle"', ""),
}


def feature_scene_text(case: str) -> str:
    """A small scene (floor, quad light, diffuse, glass and rough gold
    spheres, a sky) under one FEATURE_SCENES case, at SMALL_RES and
    SMALL_SPP."""
    before, camera, sampler, pixel_filter, film = FEATURE_SCENES[case]
    return f"""# Feature scene: {case}.
{before}
LookAt 0 0.9 -3.4  0 0.3 0  0 1 0
{camera}
Film "rgb" "integer xresolution" [{SMALL_RES[0]}] "integer yresolution" [{SMALL_RES[1]}] {film}
{sampler} "integer pixelsamples" [{SMALL_SPP}]
{pixel_filter}
Integrator "path" "integer maxdepth" [{MAX_DEPTH}]
WorldBegin
LightSource "infinite" "rgb L" [0.25 0.27 0.3]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [12 12 12]
  Material "diffuse" "rgb reflectance" [0 0 0]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point3 P" [-0.8 3 -0.8  0.8 3 -0.8  0.8 3 0.8  -0.8 3 0.8]
AttributeEnd
Material "diffuse" "rgb reflectance" [0.5 0.45 0.4]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-6 0 -6  6 0 -6  6 0 6  -6 0 6]
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.7 0.2 0.15]
  Translate -0.9 0.5 0.2
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Material "dielectric" "float eta" [1.5]
  Translate 0.2 0.45 -0.4
  Shape "sphere" "float radius" [0.45]
AttributeEnd
AttributeBegin
  Material "conductor" "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
      "float roughness" [0.15]
  Translate 1.1 0.5 0.5
  Shape "sphere" "float radius" [0.5]
AttributeEnd
"""
