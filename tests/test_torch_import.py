"""The PyTorch port imports neither JAX nor the JAX package: every module of
shimmer_tpu_torch, the port's own copies of the host-only builders, and
the card tests (tests/test_torch_*_card.py, which run on a machine without
JAX) import in a fresh interpreter with ``jax`` and ``shimmer_tpu``
blocked, and each slice's path runs there at a small size (since the
megakernel slice: the samplers, filters, cameras, color
spaces and sensor through the megakernel and each estimator; since the
gradient slice: checkpoints, statistics, splats and a gradient through
the megakernel; since the sharding slice: the replay wavefront's
gradient, row-band and spp sharding and the sharded training step)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["shimmer_tpu"] = None
import torch
torch.set_num_threads(1)
given = {names}
# The run checks below branch on the given list, so the "package" and
# "card" cases only import: each run check belongs to the one dedicated case
# that names it.
runs = set(given) if isinstance(given, list) else set()
if given == "package":
    import shimmer_tpu_torch
    names = ["shimmer_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(shimmer_tpu_torch.__path__, "shimmer_tpu_torch.")
    ]
elif given == "card":
    import pathlib
    sys.path.insert(0, "tests")
    names = sorted(p.stem for p in pathlib.Path("tests").glob("test_torch_*_card.py"))
else:
    names = given
for name in names:
    importlib.import_module(name)
if "shimmer_tpu_torch.experiments.gather" in runs:
    # The entry point runs, not only imports: every case at a small size.
    import dataclasses
    from shimmer_tpu_torch.experiments import gather
    for case in gather.cases():
        case = dataclasses.replace(case, n_rows=case.n_rows // 256, n=max(1, case.n // 256),
                                   steps=min(case.steps, 32))
        assert gather.run_case(case, *gather.make_inputs(case, "cpu"))["ok"]
if "shimmer_tpu_torch.experiments.packet_step" in runs:
    # The entry point runs, not only imports: every case at a small size
    # (row 15 on a small scene of the port's own builder).
    import dataclasses
    from shimmer_tpu_torch import bench_scene
    from shimmer_tpu_torch.experiments import packet_step
    t = bench_scene.build_bench_scene(320, (8, 8), device="cpu")[0].triangles
    for case in packet_step.cases():
        case = dataclasses.replace(case, n_rows=256, steps=tuple(8 * (i + 1) for i in range(len(case.steps))),
                                   programs=min(case.programs, 2))
        x = packet_step.make_inputs(case, "cpu", (t.rows8, t.meta, t.stack_depth))
        assert packet_step.run_case(case, x)["ok"]
if "shimmer_tpu_torch.ops.bvh8" in runs:
    # The builders run, not only import: native SAH build and 8-wide pack.
    import numpy as np
    from shimmer_tpu_torch.ops.bvh8 import bvh8_validate, pack_bvh8
    tri = np.random.default_rng(0).random((64, 3, 3)).astype(np.float32)
    arrs = pack_bvh8(tri.min(1), tri.max(1), tri)
    assert bvh8_validate(arrs, tri.min(1), tri.max(1))
if "shimmer_tpu_torch.materials.layered" in runs:
    # The material slice runs, not only imports: every material kind
    # rendered at a small size on the CPU.
    import torch
    from shimmer_tpu_torch import bench_scene
    from shimmer_tpu_torch.render import render
    from shimmer_tpu_torch.samplers import ZSobolSampler
    for variant in bench_scene.MATERIAL_VARIANTS:
        scene, cam, film = bench_scene.build_material_bench_scene(320, (8, 8), variant, device="cpu")
        img = render(scene, cam, film, ZSobolSampler(1, (8, 8)), spp=1, max_depth=3,
                     wave_spp=1, pixel_block=64)[0]
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
if "shimmer_tpu_torch.cli" in runs:
    # The scene-file path runs, not only imports: a golden scene parsed,
    # built and rendered through the CLI at a small size on the CPU.
    import pathlib, tempfile
    from shimmer_tpu_torch import cli
    text = pathlib.Path("tests/scenes/dielectric.pbrt").read_text().replace("[64]", "[8]")
    with tempfile.TemporaryDirectory() as tmp:
        scene = pathlib.Path(tmp) / "small.pbrt"
        scene.write_text(text)
        assert cli.main([str(scene), "--spp", "1", "--device", "cpu", "-q",
                         "-o", str(pathlib.Path(tmp) / "small.pfm")]) == 0
if "shimmer_tpu_torch.textures.normal_bump" in runs:
    # The texture slice runs, not only imports: a scene with an image
    # texture (EWA), a bump map, a textured mix amount and an image
    # environment light, written as PFM files and a pbrt text, loaded and
    # rendered at a small size on the CPU.
    import pathlib, tempfile
    import numpy as np
    import torch
    from shimmer_tpu_torch.film.image import Image
    from shimmer_tpu_torch.loading.parser import parse_str
    from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
    from shimmer_tpu_torch.render import render
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        Image(rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)).write(d / "albedo.pfm")
        Image(rng.uniform(0, 1, (8, 8)).astype(np.float32)).write(d / "gray.pfm")
        Image(rng.uniform(0.1, 2, (8, 16, 3)).astype(np.float32)).write(d / "sky.pfm")
        text = (
            'LookAt 0 2 -4  0 0 0  0 1 0\\nCamera "perspective"\\n'
            'Film "rgb" "integer xresolution" [8] "integer yresolution" [8]\\n'
            'Sampler "zsobol" "integer pixelsamples" [1]\\nWorldBegin\\n'
            'LightSource "infinite" "string filename" "sky.pfm"\\n'
            'Texture "a" "spectrum" "imagemap" "string filename" "albedo.pfm" "string filter" "ewa"\\n'
            'Texture "g" "float" "imagemap" "string filename" "gray.pfm"\\n'
            'MakeNamedMaterial "m1" "string type" "diffuse" "texture reflectance" "a"\\n'
            'MakeNamedMaterial "m2" "string type" "coateddiffuse" "texture displacement" "g"\\n'
            'Material "mix" "string materials" ["m1" "m2"] "texture amount" "g"\\n'
            'Shape "sphere" "float radius" [1]\\n')
        b = SceneBuilder(search_dir=d)
        parse_str(text, b, search_dir=d)
        job = b.create(device="cpu")
        img = render(job.scene, job.camera, job.film, job.sampler, spp=1, max_depth=3)[0]
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
if "shimmer_tpu_torch.shapes.instanced" in runs:
    # The instancing slice runs, not only imports: a scene with instances
    # of an object, a patch floor and a patch area light, loaded and
    # rendered at a small size on the CPU.
    import torch
    from shimmer_tpu_torch.loading.parser import parse_str
    from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
    from shimmer_tpu_torch.render import render
    text = (
        'LookAt 0 1 -4  0 0 0  0 1 0\\nCamera "perspective"\\n'
        'Film "rgb" "integer xresolution" [8] "integer yresolution" [8]\\n'
        'Sampler "zsobol" "integer pixelsamples" [1]\\n'
        'Integrator "path" "string lightsampler" "power"\\nWorldBegin\\n'
        'ObjectBegin "o"\\nShape "trianglemesh" "integer indices" [0 1 2 0 2 3 0 3 1]\\n'
        '  "point3 P" [0 1 0  -0.5 0 0  0.5 0 0  0 0 0.5]\\nObjectEnd\\n'
        'ObjectInstance "o"\\nAttributeBegin\\nTranslate 1 0 0.5\\nScale 0.5 0.5 0.5\\n'
        'ObjectInstance "o"\\nAttributeEnd\\n'
        'Shape "bilinearmesh" "integer indices" [0 1 2 3] "point3 P" [-3 0 -3 3 0 -3 -3 0 3 3 0 3]\\n'
        'AttributeBegin\\nAreaLightSource "diffuse" "rgb L" [5 5 5]\\n'
        'Shape "bilinearmesh" "integer indices" [0 1 2 3] "point3 P" [-1 2 -1 1 2 -1 -1 2 1 1 2 1]\\n'
        'AttributeEnd\\n')
    b = SceneBuilder()
    parse_str(text, b)
    job = b.create(device="cpu")
    assert job.scene.has_instanced and job.scene.has_patches
    img = render(job.scene, job.camera, job.film, job.sampler, spp=1, max_depth=3)[0]
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
if "shimmer_tpu_torch.film.filters" in runs:
    # The megakernel slice runs, not only imports: a scene with the
    # stratified sampler, the Mitchell filter, a thin lens, the world
    # render space, both jitter options, ColorSpace rec2020 and the film's
    # ISO and white balance, rendered at a small size on the CPU through
    # the megakernel and each estimator, and through the wavefront.
    import torch
    from shimmer_tpu_torch.loading.parser import parse_str
    from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
    from shimmer_tpu_torch.render import render
    text = (
        'ColorSpace "rec2020"\\nOption "string rendercoordsys" "world"\\n'
        'Option "bool disablepixeljitter" true\\nOption "bool disablewavelengthjitter" true\\n'
        'LookAt 0 1 -4  0 0 0  0 1 0\\n'
        'Camera "perspective" "float lensradius" [0.05] "float focaldistance" [4]\\n'
        'Film "rgb" "integer xresolution" [8] "integer yresolution" [8] "float iso" [200]\\n'
        '  "float whitebalance" [5000]\\n'
        'Sampler "stratified" "integer pixelsamples" [4]\\nPixelFilter "mitchell"\\n'
        'WorldBegin\\nLightSource "infinite" "rgb L" [0.3 0.3 0.3]\\n'
        'AttributeBegin\\nAreaLightSource "diffuse" "rgb L" [8 8 8]\\n'
        'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\\n'
        '  "point3 P" [-1 3 -1  1 3 -1  1 3 1  -1 3 1]\\nAttributeEnd\\n'
        'Shape "sphere" "float radius" [1]\\n')
    b = SceneBuilder()
    parse_str(text, b)
    job = b.create(device="cpu")
    for kw in ({{"wavefront": False}}, {{"integrator": "simplepath"}},
               {{"integrator": "randomwalk"}}, {{}}):
        img = render(job.scene, job.camera, job.film, job.sampler, spp=4, max_depth=3,
                     disable_pixel_jitter=job.disable_pixel_jitter,
                     disable_wavelength_jitter=job.disable_wavelength_jitter, **kw)[0]
        assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0, kw
if "shimmer_tpu_torch.utils.checkpoint" in runs:
    # The gradient slice runs, not only imports: a checkpointed render
    # resumed, the statistics report, splats, and a gradient through the
    # megakernel with per-bounce checkpoints, at a small size on the CPU.
    import dataclasses, pathlib, tempfile
    import torch
    from shimmer_tpu_torch import bench_scene
    from shimmer_tpu_torch.render import make_wave_renderer, pixel_blocks, render
    from shimmer_tpu_torch.samplers import ZSobolSampler
    from shimmer_tpu_torch.utils import stats
    scene, cam, film = bench_scene.build_bench_scene(320, (8, 8), device="cpu")
    sampler = ZSobolSampler(2, (8, 8))
    with tempfile.TemporaryDirectory() as tmp:
        ck = pathlib.Path(tmp) / "ck.npz"
        whole = render(scene, cam, film, sampler, spp=2, max_depth=3, wave_spp=1)[1]
        resumed = render(scene, cam, film, sampler, spp=2, max_depth=3, wave_spp=1,
                         checkpoint_path=ck, collect_stats=True)[1]
        assert torch.equal(whole.rgb_sum, resumed.rgb_sum)
    assert "Rays traced" in stats.report()
    splat = film.add_splats(film.init_state("cpu"), torch.rand(64, 2) * 8, torch.ones(64, 4),
                            film.sample_wavelengths(torch.rand(64)))
    assert float(splat.rgb_splat.sum()) > 0
    refl = scene.materials.reflectance.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, reflectance=refl))
    wave = make_wave_renderer(sc, cam, film, sampler, max_depth=3,
                              integrator_options={{"remat": "full"}})
    blocks, valids = pixel_blocks(film, 64, device="cpu")
    state, _ = wave(film.init_state("cpu"), torch.arange(1), blocks[0], valids[0])
    (g,) = torch.autograd.grad(film.get_image(state).mean(), refl)
    assert bool(torch.isfinite(g).all()) and float(g[1].abs().sum()) > 0
if "shimmer_tpu_torch.parallel.distributed" in runs:
    # The sharding slice runs, not only imports: the replay wavefront's
    # gradient, the flagship in tiles and spp mode over two CPU bands, and
    # the sharded training step.
    import dataclasses
    import torch
    from shimmer_tpu_torch import bench_scene
    from shimmer_tpu_torch.flagship import dryrun_multichip, flagship
    from shimmer_tpu_torch.parallel.render import make_tile_mesh, render_sharded
    from shimmer_tpu_torch.render import make_replay_wavefront_renderer, pixel_blocks
    from shimmer_tpu_torch.samplers import IndependentSampler, ZSobolSampler
    scene, cam, film = bench_scene.build_bench_scene(320, (8, 8), device="cpu")
    refl = scene.materials.reflectance.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, reflectance=refl))
    wave = make_replay_wavefront_renderer(sc, cam, film, ZSobolSampler(1, (8, 8)), max_depth=3)
    blocks, valids = pixel_blocks(film, 64, device="cpu")
    state = wave(sc, film.init_state("cpu"), torch.arange(1), blocks[0], valids[0])
    (g,) = torch.autograd.grad(film.get_image(state).mean(), refl)
    assert bool(torch.isfinite(g).all()) and float(g[1].abs().sum()) > 0
    scene, cam, film = flagship((8, 8), "cpu")
    for mode in ("tiles", "spp"):
        img = render_sharded(scene, cam, film, IndependentSampler(2), make_tile_mesh(["cpu"] * 2),
                             spp=2, max_depth=2, mode=mode)[0]
        assert img.shape == (8, 8, 3) and float(img.mean()) > 0, mode
    assert dryrun_multichip(["cpu"] * 2)["wave_image_mean"] > 0
blocked = ("jax", "jaxlib", "shimmer_tpu")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in blocked and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


@pytest.mark.parametrize(
    "names",
    [
        "package",
        ["shimmer_tpu_torch.ops.bvh", "shimmer_tpu_torch.ops.bvh8", "shimmer_tpu_torch.native"],
        "card",
        ["shimmer_tpu_torch.ops.cuda_build", "shimmer_tpu_torch.ops.gather",
         "shimmer_tpu_torch.experiments.gather"],
        ["shimmer_tpu_torch.ops.cuda_build", "shimmer_tpu_torch.ops.packet_step",
         "shimmer_tpu_torch.experiments.packet_step"],
        ["shimmer_tpu_torch.ops.traverse", "shimmer_tpu_torch.measure",
         "shimmer_tpu_torch.experiments.kernel_ab"],
        ["shimmer_tpu_torch.materials.scattering", "shimmer_tpu_torch.materials.conductor_dielectric",
         "shimmer_tpu_torch.materials.layered", "shimmer_tpu_torch.materials.material",
         "shimmer_tpu_torch.integrators.path", "shimmer_tpu_torch.convert",
         "shimmer_tpu_torch.bench_scene"],
        ["shimmer_tpu_torch.shapes.sphere", "shimmer_tpu_torch.loading.parser",
         "shimmer_tpu_torch.loading.scene_builder", "shimmer_tpu_torch.film.image",
         "shimmer_tpu_torch.cli"],
        ["shimmer_tpu_torch.ops.sampling", "shimmer_tpu_torch.textures.textures",
         "shimmer_tpu_torch.textures.normal_bump", "shimmer_tpu_torch.lights.env"],
        ["shimmer_tpu_torch.shapes.bilinear", "shimmer_tpu_torch.shapes.instanced",
         "shimmer_tpu_torch.scene", "shimmer_tpu_torch.convert"],
        ["shimmer_tpu_torch.ops.rng", "shimmer_tpu_torch.samplers",
         "shimmer_tpu_torch.film.filters", "shimmer_tpu_torch.cameras",
         "shimmer_tpu_torch.color.color", "shimmer_tpu_torch.color.colorspace",
         "shimmer_tpu_torch.film.film", "shimmer_tpu_torch.render"],
        ["shimmer_tpu_torch.utils.checkpoint", "shimmer_tpu_torch.utils.stats",
         "shimmer_tpu_torch.ops.math", "shimmer_tpu_torch.integrators.path",
         "shimmer_tpu_torch.film.film", "shimmer_tpu_torch.render", "shimmer_tpu_torch.cli"],
        ["shimmer_tpu_torch.parallel.render", "shimmer_tpu_torch.parallel.distributed",
         "shimmer_tpu_torch.flagship", "shimmer_tpu_torch.experiments.dryrun_multihost",
         "shimmer_tpu_torch.render", "shimmer_tpu_torch.cli"],
    ],
    ids=["shimmer_tpu_torch", "own_host_modules", "card_tests", "gather_modules",
         "packet_step_modules", "kernel_ab_modules", "material_modules",
         "scene_file_modules", "texture_modules", "instancing_modules", "megakernel_modules",
         "gradient_modules", "sharding_modules"],
)
def test_imports_without_jax(names):
    # One torch thread: the subprocess runs beside the other xdist workers.
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(names=repr(names))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 1
