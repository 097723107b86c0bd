"""Render checkpoints, the statistics registry and the film's splats of
the port (``utils/checkpoint.py``, ``utils/stats.py``, ``render``'s
``checkpoint_path`` / ``collect_stats``, ``RgbFilm.add_splats`` /
``merge``) on the CPU.

- tests/test_render_e2e.py's ``test_stats_registry_collects``,
  ``test_kill_and_resume_bit_identical`` and ``test_stale_checkpoint_ignored``
  in the port.  The resumed film state is ``torch.equal`` to an
  uninterrupted render's, after a checkpoint written by hand (as the
  reference's test writes it) and after a render killed after its second
  wave.
- A checkpoint written by either package loads in the other, and the
  statistics report has the reference's text for the same registry.
- ``add_splats`` with many samples per pixel against the reference's
  (rtol 1e-5 on every pixel, atol 1e-6 of the image's largest value:
  the port sums each pixel's samples in a fixed order of its own), the
  same bits on a second run, and ``merge`` as the sum of the planes.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.color.colorspace import get_named_color_space as jax_colorspace
from shimmer_tpu.film.film import PixelSensor as JaxSensor
from shimmer_tpu.film.film import RgbFilm as JaxFilm
from shimmer_tpu.film.filters import GaussianFilter as JaxGaussian
from shimmer_tpu.film.filters import MitchellFilter as JaxMitchell
from shimmer_tpu.spectra.sampled import SampledWavelengths as JaxWavelengths
from shimmer_tpu.utils import stats as jax_stats
from shimmer_tpu.utils.checkpoint import RenderCheckpointer as JaxCheckpointer
from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.film.film import FilmState, PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter, GaussianFilter, MitchellFilter
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.samplers import IndependentSampler
from shimmer_tpu_torch.scene_builder import build_scene
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum
from shimmer_tpu_torch.utils import stats
from shimmer_tpu_torch.utils.checkpoint import RenderCheckpointer

torch.set_num_threads(1)


def _camera_film(res):
    cs = get_named_color_space("srgb")
    ct = CameraTransform(Transform.look_at([0.0, 0.0, -4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    cam = PerspectiveCamera(ct, (res, res), fov=45.0)
    return cam, RgbFilm((res, res), BoxFilter(), PixelSensor(cs), cs), cs


def _furnace_scene(cam, cs, albedo):
    return build_scene(
        None, materials=[{"kind": mtl.DIFFUSE, "reflectance": [albedo] * 3}],
        lights=[{"kind": lt.UNIFORM_INFINITE, "spectrum": cs.illuminant, "photometric": True}],
        spheres=[{"radius": 1.0, "material_id": 0,
                  "object_to_render": cam.camera_transform.render_from_world()}],
        render_from_world=cam.camera_transform.render_from_world(), device="cpu",
    )


def _fingerprint(film, spp, max_depth, wave_spp, seed=0, integrator="path", wavefront=True):
    return {"resolution": tuple(int(r) for r in film.resolution), "spp": spp,
            "max_depth": max_depth, "integrator": integrator, "wavefront": wavefront,
            "seed": seed, "wave_spp": wave_spp}


def _assert_states_equal(a: FilmState, b: FilmState):
    for name in ("rgb_sum", "weight_sum", "rgb_splat"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_stats_registry_collects():
    """tests/test_render_e2e.py::test_stats_registry_collects in the port:
    the three counters and the timer fill during ``render``."""
    stats.clear()
    cam, film, cs = _camera_film(12)
    r2w = cam.camera_transform.render_from_world()
    scene = build_scene(
        None, materials=[{"kind": mtl.DIFFUSE, "reflectance": [0.5, 0.5, 0.5]}],
        lights=[{"kind": lt.AREA, "spectrum": ConstantSpectrum(5.0), "shape_kind": 0,
                 "shape_idx": 0}],
        spheres=[{"radius": 1.0, "material_id": 0, "area_light_id": 0, "object_to_render": r2w}],
        render_from_world=r2w, device="cpu",
    )
    _, _, totals = render(scene, cam, film, IndependentSampler(2), "path", spp=2, max_depth=2,
                          collect_stats=True)
    d = stats.as_dict()
    assert d.get("Integrator/Rays traced", 0) > 0
    assert d.get("Integrator/Wavefront iterations", 0) > 0
    assert d.get("Render/Wave time", 0) > 0
    assert d["Render/Pixel samples"] == 12 * 12 * 2
    assert d["Integrator/Rays traced"] == totals["rays"]
    assert d["Integrator/Wavefront iterations"] == totals["iters"]
    rep = stats.report()
    assert "Rays traced" in rep and "Statistics:" in rep
    stats.clear()


def test_report_matches_reference_text():
    """The same registry gives the reference's report, line for line."""
    entries = {"Integrator/Rays traced": 1234567.0, "Integrator/Wavefront iterations": 42.0,
               "Render/Pixel samples": 2500.0, "Misc counter": 0.5}
    for reg in (stats, jax_stats):
        reg.clear()
        for name, v in entries.items():
            reg.counter(name).add(v)
        t = reg.timer("Render/Wave time")
        t.seconds, t.calls = 1.25, 3
    try:
        assert stats.report() == jax_stats.report()
        assert stats.as_dict() == jax_stats.as_dict()
    finally:
        stats.clear()
        jax_stats.clear()


class _Killed(Exception):
    pass


def test_kill_and_resume_bit_identical(tmp_path):
    """tests/test_render_e2e.py::TestCheckpointResume::
    test_kill_and_resume_bit_identical in the port, and a render killed
    after its second wave: both resume to the uninterrupted film state,
    ``torch.equal``."""
    cam, film, cs = _camera_film(32)
    scene = _furnace_scene(cam, cs, 0.5)
    sampler = IndependentSampler(4, seed=0)
    ref, ref_state = render(scene, cam, film, sampler, integrator="path", spp=4, max_depth=3,
                            wave_spp=1)

    # The reference's test: the first 2 spp written under the full
    # render's fingerprint.
    ck = tmp_path / "render.ckpt.npz"
    _, st = render(scene, cam, film, sampler, integrator="path", spp=2, max_depth=3, wave_spp=1)
    RenderCheckpointer(ck, fingerprint=_fingerprint(film, 4, 3, 1)).save(st, 2)
    common = dict(integrator="path", spp=4, max_depth=3, wave_spp=1, checkpoint_path=ck)
    resumed, state = render(scene, cam, film, sampler, **common)
    assert torch.equal(resumed, ref)
    _assert_states_equal(state, ref_state)

    # A render killed after its second wave, then resumed.
    ck2 = tmp_path / "killed.ckpt.npz"
    common["checkpoint_path"] = ck2

    def kill(done, total):
        if done == 2:
            raise _Killed

    with pytest.raises(_Killed):
        render(scene, cam, film, sampler, progress=kill, **common)
    arrays, done = RenderCheckpointer(ck2, _fingerprint(film, 4, 3, 1)).load()
    assert done == 2 and arrays["weight_sum"].min() == 2.0
    seen = []
    resumed2, state2 = render(scene, cam, film, sampler, progress=lambda d, t: seen.append(d),
                              **common)
    assert seen == [3, 4]
    _assert_states_equal(state2, ref_state)
    assert torch.equal(resumed2, ref)


def test_checkpoint_every_and_megakernel(tmp_path):
    """``checkpoint_every`` waves between saves (the last wave always
    saves), and the megakernel's fingerprint names it."""
    cam, film, cs = _camera_film(8)
    scene = _furnace_scene(cam, cs, 0.5)
    ck = tmp_path / "mk.ckpt.npz"
    cursors = []

    def watch(done, total):
        loaded = RenderCheckpointer(ck, _fingerprint(film, 5, 2, 1, wavefront=False)).load()
        cursors.append(None if loaded is None else loaded[1])

    render(scene, cam, film, IndependentSampler(5), spp=5, max_depth=2, wave_spp=1,
           wavefront=False, checkpoint_path=ck, checkpoint_every=2, progress=watch)
    assert cursors == [None, 2, 2, 4, 5]


def test_stale_checkpoint_ignored(tmp_path):
    """tests/test_render_e2e.py::TestCheckpointResume::
    test_stale_checkpoint_ignored in the port."""
    cam, film, cs = _camera_film(16)
    scene = _furnace_scene(cam, cs, 0.5)
    ck = tmp_path / "r.ckpt.npz"
    RenderCheckpointer(ck, fingerprint={"spp": 99}).save(film.init_state("cpu"), 1)
    with pytest.warns(UserWarning, match="fingerprint mismatch"):
        img, state = render(scene, cam, film, IndependentSampler(2, seed=0), integrator="path",
                            spp=2, max_depth=2, wave_spp=1, checkpoint_path=ck)
    assert torch.isfinite(img).all()
    assert (state.weight_sum == 2).all()


def test_checkpoint_crosses_packages(tmp_path):
    """A file written by one package loads in the other: the same keys,
    the same fingerprint text, the same planes and cursor."""
    rng = np.random.default_rng(0)
    planes = {"rgb_sum": rng.random((6, 5, 3), dtype=np.float32),
              "weight_sum": rng.random((6, 5), dtype=np.float32),
              "rgb_splat": rng.random((6, 5, 3), dtype=np.float32)}
    fp = {"resolution": (5, 6), "spp": 8, "max_depth": 5, "integrator": "path",
          "wavefront": True, "seed": 3, "wave_spp": 4}
    port_file, ref_file = tmp_path / "port.npz", tmp_path / "ref.npz"
    RenderCheckpointer(port_file, fp).save(
        FilmState(**{k: torch.from_numpy(v) for k, v in planes.items()}), 4)

    class _JaxState:
        pass

    js = _JaxState()
    for k, v in planes.items():
        setattr(js, k, jnp.asarray(v))
    JaxCheckpointer(ref_file, fp).save(js, 4)
    for reader, path in ((JaxCheckpointer(port_file, fp), port_file),
                         (RenderCheckpointer(ref_file, fp), ref_file)):
        arrays, done = reader.load()
        assert done == 4
        for k, v in planes.items():
            np.testing.assert_array_equal(arrays[k], v)
    with np.load(port_file) as a, np.load(ref_file) as b:
        assert sorted(a.files) == sorted(b.files)
        assert bytes(a["fingerprint"]) == bytes(b["fingerprint"])
    with pytest.warns(UserWarning, match="fingerprint mismatch"):
        assert JaxCheckpointer(port_file, dict(fp, spp=9)).load() is None


SPLAT_FILTERS = {
    "gaussian": (lambda: GaussianFilter(1.5, 1.5, 0.6), lambda: JaxGaussian(1.5, 1.5, 0.6)),
    "mitchell": (lambda: MitchellFilter(2.0, 2.0, 1 / 3, 1 / 3),
                 lambda: JaxMitchell(2.0, 2.0, 1 / 3, 1 / 3)),
}


@pytest.mark.parametrize("name", list(SPLAT_FILTERS))
def test_splats_match_reference(name):
    """4,096 splats on a 12x10 film (~540 samples a pixel; some windows
    hang over the edges), against the reference's ``add_splats``."""
    port_filter, jax_filter = SPLAT_FILTERS[name]
    res = (12, 10)
    cs, jcs = get_named_color_space("srgb"), jax_colorspace("srgb")
    film = RgbFilm(res, port_filter(), PixelSensor(cs), cs)
    jfilm = JaxFilm(res, jax_filter(), JaxSensor(jcs), jcs)
    rng = np.random.default_rng(5)
    n = 4096
    p = np.stack([rng.uniform(-1.0, 13.0, n), rng.uniform(-1.0, 11.0, n)], -1).astype(np.float32)
    lrad = rng.lognormal(0.0, 1.0, (n, 4)).astype(np.float32)
    u = rng.uniform(size=n).astype(np.float32)
    swl = SampledWavelengths.sample_visible(torch.from_numpy(u))
    state = film.add_splats(film.init_state("cpu"), torch.from_numpy(p), torch.from_numpy(lrad),
                            swl)
    again = film.add_splats(film.init_state("cpu"), torch.from_numpy(p), torch.from_numpy(lrad),
                            swl)
    assert torch.equal(state.rgb_splat, again.rgb_splat)
    assert (state.rgb_sum == 0).all() and (state.weight_sum == 0).all()
    jstate = jfilm.add_splats(jfilm.init_state(), jnp.asarray(p), jnp.asarray(lrad),
                              JaxWavelengths.sample_visible(jnp.asarray(u)))
    got, want = state.rgb_splat.numpy(), np.asarray(jstate.rgb_splat)
    assert (want != 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    both = film.merge(state, again)
    assert torch.equal(both.rgb_splat, state.rgb_splat * 2)
    img = film.get_image(both, splat_scale=0.5).numpy()
    np.testing.assert_allclose(img, np.asarray(jfilm.get_image(jstate)), rtol=1e-4,
                               atol=1e-5 * np.abs(img).max())
