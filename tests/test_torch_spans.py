"""The spans of ``shimmer_tpu_torch/utils/stats.py`` and their call sites,
on the CPU: nesting, parents and self time; threads; the record cap and
its drop counter; ``clear()``; the timer; every stage span of a wavefront
``render()``; the replay backward's two children."""

import dataclasses
import os
import sys
import threading
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")

import pytest
import torch

from shimmer_tpu_torch.bench_scene import build_material_bench_scene
from shimmer_tpu_torch.cameras import CameraTransform, PerspectiveCamera
from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
from shimmer_tpu_torch.film.filters import BoxFilter
from shimmer_tpu_torch.lights import lights as lt
from shimmer_tpu_torch.materials import material as mtl
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.render import full_image_pixels, make_replay_wavefront_renderer, render
from shimmer_tpu_torch.samplers import IndependentSampler, StratifiedSampler, ZSobolSampler
from shimmer_tpu_torch.scene_builder import build_scene
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum
from shimmer_tpu_torch.utils import stats

torch.set_num_threads(1)

STAGES = ("wavefront/regen", "wavefront/trace", "wavefront/emission", "wavefront/hit",
          "wavefront/nee", "wavefront/bsdf", "wavefront/roulette", "wavefront/retire",
          "wavefront/film", "wavefront/sync")


@pytest.fixture(autouse=True)
def _clean_registry():
    stats.clear()
    yield
    stats.clear()


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_nesting_parents_and_self_time():
    with stats.span("t/outer"):
        with stats.span("t/a"):
            time.sleep(0.002)
        with stats.span("t/b"):
            with stats.span("t/a"):
                time.sleep(0.001)
    recs = stats.spans()
    assert [r.name for r in recs] == ["t/outer", "t/a", "t/b", "t/a"]
    assert [r.index for r in recs] == [0, 1, 2, 3]
    assert [r.parent for r in recs] == [-1, 0, 0, 2]
    for r in recs:
        assert r.end_ns >= r.start_ns and r.thread == threading.get_ident()
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    dur = [r.end_ns - r.start_ns for r in recs]
    outer, a, b = stats.span("t/outer"), stats.span("t/a"), stats.span("t/b")
    assert (outer.calls, a.calls, b.calls) == (1, 2, 1)
    assert outer.total_ns == dur[0] and a.total_ns == dur[1] + dur[3]
    assert outer.self_ns == dur[0] - dur[1] - dur[2]
    assert b.self_ns == dur[2] - dur[3]
    assert a.self_ns == a.total_ns
    assert outer.seconds == pytest.approx(dur[0] * 1e-9)


def test_decorator_keeps_the_function():
    @stats.span("t/decorated")
    def add(x, y=1):
        """Adds."""
        return x + y

    assert add(2, y=3) == 5 and add.__name__ == "add" and add.__doc__ == "Adds."
    assert stats.span("t/decorated").calls == 1
    with pytest.raises(ZeroDivisionError):
        with stats.span("t/raises"):
            1 / 0
    assert [r.name for r in stats.spans()] == ["t/decorated", "t/raises"]
    with stats.span("t/after"):
        pass
    assert stats.spans()[-1].parent == -1


def test_a_span_on_another_thread_has_no_parent_from_the_main_thread():
    seen = {}

    def work():
        with stats.span("t/worker"):
            with stats.span("t/worker_child"):
                seen["tid"] = threading.get_ident()

    with stats.span("t/main"):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    recs = _by_name(stats.spans())
    (main,), (worker,), (child,) = recs["t/main"], recs["t/worker"], recs["t/worker_child"]
    assert worker.parent == -1 and child.parent == worker.index
    assert worker.thread == seen["tid"] != main.thread


def test_spans_past_the_cap_are_counted_and_aggregates_stay_exact(monkeypatch):
    monkeypatch.setattr(stats, "SPAN_CAP", 5)
    with stats.span("t/outer"):
        for _ in range(8):
            with stats.span("t/child"):
                pass
    recs = stats.spans()
    assert len(recs) == 5 and [r.index for r in recs] == [0, 1, 2, 3, 4]
    assert stats.as_dict()[stats.DROPPED] == 4.0
    child, outer = stats.span("t/child"), stats.span("t/outer")
    assert child.calls == 8 and outer.calls == 1
    assert outer.total_ns == recs[0].end_ns - recs[0].start_ns
    assert outer.self_ns == outer.total_ns - child.total_ns
    assert child.total_ns >= sum(r.end_ns - r.start_ns for r in recs[1:])


def test_clear_drops_records_aggregates_and_counters():
    stats.counter("Integrator/Rays traced").add(3)
    with stats.span("t/x"):
        pass
    with stats.span("t/open"):
        stats.clear()
        with stats.span("t/inner"):
            pass
    assert stats.as_dict() == {}
    recs = stats.spans()
    assert [r.name for r in recs] == ["t/inner"] and recs[0].parent == -1
    assert stats.span("t/x").calls == 0 and stats.span("t/open").calls == 0
    stats.clear()
    assert stats.spans() == [] and stats.span("t/inner").calls == 0
    assert stats.report() == "Statistics:"


def test_timer_behaves_as_before():
    t = stats.timer("Render/Wave time")
    with t:
        time.sleep(0.001)
    with stats.timer("Render/Wave time"):
        pass
    d = stats.as_dict()
    assert t.calls == 2 and d["Render/Wave time"] == t.seconds > 0.001
    rep = stats.report().splitlines()
    assert rep[:2] == ["Statistics:", "  Render"]
    assert rep[2].split()[:2] == ["Wave", "time"] and rep[2].endswith("(2 calls)")
    # A timer alone makes no span section; another span does.
    assert len(rep) == 3
    with stats.span("t/y"):
        pass
    rep = stats.report().splitlines()
    assert rep[3].split() == ["Spans", "calls", "total", "self"]
    assert rep[4].split()[:2] == ["t/y", "1"]


def test_threads_do_not_lose_spans():
    n_threads, per = (os.cpu_count() or 1) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with stats.span("t/stress"):
                    with stats.span("t/stress_child"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    recs = stats.spans()
    assert stats.span("t/stress").calls == stats.span("t/stress_child").calls == n_threads * per
    assert len(recs) == 2 * n_threads * per
    assert sorted(r.index for r in recs) == list(range(len(recs)))
    for r in recs:
        if r.name == "t/stress_child":
            p = recs[r.parent]
            assert p.name == "t/stress" and p.thread == r.thread


def _scene_camera_film(res):
    cs = get_named_color_space("srgb")
    ct = CameraTransform(Transform.look_at([0.0, 0.0, -4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    cam = PerspectiveCamera(ct, (res, res), fov=45.0)
    film = RgbFilm((res, res), BoxFilter(), PixelSensor(cs), cs)
    r2w = ct.render_from_world()
    scene = build_scene(
        None, materials=[{"kind": mtl.DIFFUSE, "reflectance": [0.5, 0.5, 0.5]}],
        lights=[{"kind": lt.AREA, "spectrum": ConstantSpectrum(5.0), "shape_kind": 0,
                 "shape_idx": 0}],
        spheres=[{"radius": 1.0, "material_id": 0, "area_light_id": 0, "object_to_render": r2w}],
        render_from_world=r2w, device="cpu",
    )
    return scene, cam, film


def _chain(recs, r):
    names = []
    while r.parent >= 0:
        r = recs[r.parent]
        names.append(r.name)
    return names


@pytest.mark.parametrize("case", ["sphere-zsobol", "sphere-independent", "sphere-stratified",
                                  "mix-zsobol"])
def test_wavefront_render_records_every_stage(case):
    """Every stage span, each under ``wavefront/wave`` and ``render/wave``,
    the sampler's, the dispatch's and the traversal's inside them, and one
    ``wavefront/sync`` for each stop test and each done-lane write."""
    spp = 2
    if case.startswith("mix"):
        scene, cam, film = build_material_bench_scene(400, (8, 6), "mix", device="cpu")
    else:
        scene, cam, film = _scene_camera_film(10)
    res = film.resolution
    smp = {"zsobol": lambda: ZSobolSampler(spp, res),
           "independent": lambda: IndependentSampler(spp),
           "stratified": lambda: StratifiedSampler(1, spp)}[case.split("-")[1]]()
    stats.clear()
    render(scene, cam, film, smp, "path", spp=spp, max_depth=3, wave_spp=spp,
           pixel_block=res[0] * res[1], collect_stats=True)
    iters = stats.as_dict()["Integrator/Wavefront iterations"]
    recs = stats.spans()
    by = _by_name(recs)
    assert set(STAGES) <= set(by) and "wavefront/medium" not in by
    assert len(by["render/wave"]) == len(by["wavefront/wave"]) == 1
    assert len(by["wavefront/sync"]) == 2 * iters + 1
    assert len(by["wavefront/trace"]) == iters
    assert len(by["wavefront/regen"]) == iters + 1
    inner = ["sampler/start", "sampler/draw", "material/sample", "material/eval"]
    families = ["material/diffuse"]
    if case.startswith("mix"):
        families += ["material/conductor_dielectric", "material/layered"]
        inner += ["material/mix", "traverse/launch"] + families
        assert {recs[r.parent].name for r in by["traverse/launch"]} == {"wavefront/trace"}
    for name in STAGES + tuple(inner):
        for r in by[name]:
            chain = _chain(recs, r)
            assert "wavefront/wave" in chain and chain[-1] == "render/wave", (name, chain)
    for name in families:
        for r in by[name]:
            assert recs[r.parent].name in ("material/sample", "material/eval", "material/pdf")
    rep = stats.report()
    assert "Wave time" in rep and "wavefront/trace" in rep


def test_render_without_stats_records_spans_and_returns_two_values():
    scene, cam, film = _scene_camera_film(8)
    out = render(scene, cam, film, IndependentSampler(1), "path", spp=1, max_depth=2)
    assert len(out) == 2
    by = _by_name(stats.spans())
    assert len(by["render/wave"]) == 1 and "Render/Wave time" not in by
    assert stats.as_dict() == {}


def test_replay_backward_records_remat_and_vjp():
    res, spp = 8, 1
    scene, cam, film = _scene_camera_film(res)
    refl = scene.materials.reflectance.clone().requires_grad_(True)
    scene = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                     reflectance=refl))
    pixel_xy = full_image_pixels(film, "cpu")
    valid = torch.ones(pixel_xy.shape[0], dtype=torch.bool)
    wave = make_replay_wavefront_renderer(scene, cam, film, IndependentSampler(spp),
                                          max_depth=2)
    fs = wave(scene, film.init_state("cpu"), torch.arange(spp), pixel_xy, valid)
    fs.rgb_sum.sum().backward()
    assert refl.grad is not None
    recs = stats.spans()
    by = _by_name(recs)
    (fwd,), (bwd,) = by["replay/forward"], by["replay/backward"]
    (remat,), (vjp,) = by["replay/remat"], by["replay/vjp"]
    assert remat.parent == vjp.parent == bwd.index
    assert remat.end_ns <= vjp.start_ns
    assert fwd.end_ns <= bwd.start_ns
    assert any(recs[r.parent].name == "wavefront/wave" or "replay/forward" in _chain(recs, r)
               for r in by["wavefront/trace"])
    assert any("replay/remat" in _chain(recs, r) for r in by["sampler/draw"])
