"""The layered walks replayed from CUDA graphs (``materials/walk_graph.py``)
on the card, against the same walks run op by op.

* coated diffuse and coated conductor, f, sample and pdf, at the
  material cell's 129,600 lanes and at an odd small count: three calls
  with fresh inputs, every output ``torch.equal`` to the eager walk's on
  the same inputs, one capture and then replays;
* a textured reflectance as a graph input;
* under autograd, with a table column that needs its gradient, the walk
  runs eagerly and its gradient is the eager one;
* the material bench scene rendered both ways, ``torch.equal``.

The eager walk is had by replacing ``walk_graph.run`` with a plain call,
which the program never does.  Marked ``card``: each skips without a
CUDA card.  tests/conftest.py imports JAX, which the card's machine
lacks, so run them there with

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_walk_graph_card.py
"""

import dataclasses
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from shimmer_tpu_torch import samplers
from shimmer_tpu_torch.bench_scene import (
    build_material_bench_scene,
    material_bench_materials,
    material_bench_spectra,
)
from shimmer_tpu_torch.config import f32
from shimmer_tpu_torch.materials import layered, walk_graph
from shimmer_tpu_torch.materials.bxdf import BSDFSample
from shimmer_tpu_torch.materials.material import make_material_table
from shimmer_tpu_torch.ops.math import small_gather
from shimmer_tpu_torch.ops.vecmath import normalize
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths
from shimmer_tpu_torch.utils import stats

pytestmark = pytest.mark.card

CELL_LANES = 129_600
ODD_LANES = 1_001
# Rows of material_bench_materials("mix"): a coated diffuse, a coated
# conductor (copper) and a plain diffuse that the selection leaves alone.
COAT_ROW = {layered.COATED_DIFFUSE: 9, layered.COATED_CONDUCTOR: 5}
DIFFUSE_ROW = 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


@pytest.fixture
def fresh(monkeypatch):
    """An empty graph cache and registry for the test."""
    monkeypatch.setattr(walk_graph, "_CACHE", walk_graph.WalkGraphs())
    stats.clear()
    yield
    stats.clear()


@contextmanager
def eager():
    """Every walk op by op, as the CPU runs it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(walk_graph, "run", lambda name, fn, args, tables: fn(*args))
    try:
        yield
    finally:
        mp.undo()


def tables(device):
    return (make_material_table(material_bench_materials("mix"), device),
            f32(material_bench_spectra(), device))


def walk_inputs(n, mk, device, seed):
    """Lanes half of coated kind ``mk`` and half plain diffuse, directions
    in both hemispheres, draws and RNG keys from ``seed``."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(device, dtype)

    mat_id = t(np.where(rng.random(n) < 0.5, COAT_ROW[mk], DIFFUSE_ROW), torch.int32)
    return dict(
        mat_id=mat_id,
        wo=normalize(t(rng.normal(size=(n, 3)))),
        wi=normalize(t(rng.normal(size=(n, 3)))),
        u2=t(rng.random((n, 2))),
        uc=t(rng.random(n)),
        swl=SampledWavelengths.sample_visible(t(rng.random(n))),
        rng_key=t(rng.integers(0, 1 << 32, n), torch.int64),
        refl=t(rng.random((n, 4))),
    )


def call(walk, materials, spectra, inp, textured=False):
    """One coated dispatch call (every coated kind a lane has), its outputs
    as a tuple."""
    kinds = tuple(sorted(set(materials.kind.tolist())))
    mat_id, wo, swl, key = inp["mat_id"], inp["wo"], inp["swl"], inp["rng_key"]
    kind = small_gather(materials.kind, mat_id)
    ctx = dict(spectra_table=spectra, tex={"reflectance": inp["refl"]} if textured else None)
    n = wo.shape[0]
    if walk == "f":
        f0 = torch.zeros(n, 4, device=wo.device)
        return (layered.coated_f(materials, kinds, mat_id, kind, wo, inp["wi"], swl, f0, key,
                                 **ctx),)
    if walk == "sample":
        s = layered.coated_sample(materials, kinds, mat_id, kind, wo, inp["u2"], inp["uc"], swl,
                                  BSDFSample.invalid((n,), wo.device), key, **ctx)
        return tuple(getattr(s, fld.name) for fld in dataclasses.fields(s))
    pdf0 = torch.zeros(n, device=wo.device)
    return (layered.coated_pdf(materials, kinds, mat_id, kind, wo, inp["wi"], swl, pdf0, key,
                               **ctx),)


def counts():
    d = stats.as_dict()
    return {k: d.get(k, 0.0) for k in (walk_graph.CAPTURES, walk_graph.REPLAYS, walk_graph.EAGER)}


def assert_equal(graphed, plain):
    assert len(graphed) == len(plain)
    for g, p in zip(graphed, plain):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.equal(g, p)


@pytest.mark.parametrize("lanes", [CELL_LANES, ODD_LANES])
@pytest.mark.parametrize("walk", ["f", "sample", "pdf"])
@pytest.mark.parametrize("mk", [layered.COATED_DIFFUSE, layered.COATED_CONDUCTOR])
def test_replays_equal_the_eager_walk(card, fresh, mk, walk, lanes):
    materials, spectra = tables(card)
    for i in range(3):
        inp = walk_inputs(lanes, mk, card, seed=1000 * mk + i)
        graphed = call(walk, materials, spectra, inp)
        with eager():
            plain = call(walk, materials, spectra, inp)
        assert_equal(graphed, plain)
        assert counts() == {walk_graph.CAPTURES: 1.0, walk_graph.REPLAYS: float(i),
                            walk_graph.EAGER: 0.0}
    if walk == "sample":
        assert graphed[6].any() and not graphed[6].all()   # some valid, some not


def test_a_later_call_leaves_an_earlier_result_alone(card, fresh):
    materials, spectra = tables(card)
    mk = layered.COATED_DIFFUSE
    first_in = walk_inputs(ODD_LANES, mk, card, seed=1)
    first = call("f", materials, spectra, first_in)[0]
    kept = first.clone()
    call("f", materials, spectra, walk_inputs(ODD_LANES, mk, card, seed=2))
    assert torch.equal(first, kept)


@pytest.mark.parametrize("mk", [layered.COATED_DIFFUSE, layered.COATED_CONDUCTOR])
def test_a_textured_reflectance_is_a_graph_input(card, fresh, mk):
    materials, spectra = tables(card)
    for i in range(2):
        inp = walk_inputs(ODD_LANES, mk, card, seed=7 + i)
        graphed = call("sample", materials, spectra, inp, textured=True)
        with eager():
            plain = call("sample", materials, spectra, inp, textured=True)
        assert_equal(graphed, plain)
    assert counts()[walk_graph.CAPTURES] == 1.0


def test_under_autograd_the_walk_runs_eagerly_with_the_eager_gradient(card, fresh):
    materials, spectra = tables(card)
    refl = materials.reflectance.clone().requires_grad_(True)
    materials = dataclasses.replace(materials, reflectance=refl)
    inp = walk_inputs(ODD_LANES, layered.COATED_DIFFUSE, card, seed=3)
    f = call("f", materials, spectra, inp)[0]
    (grad,) = torch.autograd.grad(f.sum(), refl)
    assert counts() == {walk_graph.CAPTURES: 0.0, walk_graph.REPLAYS: 0.0,
                        walk_graph.EAGER: 1.0}
    assert stats.as_dict()[f"{walk_graph.EAGER}: grad"] == 1.0
    with eager():
        f_plain = call("f", materials, spectra, inp)[0]
        (grad_plain,) = torch.autograd.grad(f_plain.sum(), refl)
    assert torch.equal(f, f_plain)
    assert grad.abs().sum() > 0 and torch.equal(grad, grad_plain)
    # Without grad the same table is read by address.
    with torch.no_grad():
        call("f", materials, spectra, inp)
    assert counts()[walk_graph.CAPTURES] == 1.0


def test_the_material_render_equals_the_eager_render(card, fresh):
    scene, cam, film = build_material_bench_scene(20_000, (96, 54), device=card)
    smp = samplers.ZSobolSampler(2, film.resolution, 3_000_000_019)
    opts = dict(spp=2, wave_spp=2, max_depth=5, pixel_block=96 * 54)
    graphed, _ = render(scene, cam, film, smp, "path", **opts)
    replays = counts()[walk_graph.REPLAYS]
    with eager():
        plain, _ = render(scene, cam, film, smp, "path", **opts)
    assert replays > 0 and counts()[walk_graph.EAGER] == 0.0
    assert graphed.float().mean() > 0
    assert torch.equal(graphed, plain)
