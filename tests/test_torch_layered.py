"""Parity of the port's layered (coated) BxDFs with the reference's, and
tests/test_layered.py's oracle checks run against both packages.

Layered f and pdf are random-walk estimates and sample is a random walk:
both packages draw from the same counter stream (``_Rng``, keyed per
lane), draw for draw, so the walks are the same and their results agree
lane by lane.  The reference runs op by op (``jax.disable_jit``) at the
tolerance of test_torch_materials.py: rtol 1e-5 / atol 1e-6, flags and
``valid`` exactly.  Inputs: both hemispheres and grazing wo, smooth and
rough coats, constant per-lane eta (eta = 1 and eta < 1 included), diffuse
and conductor bottoms, with and without a scattering layer medium.

layered_f and layered_pdf meet that tolerance on every lane.
layered_sample's walk takes the same branches on every lane (flags and
``valid`` equal), but it multiplies f and pdf through up to ten
interfaces, and a 1-2 ulp difference of a normalized direction
(``lax.rsqrt`` on the CPU is not torch's ``rsqrt``; neither is correctly
rounded) grows along a chain of near-specular events.  Its floats are held
at rtol 1e-5 on at least 98% of lanes and at rtol 5e-3 on all of them: the
measured maximum is 4.1e-3 relative (f of one lane of the coated dispatch
with a layer medium; 1.7e-3 for a pdf of 3,476 in the conductor-bottom
walk), on at most 6 of 384 lanes per case.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.materials import layered as jly
from shimmer_tpu.ops import rng as jrng
from shimmer_tpu_torch.materials import layered as tly
from shimmer_tpu_torch.ops import rng as trng
from test_torch_materials import (
    ATOL,
    RTOL,
    D,
    J,
    N,
    T,
    _coeffs,
    _dispatch,
    _unit,
    _wo,
    assert_same,
    check,
    run_both,
    to_numpy,
)

torch.set_num_threads(1)

JL = types.SimpleNamespace(**vars(J), ly=jly, rng=jrng,
                           keys=lambda k: jnp.asarray(k, jnp.uint32))
TL = types.SimpleNamespace(**vars(T), ly=tly, rng=trng,
                           keys=lambda k: torch.from_numpy(np.asarray(k, np.int64)))
PACKAGES = {"jax": JL, "torch": TL}


def _layer_inputs():
    rng = np.random.default_rng(71)
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(
        D,
        key=(np.arange(N, dtype=np.uint64) * 2246822519 % (1 << 32)).astype(np.uint32),
        refl4=f(rng.uniform(0.05, 0.95, (N, 4))),
        bax=f(np.where(np.arange(N) % 4 == 0, 1e-4, rng.uniform(0.05, 0.6, N))),
        thickness=f(rng.uniform(0.005, 0.5, N)),
        albedo=f(rng.uniform(0.0, 1.0, (N, 4))),
    )


L = _layer_inputs()


def _layers(P, d, bottom):
    top = P.ly._TopInterface(P.arr(d["eta"]), P.arr(d["ax"]), P.arr(d["ay"]))
    if bottom == "diffuse":
        bot = P.ly._DiffuseBottom(P.arr(d["refl4"]))
    else:
        bax = P.arr(d["bax"])
        bot = P.ly._ConductorBottom(P.arr(d["eta4"]), P.arr(d["k4"]), bax, bax)
    return top, bot


WALK_RTOL, WALK_FRAC = 5e-3, 0.98


def assert_walk_same(jo, to):
    """layered_sample's tolerance (module docstring)."""
    for k, a in jo.items():
        b = to[k]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=k)
            continue
        close = np.isclose(b, a, rtol=RTOL, atol=ATOL, equal_nan=True)
        close = close.reshape(len(close), -1).all(-1)
        assert close.mean() >= WALK_FRAC, (k, close.mean())
        np.testing.assert_allclose(b, a, rtol=WALK_RTOL, atol=ATOL, equal_nan=True, err_msg=k)


def _layered(P, d, what, bottom, medium, grazing):
    top, bot = _layers(P, d, bottom)
    wo, wi = P.arr(_wo(d, grazing)), P.arr(d["wi"])
    key = P.keys(d["key"])
    th, g = P.arr(d["thickness"]), P.arr(d["g"])
    albedo = P.arr(d["albedo"] if medium else np.zeros_like(d["albedo"]))
    if what == "f":
        return P.ly.layered_f(top, bot, wo, wi, key, th, albedo, g, medium)
    if what == "sample":
        return P.ly.layered_sample(top, bot, wo, P.arr(d["uc"]), P.arr(d["u2"]), key, th, albedo,
                                   g, medium)
    return P.ly.layered_pdf(top, bot, wo, wi, key)


# Each bottom with and without a medium, one of the two on grazing wo.
CASES = [(w, b, m, gz) for w in ("f", "sample") for b, m, gz in
         (("diffuse", False, False), ("diffuse", True, True), ("conductor", False, True),
          ("conductor", True, False))]
CASES += [("pdf", b, False, gz) for b in ("diffuse", "conductor") for gz in (False, True)]


@pytest.mark.parametrize(
    "what,bottom,medium,grazing", CASES,
    ids=[f"{w}-{b}-{'medium' if m else 'clear'}-{'grazing' if gz else 'sphere'}"
         for w, b, m, gz in CASES],
)
def test_layered_matches_reference(what, bottom, medium, grazing):
    def case(P, d):
        return _layered(PACKAGES["jax" if P is J else "torch"], d, what, bottom, medium, grazing)

    if what == "sample":
        out, to = run_both(case, L)
        assert_walk_same(out, to)
        assert out["valid"].any() and out["pdf_is_proportional"][out["valid"]].all()
    else:
        out = check(case, L)
        assert np.isfinite(out).all() and (out > 0).any()


def _coated_materials(medium):
    albedo = _coeffs([0.7, 0.6, 0.5]) if medium else np.zeros(3)
    return [
        {"kind": 4, "reflectance_coeffs": _coeffs([0.5, 0.3, 0.2]), "uroughness": 0.1,
         "vroughness": 0.2, "thickness": 0.05, "albedo_coeffs": albedo, "g": 0.3},
        {"kind": 5, "eta_spec": 3, "k_spec": 4, "eta_float": 1.6, "thickness": 0.1,
         "albedo_coeffs": albedo, "g": -0.2, "bot_uroughness": 0.2, "bot_vroughness": 0.1},
        {"kind": 5, "reflectance_coeffs": _coeffs([0.9, 0.7, 0.4]), "uroughness": 0.3,
         "vroughness": 0.3},
    ]


@pytest.mark.parametrize("what", ["f", "sample", "pdf"])
def test_coated_dispatch_with_layer_medium_matches_reference(what):
    """The material table's layer_medium census reaches the walks."""
    mats = _coated_materials(medium=True)
    assert JL.table(mats).layer_medium and TL.table(mats).layer_medium
    jo, to = run_both(lambda P, d: _dispatch(P, d, what, mats=mats), L)
    if what == "sample":
        assert_walk_same(jo, to)
    else:
        assert_same(jo, to)


# --- tests/test_layered.py's oracles, against both packages ---

ON = 1 << 15
WO = np.broadcast_to(_unit(np.array([[0.3, 0.1, 0.9]])), (ON, 3)).copy()


def _uniforms(P, n, salt):
    key = np.arange(n, dtype=np.uint32)
    k = P.keys(key)
    u = lambda s: P.rng.u32_to_unit_float(P.rng.pcg_hash(k + s))  # noqa: E731
    stack = jnp.stack if P is JL else torch.stack
    return k, u(salt), stack([u(salt + 101), u(salt + 202)], -1)


def _coat(P, n, alpha=0.2, eta=1.5, refl=0.7):
    ones = P.arr(np.ones(n, np.float32))
    top = P.ly._TopInterface(eta * ones, alpha * ones, alpha * ones)
    bot = P.ly._DiffuseBottom(P.arr(np.full((n, 4), refl, np.float32)))
    return top, bot, 0.01 * ones, P.arr(np.zeros((n, 4), np.float32)), 0.0 * ones


def _albedo(s):
    s = to_numpy(s)
    est = np.where(s["valid"], s["f"][..., 0] * np.abs(s["wi"][..., 2]) / np.maximum(s["pdf"], 1e-12), 0.0)
    return float(np.mean(est))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sample_f_energy_conservation_and_analytic(pkg):
    """Directional albedo from sample_f is below 1 and close to the
    analytic interreflection series of a smooth coat over a Lambertian
    base."""
    P = PACKAGES[pkg]
    wo = P.arr(WO)
    top, bot, th, alb, g = _coat(P, ON, alpha=0.0)
    key, u1, u2 = _uniforms(P, ON, 7)
    assert 0.35 < _albedo(P.ly.layered_sample(top, bot, wo, u1, u2, key, th, alb, g, False)) < 0.60
    top, bot, th, alb, g = _coat(P, ON, alpha=0.0, refl=1.0)
    assert _albedo(P.ly.layered_sample(top, bot, wo, u1, u2, key, th, alb, g, False)) < 1.02


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_f_matches_sample_estimator(pkg):
    """A uniform-sphere estimate of f() agrees with the sample_f albedo."""
    P = PACKAGES[pkg]
    wo = P.arr(WO)
    top, bot, th, alb, g = _coat(P, ON, alpha=0.2)
    key, u1, u2 = _uniforms(P, ON, 31)
    a_sample = _albedo(P.ly.layered_sample(top, bot, wo, u1, u2, key, th, alb, g, False))
    wi_u = P.sp.sample_uniform_sphere(u2)
    fv = to_numpy(P.ly.layered_f(top, bot, wo, wi_u, key + 91, th, alb, g, False))
    a_f = float(np.mean(fv[..., 0] * np.abs(to_numpy(wi_u)[..., 2])) * 4 * np.pi)
    assert a_sample == pytest.approx(a_f, rel=0.15)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_two_sided_symmetry(pkg):
    """Evaluating from below equals evaluating from above."""
    P = PACKAGES[pkg]
    wo = P.arr(WO)
    top, bot, th, alb, g = _coat(P, ON, alpha=0.2)
    key, u1, u2 = _uniforms(P, ON, 57)
    wi = P.sp.sample_uniform_sphere(u2)
    f_up = P.ly.layered_f(top, bot, wo, wi, key, th, alb, g, False)
    f_dn = P.ly.layered_f(top, bot, -wo, -wi, key, th, alb, g, False)
    np.testing.assert_allclose(to_numpy(f_up), to_numpy(f_dn), rtol=1e-5)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_pdf_positive_and_bounded(pkg):
    P = PACKAGES[pkg]
    top, bot, th, alb, g = _coat(P, ON, alpha=0.2)
    key, u1, u2 = _uniforms(P, ON, 77)
    p = to_numpy(P.ly.layered_pdf(top, bot, P.arr(WO), P.sp.sample_uniform_sphere(u2), key))
    assert np.all(p >= 0.1 / (4 * np.pi) - 1e-7)  # the uniform floor
    assert np.all(np.isfinite(p))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_coated_conductor_runs(pkg):
    """The coated-conductor walk gives finite, non-black samples."""
    P = PACKAGES[pkg]
    ones = P.arr(np.ones(ON, np.float32))
    top = P.ly._TopInterface(1.5 * ones, 0.1 * ones, 0.1 * ones)
    bot = P.ly._ConductorBottom(P.arr(np.full((ON, 4), 0.2, np.float32)),
                                P.arr(np.full((ON, 4), 3.9, np.float32)), 0.2 * ones, 0.2 * ones)
    key, u1, u2 = _uniforms(P, ON, 99)
    a = _albedo(P.ly.layered_sample(top, bot, P.arr(WO), u1, u2, key, 0.01 * ones,
                                    P.arr(np.zeros((ON, 4), np.float32)), 0.0 * ones, False))
    assert np.isfinite(a) and 0.3 < a < 1.05


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_medium_albedo_reduces_nothing_blows_up(pkg):
    """With a scattering medium in the layer the estimators stay finite
    and the energy bounded."""
    P = PACKAGES[pkg]
    ones = P.arr(np.ones(ON, np.float32))
    top = P.ly._TopInterface(1.5 * ones, 0.0 * ones, 0.0 * ones)
    bot = P.ly._DiffuseBottom(P.arr(np.full((ON, 4), 0.5, np.float32)))
    key, u1, u2 = _uniforms(P, ON, 123)
    th, alb, g = 0.3 * ones, P.arr(np.full((ON, 4), 0.8, np.float32)), 0.3 * ones
    a = _albedo(P.ly.layered_sample(top, bot, P.arr(WO), u1, u2, key, th, alb, g, True))
    assert np.isfinite(a) and 0.0 < a < 1.1
    wi_u = P.sp.sample_uniform_sphere(u2)
    fv = to_numpy(P.ly.layered_f(top, bot, P.arr(WO), wi_u, key + 5, th, alb, g, True))
    assert np.isfinite(fv).all()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_material_dispatch_coated(pkg):
    """The material-table dispatch reaches the layered BxDFs."""
    P = PACKAGES[pkg]
    mats = P.table([{"kind": 4, "reflectance_coeffs": _coeffs([0.6, 0.3, 0.2]),
                     "uroughness": 0.1, "vroughness": 0.1, "eta_float": 1.5}])
    n = 256
    key, u1, u2 = _uniforms(P, n, 11)
    # SampledWavelengths.sample_uniform(0.3), as the reference test draws them.
    lam = 360.0 + 0.3 * 470.0 + np.arange(4) * 117.5
    lam = np.tile(np.where(lam > 830.0, lam - 470.0, lam).astype(np.float32), (n, 1))
    swl = P.swl(lam, np.full((n, 4), 1.0 / 470.0, np.float32))
    mat_id = P.arr(np.zeros(n, np.int32))
    z = P.arr(np.tile(np.float32([0, 0, 1]), (n, 1)))
    frame = P.vm.Frame.from_z(z)
    wo = P.arr(np.tile(_unit(np.array([[0.4, 0.2, 0.89]])), (n, 1)))
    s = to_numpy(P.mtl.bsdf_sample(mats, (4,), mat_id, frame, z, wo, u2, u1, swl, rng_key=key))
    assert np.mean(s["valid"]) > 0.5
    wi = P.sp.sample_uniform_sphere(u2)
    f = to_numpy(P.mtl.bsdf_f(mats, (4,), mat_id, frame, z, wo, wi, swl, rng_key=key))
    p = to_numpy(P.mtl.bsdf_pdf(mats, (4,), mat_id, frame, z, wo, wi, swl, rng_key=key))
    assert np.isfinite(f).all() and (p >= 0).all()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_mix_resolution(pkg):
    P = PACKAGES[pkg]
    mats = P.table([{"kind": 0}, {"kind": 1},
                    {"kind": 6, "mix_amount": 0.25, "mix_m1": 0, "mix_m2": 1}])
    n = 1 << 14
    _, u1, _ = _uniforms(P, n, 3)
    out = to_numpy(P.mtl.resolve_mix(mats, (0, 1, 6), P.arr(np.full(n, 2, np.int32)), u1))
    assert out.dtype == np.int32
    assert float(np.mean(out == 0)) == pytest.approx(0.25, abs=0.02)
    assert not np.any(out == 2)


def test_walks_draw_the_reference_stream():
    """The port's _Rng hashes (key, counter) as the reference's does."""
    key = L["key"][:64]
    jr, tr = jly._Rng(jnp.asarray(key)), tly._Rng(torch.from_numpy(key.astype(np.int64)))
    for _ in range(3):
        assert_same(np.asarray(jr.u1()), tr.u1().numpy())
        assert_same(np.asarray(jr.u2()), tr.u2().numpy())
