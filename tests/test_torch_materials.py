"""Parity of the port's materials (scattering, conductor_dielectric and the
material-table dispatch) with the reference's, and the reference's oracle
checks run against both packages.

The same seeded numpy lanes go through both packages: directions in both
hemispheres, grazing and exactly tangent ones, smooth and rough
(anisotropic) alphas, constant and per-lane eta (eta = 1 and eta < 1
included) and a dispersive spectral eta.  The reference runs op by op
(``jax.disable_jit``), so XLA contracts no FMAs and the two agree to
float32 rounding of the transcendentals: rtol 1e-5 / atol 1e-6, flags and
``valid`` exactly.  Values on lanes that a sample marks invalid are held
too (both packages compute every branch and select).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.color.colorspace import get_named_color_space
from shimmer_tpu.materials import bxdf as jbx
from shimmer_tpu.materials import conductor_dielectric as jcd
from shimmer_tpu.materials import material as jmtl
from shimmer_tpu.materials import scattering as jsc
from shimmer_tpu.ops import sampling as jsp
from shimmer_tpu.ops import vecmath as jvm
from shimmer_tpu.spectra import spectrum as jspec
from shimmer_tpu.spectra.rgb2spec import fit_rgb_coeffs
from shimmer_tpu.spectra.sampled import SampledWavelengths as JSwl
from shimmer_tpu_torch import bench_scene
from shimmer_tpu_torch.materials import bxdf as tbx
from shimmer_tpu_torch.materials import conductor_dielectric as tcd
from shimmer_tpu_torch.materials import material as tmtl
from shimmer_tpu_torch.materials import scattering as tsc
from shimmer_tpu_torch.ops import sampling as tsp
from shimmer_tpu_torch.ops import vecmath as tvm
from shimmer_tpu_torch.spectra import spectrum as tspec
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths as TSwl

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 384


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _directions(rng, n):
    """Uniform over the sphere; every 8th lane grazing (|z| = 1e-3), every
    16th exactly tangent, every 32nd along +-z."""
    v = _unit(rng.normal(size=(n, 3)))
    v[::8, 2] = np.where(rng.random(len(v[::8])) < 0.5, -1e-3, 1e-3)
    v[::16, 2] = 0.0
    v = _unit(v)
    v[::32] = np.array([0.0, 0.0, 1.0], np.float32) * np.sign(rng.normal(size=(len(v[::32]), 1)))
    return v.astype(np.float32)


def _inputs():
    rng = np.random.default_rng(20261017)
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    rough = f(rng.uniform(0.02, 0.9, N))
    alpha_x = np.where(np.arange(N) % 3 == 0, 0.0, rough)
    alpha_y = np.where(np.arange(N) % 3 == 0, 0.0, f(rough * rng.uniform(0.5, 1.5, N)))
    eta = f(rng.uniform(1.2, 2.4, N))
    eta[::7] = 1.0
    eta[1::7] = f(1.0 / rng.uniform(1.2, 2.0, len(eta[1::7])))
    u = rng.random((5, N)).astype(np.float32)
    lam = f(rng.uniform(360.0, 830.0, (N, 4)))
    return {
        "wo": _directions(rng, N),
        "wi": _directions(rng, N),
        "ax": f(np.maximum(alpha_x, 1e-4)),
        "ay": f(np.maximum(alpha_y, 1e-4)),
        "eta": eta,
        "eta4": f(rng.uniform(0.1, 2.5, (N, 4))),
        "k4": f(rng.uniform(0.0, 5.0, (N, 4))),
        "cos": f(rng.uniform(-1.2, 1.2, N)),
        "g": f(rng.uniform(-0.99, 0.99, N) * (np.arange(N) % 5 != 0)),
        "u2": np.stack([u[0], u[1]], -1),
        "uc": u[2],
        "u2b": np.stack([u[3], u[4]], -1),
        "lam": lam,
        "lam_pdf": f(rng.uniform(0.001, 0.01, (N, 4))),
        "roughness": f(rng.uniform(0.0, 1.0, N)),
    }


D = _inputs()

J = types.SimpleNamespace(
    sc=jsc, cd=jcd, bx=jbx, mtl=jmtl, sp=jsp, vm=jvm, spec=jspec,
    arr=lambda x: jnp.asarray(x), swl=lambda lam, pdf: JSwl(lam=jnp.asarray(lam), pdf=jnp.asarray(pdf)),
    table=lambda mats: jmtl.make_material_table(mats),
)
T = types.SimpleNamespace(
    sc=tsc, cd=tcd, bx=tbx, mtl=tmtl, sp=tsp, vm=tvm, spec=tspec,
    arr=lambda x: torch.from_numpy(np.array(x)), swl=lambda lam, pdf: TSwl(lam=torch.from_numpy(lam), pdf=torch.from_numpy(pdf)),
    table=lambda mats: tmtl.make_material_table(mats, device="cpu"),
)


def to_numpy(x):
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return tuple(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def run_both(case, d=D):
    with jax.disable_jit():
        jo = to_numpy(case(J, d))
    return jo, to_numpy(case(T, d))


def assert_same(jo, to, path="out"):
    """Floats within RTOL / ATOL (NaN where the reference has NaN), integer
    and bool fields exactly."""
    if isinstance(jo, dict):
        assert set(jo) == set(to), path
        for k in jo:
            assert_same(jo[k], to[k], f"{path}.{k}")
        return
    if isinstance(jo, tuple):
        assert len(jo) == len(to), path
        for i, (a, b) in enumerate(zip(jo, to)):
            assert_same(a, b, f"{path}[{i}]")
        return
    jo, to = np.asarray(jo), np.asarray(to)
    assert jo.shape == to.shape, (path, jo.shape, to.shape)
    if jo.dtype.kind in "biu":
        np.testing.assert_array_equal(to.astype(jo.dtype), jo, err_msg=path)
    else:
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=path)


def check(case, d=D):
    jo, to = run_both(case, d)
    assert_same(jo, to)
    return jo


# --- scattering ---

SCATTERING = {
    "tr_d": lambda P, d: P.sc.tr_d(P.arr(d["wi"]), P.arr(d["ax"]), P.arr(d["ay"])),
    "tr_lambda": lambda P, d: P.sc.tr_lambda(P.arr(d["wo"]), P.arr(d["ax"]), P.arr(d["ay"])),
    "tr_g1": lambda P, d: P.sc.tr_g1(P.arr(d["wo"]), P.arr(d["ax"]), P.arr(d["ay"])),
    "tr_g": lambda P, d: P.sc.tr_g(P.arr(d["wo"]), P.arr(d["wi"]), P.arr(d["ax"]), P.arr(d["ay"])),
    "tr_pdf": lambda P, d: P.sc.tr_pdf(P.arr(d["wo"]), P.arr(d["wi"]), P.arr(d["ax"]),
                                       P.arr(d["ay"])),
    "tr_sample_wm": lambda P, d: P.sc.tr_sample_wm(P.arr(d["wo"]), P.arr(d["u2"]),
                                                   P.arr(d["ax"]), P.arr(d["ay"])),
    "roughness_to_alpha": lambda P, d: P.sc.roughness_to_alpha(P.arr(d["roughness"])),
    "regularize_alpha": lambda P, d: P.sc.regularize_alpha(P.arr(d["roughness"])),
    "clamp_alpha": lambda P, d: P.sc.clamp_alpha(P.arr(d["roughness"] - 0.5), P.arr(d["ax"])),
    "effectively_smooth": lambda P, d: P.sc.effectively_smooth(P.arr(d["ax"]), P.arr(d["ay"])),
    "reflect": lambda P, d: P.sc.reflect(P.arr(d["wo"]), P.arr(d["wi"])),
    "refract": lambda P, d: P.sc.refract(P.arr(d["wo"]), P.arr(d["wi"]), P.arr(d["eta"])),
    "fresnel_dielectric": lambda P, d: P.sc.fresnel_dielectric(P.arr(d["cos"]), P.arr(d["eta"])),
    "fresnel_complex": lambda P, d: P.sc.fresnel_complex(P.arr(np.abs(d["cos"])[:, None]),
                                                         P.arr(d["eta4"]), P.arr(d["k4"])),
    "henyey_greenstein": lambda P, d: P.sc.henyey_greenstein(P.arr(np.clip(d["cos"], -1, 1)),
                                                             P.arr(d["g"])),
    "sample_henyey_greenstein": lambda P, d: P.sc.sample_henyey_greenstein(
        P.arr(d["wo"]), P.arr(d["g"]), P.arr(d["u2"])),
    "balance_heuristic": lambda P, d: P.sp.balance_heuristic(1.0, P.arr(d["uc"]), 1.0,
                                                             P.arr(d["u2"][:, 0])),
    "sample_exponential": lambda P, d: P.sp.sample_exponential(P.arr(d["uc"]), P.arr(d["eta"])),
    "exponential_pdf": lambda P, d: P.sp.exponential_pdf(P.arr(d["uc"]), P.arr(d["eta"])),
    "sample_uniform_disk_polar": lambda P, d: P.sp.sample_uniform_disk_polar(P.arr(d["u2"])),
    "sample_uniform_hemisphere": lambda P, d: P.sp.sample_uniform_hemisphere(P.arr(d["u2"])),
    "tan2_cos_sin_phi": lambda P, d: (P.vm.tan2_theta(P.arr(d["wo"])), P.vm.cos_phi(P.arr(d["wo"])),
                                      P.vm.sin_phi(P.arr(d["wo"]))),
}


@pytest.mark.parametrize("name", sorted(SCATTERING))
def test_scattering_matches_reference(name):
    check(SCATTERING[name])


# --- conductor, dielectric, thin dielectric ---


def _wo(d, grazing):
    """wo over the sphere, or every lane grazing (|z| <= 0.02)."""
    wo = d["wo"].copy()
    if grazing:
        wo[:, 2] = np.clip(wo[:, 2], -0.02, 0.02)
        wo = _unit(wo)
    return wo


def _bxdf(P, d, fn, grazing, **kw):
    wo, wi, ax, ay = (P.arr(x) for x in (_wo(d, grazing), d["wi"], d["ax"], d["ay"]))
    eta, eta4, k4 = P.arr(d["eta"]), P.arr(d["eta4"]), P.arr(d["k4"])
    u2, uc = P.arr(d["u2"]), P.arr(d["uc"])
    return {
        "conductor_f": lambda: P.cd.conductor_f(eta4, k4, wo, wi, ax, ay),
        "conductor_sample": lambda: P.cd.conductor_sample(eta4, k4, wo, u2, ax, ay),
        "conductor_pdf": lambda: P.cd.conductor_pdf(wo, wi, ax, ay),
        "dielectric_f": lambda: P.cd.dielectric_f(eta, wo, wi, ax, ay, **kw),
        "dielectric_sample": lambda: P.cd.dielectric_sample(eta, wo, u2, uc, ax, ay, **kw),
        "dielectric_pdf": lambda: P.cd.dielectric_pdf(eta, wo, wi, ax, ay, **kw),
        "thin_dielectric_sample": lambda: P.cd.thin_dielectric_sample(eta, wo, uc, **kw),
        "diffuse_sample_f": lambda: P.bx.diffuse_sample_f(
            P.arr(np.abs(d["eta4"]) / 3.0), wo, u2, uc, **kw),
        "diffuse_pdf": lambda: P.bx.diffuse_pdf(wo, wi, **kw),
    }[fn]()


REFL, TRANS, ALL = jbx.SAMPLE_REFLECTION, jbx.SAMPLE_TRANSMISSION, jbx.SAMPLE_ALL
BXDF_CASES = [
    ("conductor_f", {}), ("conductor_sample", {}), ("conductor_pdf", {}),
    ("dielectric_f", {}), ("dielectric_f", {"radiance": False}),
    ("dielectric_sample", {}), ("dielectric_sample", {"radiance": False}),
    ("dielectric_sample", {"sample_flags": REFL}), ("dielectric_sample", {"sample_flags": TRANS}),
    ("dielectric_pdf", {}), ("dielectric_pdf", {"sample_flags": REFL}),
    ("dielectric_pdf", {"sample_flags": TRANS}),
    ("thin_dielectric_sample", {}), ("thin_dielectric_sample", {"sample_flags": TRANS}),
    ("diffuse_sample_f", {"sample_flags": TRANS}), ("diffuse_pdf", {"sample_flags": TRANS}),
]


@pytest.mark.parametrize("grazing", [False, True], ids=["sphere", "grazing"])
@pytest.mark.parametrize(
    "fn,kw", BXDF_CASES,
    ids=[fn + "".join(f"-{k}={v}" for k, v in kw.items()) for fn, kw in BXDF_CASES],
)
def test_bxdf_matches_reference(fn, kw, grazing):
    out = check(lambda P, d: _bxdf(P, d, fn, grazing, **kw))
    if isinstance(out, dict) and fn != "diffuse_sample_f":
        assert out["valid"].any()  # the case exercises real samples


# --- material table and dispatch ---


def _coeffs(rgb):
    return fit_rgb_coeffs(np.asarray([rgb], np.float64), get_named_color_space("srgb"))[0]


def _all_kinds_materials():
    """Every ported kind, smooth and rough, constant and spectral eta; rows
    8 and 9 are mixes (9 of a mix)."""
    c = lambda rgb: np.asarray(_coeffs(rgb), np.float32)  # noqa: E731
    return [
        {"kind": 0, "reflectance_coeffs": c([0.6, 0.3, 0.2])},
        {"kind": 1, "eta_spec": 0, "k_spec": 1, "uroughness": 0.08, "vroughness": 0.2},
        {"kind": 1, "reflectance_coeffs": c([0.9, 0.6, 0.3])},
        {"kind": 2, "eta_spec": 2},
        {"kind": 2, "eta_float": 1.33, "uroughness": 0.1, "vroughness": 0.1},
        {"kind": 3, "eta_float": 1.5},
        {"kind": 4, "reflectance_coeffs": c([0.4, 0.5, 0.6]), "uroughness": 0.05,
         "vroughness": 0.05, "thickness": 0.02},
        {"kind": 5, "eta_spec": 3, "k_spec": 4, "bot_uroughness": 0.1, "bot_vroughness": 0.1},
        {"kind": 6, "mix_amount": 0.3, "mix_m1": 1, "mix_m2": 3},
        {"kind": 6, "mix_amount": 0.6, "mix_m1": 8, "mix_m2": 6},
    ]


def _texture_ctx(P):
    """Per-lane texture-resolved parameters, as evaluate_material_textures
    hands them to the BSDFs: a reflectance spectrum and both roughnesses."""
    rng = np.random.default_rng(13)
    return {"reflectance": P.arr(rng.uniform(0.05, 0.95, (N, 4)).astype(np.float32)),
            "uroughness": P.arr(rng.uniform(0.0, 0.6, N).astype(np.float32)),
            "vroughness": P.arr(rng.uniform(0.0, 0.6, N).astype(np.float32))}


def _dispatch(P, d, what, mats=None, grazing=False, tex=False):
    mats = mats or _all_kinds_materials()
    table = P.table([dict(m) for m in mats])
    kinds = tuple(sorted({m["kind"] for m in mats}))
    spectra = P.arr(bench_scene.material_bench_spectra())
    swl = P.swl(d["lam"], d["lam_pdf"])
    mat_id = P.arr((np.arange(N) % len(mats)).astype(np.int32))
    mat_id = P.mtl.resolve_mix(table, kinds, mat_id, P.arr(d["u2b"][:, 0]))
    if what == "resolve_mix":
        return mat_id
    ns = P.arr(_unit(d["wi"] + np.array([0.3, -0.2, 0.5], np.float32)))
    frame = P.vm.Frame.from_z(ns)
    wo, wi = P.arr(_wo(d, grazing)), P.arr(d["wi"])
    key = np.arange(N, dtype=np.uint64) * 2654435761 % (1 << 32)
    key = P.arr(key.astype(np.int64 if P is T else np.uint32))
    ctx = {"spectra_table": spectra, "rng_key": key}
    if tex:
        ctx["tex"] = _texture_ctx(P)
    if what == "f":
        return P.mtl.bsdf_f(table, kinds, mat_id, frame, ns, wo, wi, swl, **ctx)
    if what == "sample":
        return P.mtl.bsdf_sample(table, kinds, mat_id, frame, ns, wo, P.arr(d["u2"]),
                                 P.arr(d["uc"]), swl, **ctx)
    if what == "pdf":
        return P.mtl.bsdf_pdf(table, kinds, mat_id, frame, ns, wo, wi, swl, **ctx)
    uc = P.arr(np.stack([d["uc"], d["u2b"][:, 1]]))
    u2 = P.arr(np.stack([d["u2"], d["u2b"]]))
    if what == "rho_hd":
        return P.mtl.bsdf_rho_hd(table, kinds, mat_id, frame, ns, wo, swl, uc, u2, **ctx)
    if what == "rho_hh":
        return P.mtl.bsdf_rho_hh(table, kinds, mat_id, frame, ns, swl, P.arr(np.stack([d["u2b"], d["u2"]])),
                                 uc, u2, **ctx)
    raise ValueError(what)


@pytest.mark.parametrize(
    "what,grazing",
    [("resolve_mix", False), ("f", False), ("sample", True), ("pdf", False), ("pdf", True),
     ("rho_hd", False), ("rho_hh", False)],
)
def test_dispatch_matches_reference(what, grazing):
    mats = _all_kinds_materials()
    if what.startswith("rho"):
        # Each of the two estimates runs bsdf_sample twice: one coat walk
        # (the coated diffuse) keeps the op-by-op reference quick.
        mats[7] = {"kind": 0, "reflectance_coeffs": mats[0]["reflectance_coeffs"]}
    out = check(lambda P, d: _dispatch(P, d, what, mats=mats, grazing=grazing))
    if what == "resolve_mix":
        assert set(np.unique(out)) <= {0, 1, 2, 3, 4, 5, 6, 7}
    if what == "sample":
        assert out["valid"].any() and out["pdf_is_proportional"].any()


def test_material_table_matches_reference():
    mats = _all_kinds_materials()
    jt = jmtl.make_material_table([dict(m) for m in mats])
    tt = tmtl.make_material_table([dict(m) for m in mats], device="cpu")
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if isinstance(a, bool):
            assert a == b, f.name
        else:
            assert b.dtype in (torch.float32, torch.int32, torch.bool), f.name
            assert_same(np.asarray(a), b.numpy(), f.name)
    assert tt.has_dispersion and not tt.layer_medium
    kinds = tuple(sorted({m["kind"] for m in mats}))
    assert tmtl.resolved_kinds(kinds) == jmtl.resolved_kinds(kinds) == (0, 1, 2, 3, 4, 5)


@pytest.mark.parametrize(
    "mat",
    [{"kind": tmtl.DIFFUSE_TRANSMISSION}],
    ids=["diffuse_transmission"],
)
def test_unported_material_raises(mat):
    with pytest.raises(NotImplementedError):
        tmtl.make_material_table([mat], device="cpu")


@pytest.mark.parametrize(
    "mat",
    [{"kind": tmtl.CONDUCTOR, "tex_reflectance": 0}, {"kind": tmtl.DIFFUSE, "normal_tex": 1},
     {"kind": tmtl.MIX, "tex_mix_amount": 2}, {"kind": tmtl.DIELECTRIC, "displacement_tex": 0},
     {"kind": tmtl.COATED_DIFFUSE, "tex_uroughness": 0}],
    ids=["textured_reflectance", "normal_map", "textured_mix", "bump_map", "textured_roughness"],
)
def test_textured_material_table_matches_reference(mat):
    """The texture columns the port refused before the texture slice: the
    table equals the reference's, census included, beside an untextured
    row."""
    mats = [{"kind": tmtl.DIFFUSE}, mat]
    jt = jmtl.make_material_table([dict(m) for m in mats])
    tt = tmtl.make_material_table([dict(m) for m in mats], device="cpu")
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if isinstance(a, bool):
            assert a == b, f.name
        else:
            assert_same(np.asarray(a), b.numpy(), f.name)
    textured = {"tex_reflectance": "reflectance", "tex_uroughness": "uroughness"}
    assert tt.textured_params == tuple(v for k, v in textured.items() if k in mat)


def test_dispatch_refuses_kind_7():
    table = tmtl.make_material_table([{"kind": 0}], device="cpu")
    z = torch.tensor([[0.0, 0.0, 1.0]])
    frame = tvm.Frame.from_z(z)
    swl = TSwl(lam=torch.full((1, 4), 550.0), pdf=torch.ones(1, 4))
    with pytest.raises(NotImplementedError):
        tmtl.bsdf_f(table, (0, 7), torch.zeros(1, dtype=torch.int32), frame, z, z, z, swl)


@pytest.mark.parametrize("what", ["f", "sample", "pdf"])
def test_dispatch_with_textured_parameters_matches_reference(what):
    """Every kind with texture-resolved parameters in the BSDF context (a
    reflectance for diffuse, reflectance-mode conductors and both coats'
    bottoms; roughnesses for conductors and dielectrics): the texture half
    of what the dispatch refused before the texture slice."""
    check(lambda P, d: _dispatch(P, d, what, tex=True))


@pytest.mark.parametrize("name", sorted(jspec._NAMED_SPECS))
def test_named_spectra_match_reference(name):
    np.testing.assert_array_equal(tspec.named_spectrum(name).to_dense(),
                                  jspec.named_spectrum(name).to_dense())


# --- the reference's oracle checks, run against both packages ---

PACKAGES = {"jax": J, "torch": T}


def _fresnel_complex_np(cos_i, n2):
    """Complex-IOR Fresnel reflectance from the textbook r_s / r_p forms in
    numpy complex128 (test_specular_oracle.py's own oracle)."""
    cos_i = np.complex128(cos_i)
    sin_i2 = 1.0 - cos_i**2
    cos_t = np.sqrt(1.0 - (1.0 / n2) ** 2 * sin_i2)
    r_s = (cos_i - n2 * cos_t) / (cos_i + n2 * cos_t)
    r_p = (n2 * cos_i - cos_t) / (n2 * cos_i + cos_t)
    return float((abs(r_s) ** 2 + abs(r_p) ** 2) / 2.0)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_smooth_conductor_mirror_is_fresnel(pkg):
    """test_specular_oracle's mirror bounce at the BxDF: a reflectance-mode
    smooth conductor at 45 degrees returns f cos / pdf = F_complex(cos 45)
    with eta = 1, k = 2 sqrt(R) / sqrt(1 - R), within that test's rtol
    2e-2."""
    P, refl = PACKAGES[pkg], 0.8
    mats = [{"kind": 1, "reflectance_coeffs": _coeffs([refl] * 3)}]
    n = 16
    d = dict(D, lam=np.full((n, 4), 550.0, np.float32), lam_pdf=np.ones((n, 4), np.float32))

    def run(P, d):
        table = P.table(mats)
        z = P.arr(np.tile(np.float32([0, 0, 1]), (n, 1)))
        wo = P.arr(np.tile(_unit(np.float32([1, 0, 1])), (n, 1)))
        bs = P.mtl.bsdf_sample(table, (1,), P.arr(np.zeros(n, np.int32)), P.vm.Frame.from_z(z), z,
                               wo, P.arr(d["u2"][:n]), P.arr(d["uc"][:n]), P.swl(d["lam"], d["lam_pdf"]))
        refl_spec = P.mtl.sigmoid_poly_sample(table.reflectance[:1], P.arr(d["lam"][:1]))
        return bs, refl_spec

    with jax.disable_jit():
        bs, refl_spec = to_numpy(run(P, d))
    r = float(refl_spec[0, 0])
    k = 2.0 * np.sqrt(r) / np.sqrt(1.0 - r)
    want = _fresnel_complex_np(np.cos(np.deg2rad(45.0)), 1.0 - 1j * k)
    got = bs["f"][:, 0] * np.abs(bs["wi"][:, 2]) / bs["pdf"]
    assert bs["valid"].all() and (bs["flags"] == jbx.SPECULAR_REFLECTION).all()
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert abs(r - refl) < 0.05


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_glass_slab_transmittance(pkg):
    """test_specular_oracle's glass slab at the BxDF: beams walk between
    two smooth interfaces at normal incidence through dielectric_sample,
    and the weight that leaves through the back converges to the
    incoherent slab series (1 - R) / (1 + R).  Each interface's frame has
    z along its outward normal, so wo is +z at the first hit and -z at
    every hit from inside."""
    P, eta, n, bounces = PACKAGES[pkg], 1.5, 1 << 13, 12
    u = np.random.default_rng(5).random((bounces, n)).astype(np.float32)
    outside, inside = (P.arr(np.tile(np.float32([0, 0, z]), (n, 1))) for z in (1.0, -1.0))
    smooth = P.arr(np.full(n, 1e-4, np.float32))

    def bounce(wo, b):
        s = to_numpy(P.cd.dielectric_sample(P.arr(np.full(n, eta, np.float32)), wo,
                                            P.arr(np.zeros((n, 2), np.float32)), P.arr(u[b]),
                                            smooth, smooth))
        w = np.where(s["valid"], s["f"][:, 0] * np.abs(s["wi"][:, 2]) / s["pdf"], 0.0)
        return w, (s["flags"] & jbx.TRANSMISSION) != 0

    with jax.disable_jit():
        weight, alive = bounce(outside, 0)  # into the glass, or reflected off it
        out, at_back = np.zeros(n), True
        for b in range(1, bounces):
            w, transmitted = bounce(inside, b)
            weight = weight * w
            if at_back:
                out += np.where(alive & transmitted, weight, 0.0)
            alive &= ~transmitted  # left through the back, or lost through the front
            at_back = not at_back
    r = ((eta - 1.0) / (eta + 1.0)) ** 2
    np.testing.assert_allclose(out.mean(), (1.0 - r) / (1.0 + r), rtol=1.5e-2)


def _glass_table(P, eta_row):
    mat = {"kind": 2, "eta_float": 1.5}
    if eta_row is not None:
        mat["eta_spec"] = 0
    return P.table([mat])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_dispersive_census(pkg):
    """test_dispersion's census: a spectral-eta dielectric is dispersive;
    a scalar-eta one is not."""
    P = PACKAGES[pkg]
    t = _glass_table(P, np.ones(471))
    assert t.has_dispersion and bool(np.asarray(to_numpy(t.dispersive))[0])
    assert not _glass_table(P, None).has_dispersion


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_constant_spectral_eta_matches_scalar_eta(pkg):
    """test_dispersion's constant-eta case at the BxDF: a constant dense
    eta row samples and evaluates as the scalar eta does."""
    P = PACKAGES[pkg]
    row = np.full((1, 471), 1.5, np.float32)

    def run(P, d, eta_row):
        table = _glass_table(P, eta_row)
        z = P.arr(np.tile(np.float32([0, 0, 1]), (N, 1)))
        frame = P.vm.Frame.from_z(z)
        swl = P.swl(d["lam"], d["lam_pdf"])
        ids = P.arr(np.zeros(N, np.int32))
        ctx = {"spectra_table": P.arr(row) if eta_row is not None else None}
        return (P.mtl.bsdf_sample(table, (2,), ids, frame, z, P.arr(d["wo"]), P.arr(d["u2"]),
                                  P.arr(d["uc"]), swl, **ctx),
                P.mtl.bsdf_pdf(table, (2,), ids, frame, z, P.arr(d["wo"]), P.arr(d["wi"]), swl, **ctx))

    with jax.disable_jit():
        disp = to_numpy(run(P, D, row))
        const = to_numpy(run(P, D, None))
    assert_same(const, disp)
