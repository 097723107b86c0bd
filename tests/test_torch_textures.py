"""The port's texture system (shimmer_tpu_torch/textures/, film/image.py's
reading and pyramids, the texture footprints) against the reference's, on
the CPU.

- Tables built on the host are held byte-equal: the atlas, the level
  offsets and sizes, the fitted coefficients and every parameter column,
  for float and spectrum (albedo and unbounded) images, pyramids of a size
  that is not a power of two, every mapping and the combinators.
- Evaluation runs the reference op by op on the same seeded inputs.  The
  payloads agree within rtol 1e-5 / atol 1e-6 (``TOL``): the level of
  detail takes a log2 and the non-UV mappings an acos or atan2, which the
  two CPU libraries may round an ulp apart; everything else is the same
  float32 arithmetic in the same order.  Every case of
  tests/test_textures.py::TestTextureTable runs against both packages
  with its own assertion, and a sweep covers wrap x filter x mapping.
- ``apply_normal_bump`` (which the reference has no test of) and
  ``evaluate_material_textures`` are held against the reference's within
  ``TOL``, and so are the footprints of ``with_camera_differentials``
  (they normalize the ray direction by rsqrt, which differs by up to 2
  ulps between the packages: ROADMAP queue 3).
- ``Image.read`` gives the reference's arrays byte for byte for PNG, JPEG,
  BMP and PFM files written here, and ``generate_pyramid`` its levels.
"""

import dataclasses
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.film.image import Image as JImage
from shimmer_tpu.materials import material as jmtl
from shimmer_tpu.shapes.interaction import SurfaceInteraction as JSI
from shimmer_tpu.spectra.sampled import SampledWavelengths as JSwl
from shimmer_tpu.textures import normal_bump as jnb
from shimmer_tpu.textures import textures as jtx
from shimmer_tpu_torch.film.image import Image as TImage
from shimmer_tpu_torch.materials import material as tmtl
from shimmer_tpu_torch.shapes.interaction import SurfaceInteraction as TSI
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths as TSwl
from shimmer_tpu_torch.textures import normal_bump as tnb
from shimmer_tpu_torch.textures import textures as ttx

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


# --- inputs made once for both packages ---


def _lanes(rng, n, uv=None, spread=0.0):
    """Seeded interaction fields: (valid, t, p, n, uv, wo, dpdu, dpdv, ns,
    dpdus, footprint) as numpy."""
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dpdu = rng.normal(size=(n, 3)).astype(np.float32)
    dpdv = rng.normal(size=(n, 3)).astype(np.float32)
    f = {
        "valid": np.ones(n, bool),
        "t": rng.uniform(0.5, 5.0, n).astype(np.float32),
        "p": rng.normal(size=(n, 3)).astype(np.float32),
        "n": nrm,
        "uv": (rng.uniform(-0.5, 1.5, (n, 2)) if uv is None else np.asarray(uv)).astype(np.float32),
        "wo": nrm.copy(),
        "dpdu": dpdu,
        "dpdv": dpdv,
    }
    fp = {k: (rng.normal(size=n) * spread).astype(np.float32) for k in ("dudx", "dvdx", "dudy", "dvdy")}
    return f, fp


def _si_both(f, fp=None, material_id=None):
    """The same interaction as a reference and a port record."""
    n = f["t"].shape[0]
    fp = fp or {k: np.zeros(n, np.float32) for k in ("dudx", "dvdx", "dudy", "dvdy")}
    mid = None if material_id is None else np.asarray(material_id, np.int32)
    jsi = JSI.make(**{k: jnp.asarray(v) for k, v in f.items()},
                   material_id=None if mid is None else jnp.asarray(mid))
    jsi = dataclasses.replace(jsi, **{k: jnp.asarray(v) for k, v in fp.items()})
    tsi = TSI.make(**{k: torch.from_numpy(v.copy()) for k, v in f.items()},
                   material_id=None if mid is None else torch.from_numpy(mid.copy()))
    tsi = dataclasses.replace(tsi, **{k: torch.from_numpy(v.copy()) for k, v in fp.items()})
    return jsi, tsi


def _si_at(uv, dudx=0.0, n=None, p=None):
    """tests/test_textures.py's _si_at for both packages."""
    uv = np.atleast_2d(uv).astype(np.float32)
    k = uv.shape[0]
    f = {
        "valid": np.ones(k, bool), "t": np.ones(k, np.float32),
        "p": np.zeros((k, 3), np.float32) if p is None else np.asarray(p, np.float32),
        "n": np.tile(np.float32([0, 0, 1]), (k, 1)) if n is None else np.asarray(n, np.float32),
        "uv": uv, "wo": np.tile(np.float32([0, 0, 1]), (k, 1)),
        "dpdu": np.tile(np.float32([1, 0, 0]), (k, 1)), "dpdv": np.tile(np.float32([0, 1, 0]), (k, 1)),
    }
    z = np.zeros(k, np.float32)
    d = np.full(k, dudx, np.float32)
    return _si_both(f, {"dudx": d, "dvdx": z, "dudy": z, "dvdy": d})


def _builders():
    return jtx.TextureBuilder(), ttx.TextureBuilder()


def _both(method, *args, **kwargs):
    """Call a TextureBuilder method on both builders; return the id."""
    jb, tb = _BUILDERS
    a = getattr(jb, method)(*args, **kwargs)
    b = getattr(tb, method)(*args, **kwargs)
    assert a == b
    return a


_BUILDERS = None


def _tables(fill):
    """Fill both builders with ``fill(add)`` and build both tables."""
    global _BUILDERS
    _BUILDERS = _builders()
    ids = fill(_both)
    return _BUILDERS[0].build(), _BUILDERS[1].build(device="cpu"), ids


# A census field of the reference's table that nothing in the port reads.
REFERENCE_ONLY = ("max_levels",)


def assert_tables_equal(jt, tt):
    for f in dataclasses.fields(jt):
        if f.name in REFERENCE_ONLY:
            assert not hasattr(tt, f.name), f.name
            continue
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if f.metadata.get("static", False):
            assert tuple(np.atleast_1d(a)) == tuple(np.atleast_1d(b)), f.name
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, f.name
        assert b.tobytes() == a.tobytes(), f.name


def _eval(jt, tt, tid, jsi, tsi, what="raw", swl=None):
    tid = np.broadcast_to(np.int32(tid), jsi.t.shape).copy()
    if what == "raw":
        a = jtx.eval_texture_raw(jt, jnp.asarray(tid), jsi)
        b = ttx.eval_texture_raw(tt, torch.from_numpy(tid), tsi)
    elif what == "float":
        a = jtx.eval_float_texture(jt, jnp.asarray(tid), jsi)
        b = ttx.eval_float_texture(tt, torch.from_numpy(tid), tsi)
    else:
        a = jtx.eval_spectrum_texture(jt, jnp.asarray(tid), jsi, swl[0])
        b = ttx.eval_spectrum_texture(tt, torch.from_numpy(tid), tsi, swl[1])
    a, b = np.asarray(a), b.numpy()
    np.testing.assert_allclose(b, a, **TOL)
    return a, b


def _swl(lam):
    lam = np.asarray(lam, np.float32)
    pdf = np.ones_like(lam)
    return (JSwl(lam=jnp.asarray(lam), pdf=jnp.asarray(pdf)),
            TSwl(lam=torch.from_numpy(lam.copy()), pdf=torch.from_numpy(pdf)))


def _checker(n=16):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    c = ((xx // 2 + yy // 2) % 2).astype(np.float32)
    return np.stack([c, np.zeros_like(c), 1.0 - c], axis=-1)


# --- tables ---


def test_texture_tables_byte_equal():
    rng = np.random.default_rng(1)

    def fill(add):
        a = add("add_image", rng.uniform(0, 1, (12, 20)).astype(np.float32), False,
                filter_kind=jtx.FILTER_EWA, wrap=jtx.WRAP_CLAMP, uv_scale=(2.0, 3.0),
                uv_delta=(0.1, -0.2), invert=True, scale=0.7)
        b = add("add_image", rng.uniform(0, 1, (16, 16, 3)).astype(np.float32), True,
                mapping=jtx.MAP_SPHERICAL, world_to_tex=rng.normal(size=(4, 4)))
        c = add("add_image", rng.uniform(0, 3, (5, 9, 3)).astype(np.float32), True,
                spectrum_type="unbounded", mapping=jtx.MAP_PLANAR,
                planar_vs=[[1, 0, 0], [0, 0, 1]], max_levels=3)
        d = add("add_constant_float", 0.25)
        e = add("add_constant_spectrum_coeffs", [0.1, -0.2, 0.3], 2.0)
        f = add("add_scaled", a, d)
        g = add("add_mix", b, e, amount_tex=a)
        h = add("add_direction_mix", b, c, (0.0, 1.0, 0.0))
        return a, b, c, d, e, f, g, h

    jt, tt, _ = _tables(fill)
    assert_tables_equal(jt, tt)
    assert tt.filters_present == (jtx.FILTER_TRILINEAR, jtx.FILTER_EWA)
    assert tt.mappings_present == (jtx.MAP_UV, jtx.MAP_SPHERICAL, jtx.MAP_PLANAR)


# --- tests/test_textures.py::TestTextureTable against both packages ---


def test_constant_float():
    jt, tt, tid = _tables(lambda add: add("add_constant_float", 0.7))
    a, b = _eval(jt, tt, tid, *_si_at([[0.5, 0.5]]), "float")
    assert np.isclose(float(b[0]), 0.7)


def test_image_float_fetch():
    img = np.zeros((8, 8), np.float32)
    img[0, 0] = 1.0
    jt, tt, tid = _tables(lambda add: add("add_image", img, False, filter_kind=jtx.FILTER_POINT))
    a, b = _eval(jt, tt, tid, *_si_at([[0.01, 0.01], [0.6, 0.6]]), "float")
    assert b[0] == 1.0 and b[1] == 0.0


def test_mip_level_selection():
    img = np.zeros((32, 32), np.float32)
    img[::2] = 1.0
    jt, tt, tid = _tables(lambda add: add("add_image", img, False,
                                          filter_kind=jtx.FILTER_TRILINEAR))
    _, sharp = _eval(jt, tt, tid, *_si_at([[0.25, 0.265]], dudx=1e-4), "float")
    _, blurred = _eval(jt, tt, tid, *_si_at([[0.25, 0.265]], dudx=0.5), "float")
    assert abs(float(blurred[0]) - 0.5) < 0.1
    assert abs(float(sharp[0]) - 0.5) > 0.3


def test_spectrum_texture_uplift():
    jt, tt, tid = _tables(lambda add: add("add_image", _checker(8), True,
                                          filter_kind=jtx.FILTER_POINT))
    swl = _swl(np.tile(np.float32([420.0, 510.0, 600.0, 690.0]), (2, 1)))
    _, s = _eval(jt, tt, tid, *_si_at([[0.01, 0.01], [0.3, 0.01]]), "spectrum", swl)
    assert np.all(s >= 0.0) and np.all(s <= 1.05)
    assert np.abs(s[0] - s[1]).max() > 0.1


def test_ewa_runs():
    jt, tt, tid = _tables(lambda add: add("add_image", _checker(16), True,
                                          filter_kind=jtx.FILTER_EWA))
    swl = _swl(np.float32([[450.0, 520.0, 580.0, 640.0]]))
    _, v = _eval(jt, tt, tid, *_si_at([[0.3, 0.4]], dudx=0.1), "spectrum", swl)
    assert np.all(np.isfinite(v))


def test_scaled_and_mix():
    def fill(add):
        ta = add("add_constant_float", 0.8)
        tb = add("add_constant_float", 0.5)
        return add("add_scaled", ta, tb)

    jt, tt, ts = _tables(fill)
    _, v = _eval(jt, tt, ts, *_si_at([[0.5, 0.5]]), "float")
    assert np.isclose(float(v[0]), 0.4)


def test_mix_textured_amount():
    img = np.zeros((8, 8), np.float32)
    img[:, 4:] = 1.0

    def fill(add):
        ta = add("add_constant_float", 2.0)
        tb = add("add_constant_float", 6.0)
        tc = add("add_image", img, False, filter_kind=jtx.FILTER_POINT)
        return add("add_mix", ta, tb, amount_tex=tc)

    jt, tt, tm = _tables(fill)
    assert tt.has_amount_tex
    _, v = _eval(jt, tt, tm, *_si_at([[0.1, 0.5], [0.9, 0.5]]), "float")
    np.testing.assert_allclose(v, [2.0, 6.0], atol=1e-5)


def test_direction_mix():
    def fill(add):
        ta = add("add_constant_float", 2.0)
        tb = add("add_constant_float", 4.0)
        return add("add_direction_mix", ta, tb, (0.0, 0.0, 1.0))

    jt, tt, td = _tables(fill)
    n = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
    _, v = _eval(jt, tt, td, *_si_at([[0.5, 0.5]] * 3, n=n), "float")
    np.testing.assert_allclose(v, [4.0, 0.0, 2.0], atol=1e-5)


def test_cylindrical_mapping():
    img = np.random.default_rng(3).uniform(size=(16, 16)).astype(np.float32)

    def fill(add):
        return (add("add_image", img, False, filter_kind=jtx.FILTER_POINT,
                    mapping=jtx.MAP_CYLINDRICAL),
                add("add_image", img, False, filter_kind=jtx.FILTER_POINT))

    jt, tt, (t_cyl, t_uv) = _tables(fill)
    phi = np.array([0.0, 1.2, -2.0], np.float32)
    z = np.array([0.1, 0.4, 0.8], np.float32)
    p = np.stack([np.cos(phi), np.sin(phi), z], axis=-1)
    _, got = _eval(jt, tt, t_cyl, *_si_at(np.zeros((3, 2)), p=p), "float")
    uv = np.stack([(np.pi + phi) / (2 * np.pi), z], axis=-1)
    _, want = _eval(jt, tt, t_uv, *_si_at(uv), "float")
    np.testing.assert_allclose(got, want, atol=1e-6)


# --- the sweep ---

WRAPS = {"repeat": jtx.WRAP_REPEAT, "clamp": jtx.WRAP_CLAMP, "black": jtx.WRAP_BLACK}
FILTERS = {"point": jtx.FILTER_POINT, "bilinear": jtx.FILTER_BILINEAR,
           "trilinear": jtx.FILTER_TRILINEAR, "ewa": jtx.FILTER_EWA}
MAPPINGS = {"uv": jtx.MAP_UV, "spherical": jtx.MAP_SPHERICAL,
            "cylindrical": jtx.MAP_CYLINDRICAL, "planar": jtx.MAP_PLANAR}


@pytest.mark.parametrize("mapping", list(MAPPINGS))
@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("wrap", list(WRAPS))
def test_image_sweep_matches_reference(wrap, filt, mapping):
    """A 12x20 image (a 16x32 pyramid after the resample) behind a constant
    row, so the image row is not row 0; uv in [-0.5, 1.5), random
    footprints and points, and a world_to_tex with a translation."""
    rng = np.random.default_rng(zlib.crc32(f"{wrap} {filt} {mapping}".encode()))
    img = rng.uniform(0, 1, (12, 20)).astype(np.float32)
    w2t = np.eye(4)
    w2t[:3, :3] = rng.normal(size=(3, 3))
    w2t[:3, 3] = rng.normal(size=3)

    def fill(add):
        add("add_constant_float", 0.3)
        return add("add_image", img, False, filter_kind=FILTERS[filt], wrap=WRAPS[wrap],
                   mapping=MAPPINGS[mapping], uv_scale=(1.5, 0.75), uv_delta=(0.1, 0.2),
                   world_to_tex=w2t, planar_vs=[[0.5, 0.5, 0], [0, 0.3, 0.9]])

    jt, tt, tid = _tables(fill)
    f, fp = _lanes(rng, 256, spread=0.05)
    a, b = _eval(jt, tt, tid, *_si_both(f, fp), "raw")
    assert np.isfinite(b).all() and np.abs(b).max() > 0


def test_combinators_over_images_match_reference():
    """Scale, mix (constant and textured amount) and direction mix over
    image and constant operands, evaluated for a lane set whose ids cover
    every row (the batched lookups against the reference's one by one)."""
    rng = np.random.default_rng(4)

    def fill(add):
        a = add("add_image", rng.uniform(0, 1, (8, 8)).astype(np.float32), False,
                filter_kind=jtx.FILTER_EWA)
        b = add("add_image", rng.uniform(0, 1, (8, 8, 3)).astype(np.float32), True,
                filter_kind=jtx.FILTER_BILINEAR)
        c = add("add_constant_float", 0.5)
        add("add_scaled", a, c)
        add("add_mix", a, c, 0.3)
        add("add_mix", b, c, amount_tex=a)
        add("add_direction_mix", b, c, (0.0, 1.0, 0.0))
        return 7

    jt, tt, n_rows = _tables(fill)
    f, fp = _lanes(rng, 64, spread=0.02)
    tid = np.arange(64, dtype=np.int32) % n_rows
    jsi, tsi = _si_both(f, fp)
    a = np.asarray(jtx.eval_texture_raw(jt, jnp.asarray(tid), jsi))
    b = ttx.eval_texture_raw(tt, torch.from_numpy(tid), tsi).numpy()
    np.testing.assert_allclose(b, a, **TOL)


# --- footprints, normal and bump maps, material parameters ---


def test_camera_differentials_match_reference():
    rng = np.random.default_rng(5)
    f, _ = _lanes(rng, 256)
    f["t"][:4] = np.inf
    jsi, tsi = _si_both(f)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    spread = 0.0123 * 0.25
    a = jsi.with_camera_differentials(jnp.asarray(d), spread)
    b = tsi.with_camera_differentials(torch.from_numpy(d), spread)
    for k in ("dudx", "dvdx", "dudy", "dvdy"):
        np.testing.assert_allclose(getattr(b, k).numpy(), np.asarray(getattr(a, k)), **TOL,
                                   err_msg=k)


def _map_scene(rng, pkg_tables, pkg_mats, normal: bool, bump: bool):
    return types.SimpleNamespace(textures=pkg_tables, materials=pkg_mats,
                                 has_normal_maps=normal, has_bump_maps=bump)


@pytest.mark.parametrize("maps", ["normal", "bump", "both"])
def test_apply_normal_bump_matches_reference(maps):
    rng = np.random.default_rng(6)
    nm = rng.uniform(0.2, 0.8, (8, 8, 3)).astype(np.float32)
    nm[..., 2] = 1.0

    def fill(add):
        return (add("add_image", nm, False, filter_kind=jtx.FILTER_BILINEAR),
                add("add_image", rng.uniform(0, 0.1, (16, 16)).astype(np.float32), False,
                    filter_kind=jtx.FILTER_TRILINEAR))

    jt, tt, (t_n, t_d) = _tables(fill)
    normal, bump = maps in ("normal", "both"), maps in ("bump", "both")
    mats = [{"kind": 0}, {"kind": 0, "normal_tex": t_n if normal else -1,
                          "displacement_tex": t_d if bump else -1},
            {"kind": 1, "displacement_tex": t_d if bump else -1}]
    jm = jmtl.make_material_table([dict(m) for m in mats])
    tm = tmtl.make_material_table([dict(m) for m in mats], device="cpu")
    f, fp = _lanes(rng, 128, spread=0.01)
    fp["dudx"][:8] = 0.0
    fp["dudy"][:8] = 0.0
    mid = np.arange(128) % 4 - 1  # -1 (a miss) reads the last row, as in the reference
    jsi, tsi = _si_both(f, fp, material_id=mid)
    a = jnb.apply_normal_bump(_map_scene(rng, jt, jm, normal, bump), jsi)
    b = tnb.apply_normal_bump(_map_scene(rng, tt, tm, normal, bump), tsi)
    for k in ("ns", "dpdus"):
        np.testing.assert_allclose(getattr(b, k).numpy(), np.asarray(getattr(a, k)), **TOL)
    changed = np.abs(b.ns.numpy() - f["n"]).max(-1) > 1e-6
    assert changed.any() and not changed[mid == 0].any()


def test_evaluate_material_textures_matches_reference():
    rng = np.random.default_rng(7)

    def fill(add):
        return (add("add_image", rng.uniform(0, 1, (8, 8, 3)).astype(np.float32), True),
                add("add_image", rng.uniform(0.05, 0.5, (8, 8)).astype(np.float32), False,
                    filter_kind=jtx.FILTER_EWA))

    jt, tt, (t_r, t_g) = _tables(fill)
    mats = [{"kind": 0, "reflectance_coeffs": [0.1, 0.2, -1.0]},
            {"kind": 0, "tex_reflectance": t_r},
            {"kind": 1, "uroughness": 0.3, "vroughness": 0.1, "tex_uroughness": t_g},
            {"kind": 1, "tex_uroughness": t_g, "tex_vroughness": t_g}]
    jm = jmtl.make_material_table([dict(m) for m in mats])
    tm = tmtl.make_material_table([dict(m) for m in mats], device="cpu")
    assert tm.textured_params == ("reflectance", "uroughness", "vroughness")
    f, fp = _lanes(rng, 96, spread=0.02)
    jsi, tsi = _si_both(f, fp, material_id=np.arange(96) % 5 - 1)
    swl = _swl(rng.uniform(360, 830, (96, 4)))
    a = jtx.evaluate_material_textures(jt, jm, jsi, swl[0])
    b = ttx.evaluate_material_textures(tt, tm, tsi, swl[1])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), **TOL, err_msg=k)


# --- reading images ---


@pytest.mark.parametrize("fmt", ["png", "png16", "png_rgba", "jpg", "bmp", "pfm", "pfm_gray"])
def test_image_read_matches_reference(tmp_path, fmt):
    from PIL import Image as PILImage

    rng = np.random.default_rng(8)
    if fmt == "png16":
        path = tmp_path / "a.png"
        PILImage.fromarray(rng.integers(0, 65535, (9, 7), dtype=np.uint16)).save(path)
    elif fmt.startswith("pfm"):
        path = tmp_path / "a.pfm"
        shape = (9, 7) if fmt == "pfm_gray" else (9, 7, 3)
        JImage(rng.uniform(0, 4, shape).astype(np.float32)).write(path)
    else:
        ext = {"png": "png", "png_rgba": "png", "jpg": "jpg", "bmp": "bmp"}[fmt]
        path = tmp_path / f"a.{ext}"
        c = 4 if fmt == "png_rgba" else 3
        PILImage.fromarray(rng.integers(0, 255, (9, 7, c), dtype=np.uint8)).save(path)
    a, b = JImage.read(path).data, TImage.read(path).data
    assert b.dtype == a.dtype == np.float32 and b.shape == a.shape
    assert b.tobytes() == a.tobytes()


def test_exr_read_raises():
    with pytest.raises(NotImplementedError, match="imageio"):
        TImage.read("sky.exr")


@pytest.mark.parametrize("shape", [(16, 16, 3), (12, 20), (5, 3, 3), (1, 6)])
def test_pyramid_matches_reference(shape):
    img = np.random.default_rng(9).uniform(0, 1, shape).astype(np.float32)
    a, b = JImage(img).generate_pyramid(), TImage(img).generate_pyramid()
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert lb.data.tobytes() == la.data.tobytes()
    uv = np.random.default_rng(10).uniform(-1, 2, (64, 2))
    from shimmer_tpu.film.image import WrapMode as JW
    from shimmer_tpu_torch.film.image import WrapMode as TW

    modes = ("REPEAT", "CLAMP", "BLACK") + (("OCTAHEDRAL_SPHERE",) if shape[0] == shape[1] else ())
    for mode in modes:
        np.testing.assert_array_equal(TImage(img).bilerp(uv, TW[mode]),
                                      JImage(img).bilerp(uv, JW[mode]))
