"""Bilinear patches in the port (shimmer_tpu_torch/shapes/bilinear.py and
the bilinear warps of ops/sampling.py) against the reference, on the CPU.

- The warps (``sample_linear``, ``linear_pdf``, ``invert_linear_sample``
  and their bilinear forms) within 1e-6, zero weights, the ``denom == 0``
  guard and the ``total <= 0`` pdf of 1 included.
- The patch table byte-equal to ``make_bilinear_data``'s: corners composed
  with a render-from-object and an object-to-world transform in float32 as
  the reference's XLA dot adds on the CPU, areas by the same 4x4
  Gauss-Legendre rule; from ``build_scene`` too (its power light weights
  included).
- Intersection on tests/test_bilinear.py's random curved and flat patches
  with rays aimed at them: ``valid`` equal, ``t``, ``p``, ``uv``, ``dpdu``
  and ``dpdv`` bit-equal to the reference run op by op, ``n`` within 2
  ulps (rsqrt of the two CPU libraries); occlusion equal.  The texture-uv
  chain rule likewise.
- The light sample and its MIS pdf within 1e-5 relative, on lanes whose
  patch ids lie outside the table too (the reference clamps them).
- tests/test_bilinear.py's flat quad against its two triangles, on the
  port.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.ops import sampling as jsm
from shimmer_tpu.ops.transform import Transform as JTransform
from shimmer_tpu.scene_builder import build_scene as jax_build_scene
from shimmer_tpu.shapes import bilinear as jb
from shimmer_tpu.spectra.spectrum import ConstantSpectrum as JConstant
from shimmer_tpu_torch.lights import lights as tlt
from shimmer_tpu_torch.ops import sampling as tsm
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.scene_builder import build_scene
from shimmer_tpu_torch.shapes import bilinear as tb
from shimmer_tpu_torch.shapes.mesh import quad_mesh
from shimmer_tpu_torch.shapes.triangle import build_triangle_scene, triangle_scene_intersect
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum
from torch_parity import ensure_reference_sah, ulp_gap

torch.set_num_threads(1)

PATCH_F32 = ("p00", "p10", "p01", "p11", "uv", "area")


def _random_patch_dicts(rng, n=6, curved=True, uv=False):
    """tests/test_bilinear.py's random patches (optionally with uvs)."""
    out = []
    for _ in range(n):
        c = rng.uniform(-2, 2, 3)
        eu = rng.normal(0, 1, 3)
        ev = rng.normal(0, 1, 3)
        p11 = c + eu + ev
        if curved:
            p11 = p11 + rng.normal(0, 0.4, 3)
        d = {"p00": c, "p10": c + eu, "p01": c + ev, "p11": p11, "material_id": 0}
        if uv:
            d["uv"] = rng.uniform(-1, 2, (4, 2))
        out.append(d)
    return out


def _both_tables(dicts, **kw):
    jd = jb.make_bilinear_data(dicts, **kw.get("jax", {}))
    td = tb.make_bilinear_data(dicts, device="cpu", **kw.get("torch", {}))
    return jd, td


def _assert_table_equal(td, jd):
    for k in PATCH_F32:
        assert getattr(td, k).numpy().tobytes() == np.asarray(getattr(jd, k)).tobytes(), k
    for k in ("material_id", "area_light_id", "reverse"):
        np.testing.assert_array_equal(getattr(td, k).numpy(), np.asarray(getattr(jd, k)), k)
    assert td.has_uv == jd.has_uv


def _aimed_rays(rng, td, n=512):
    """Rays from random origins toward random points of random patches
    (tests/test_bilinear.py::TestIntersect::test_residuals)."""
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    uu = torch.from_numpy(rng.uniform(size=(n, 1)).astype(np.float32))
    vv = torch.from_numpy(rng.uniform(size=(n, 1)).astype(np.float32))
    pi = torch.from_numpy(rng.integers(0, td.p00.shape[0], n))
    target = tb._bilerp(uu, vv, td.p00[pi], td.p10[pi], td.p01[pi], td.p11[pi]).numpy()
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


# --- the warps ---


def _warp_inputs(rng, n=4096):
    u = rng.uniform(size=(n, 2)).astype(np.float32)
    w = rng.uniform(0, 2, (n, 4)).astype(np.float32)
    w[: n // 8] = 0.0                       # total <= 0, a == b == 0
    w[n // 8: n // 4, :2] = 0.0             # a == 0 for v
    a = rng.uniform(0, 2, n).astype(np.float32)
    b = rng.uniform(0, 2, n).astype(np.float32)
    a[:64] = 0.0
    b[:32] = 0.0                            # a == b == 0: the sample is u
    return u, w, a, b


@pytest.mark.parametrize("fn", ["sample_linear", "linear_pdf", "invert_linear_sample",
                                "sample_bilinear", "bilinear_pdf", "invert_bilinear_sample"])
def test_warps_match_reference(fn):
    rng = np.random.default_rng(7)
    u, w, a, b = _warp_inputs(rng)
    x = np.clip(u[:, 0] * 1.1 - 0.05, -0.05, 1.05).astype(np.float32)  # outside [0, 1] too
    if fn in ("sample_linear", "linear_pdf", "invert_linear_sample"):
        arg0 = u[:, 0] if fn == "sample_linear" else x
        args = (arg0, a, b)
    else:
        p = np.stack([x, u[:, 1]], -1) if fn == "bilinear_pdf" else u
        args = (p, w)
    with jax.disable_jit():
        want = np.asarray(getattr(jsm, fn)(*(jnp.asarray(v) for v in args)))
    got = getattr(tsm, fn)(*(torch.from_numpy(v) for v in args)).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=1e-6)
    if fn == "sample_linear":
        assert got.max() <= np.float32(1.0 - 1e-7)
        np.testing.assert_array_equal(got[:32], u[:32, 0])
    if fn == "bilinear_pdf":
        inside = (x[: len(x) // 8] >= 0) & (x[: len(x) // 8] <= 1)
        np.testing.assert_array_equal(got[: len(x) // 8][inside], 1.0)


# --- the table ---


@pytest.mark.parametrize("transforms", ["none", "render_from_object", "both"])
def test_patch_table_matches_reference(transforms):
    rng = np.random.default_rng(3)
    dicts = _random_patch_dicts(rng, n=9, uv=True)
    m = np.eye(4)
    m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * 1.7
    m[:3, 3] = rng.normal(size=3)
    o2w = np.eye(4)
    o2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * 0.6
    o2w[:3, 3] = rng.normal(size=3)
    jkw, tkw = {}, {}
    if transforms != "none":
        jkw["render_from_object"] = JTransform(m=jnp.asarray(m, jnp.float32),
                                               m_inv=jnp.asarray(np.linalg.inv(m), jnp.float32))
        tkw["render_from_object"] = Transform.from_matrix(m)
    jdicts, tdicts = dicts, dicts
    if transforms == "both":
        jdicts = [dict(d, object_to_world=JTransform(
            m=jnp.asarray(o2w, jnp.float32), m_inv=jnp.asarray(np.linalg.inv(o2w), jnp.float32)))
            for d in dicts]
        tdicts = [dict(d, object_to_world=Transform.from_matrix(o2w)) for d in dicts]
    jd = jb.make_bilinear_data(jdicts, **jkw)
    td = tb.make_bilinear_data(tdicts, device="cpu", **tkw)
    _assert_table_equal(td, jd)
    assert td.p00.dtype == torch.float32 and td.material_id.dtype == torch.int32


def test_compose_matches_xla_dot():
    """The float32 4x4 product the patch corners go through, against
    jnp's on random matrices: every element bit-equal."""
    rng = np.random.default_rng(5)
    for _ in range(50):
        a = rng.normal(size=(4, 4)).astype(np.float32)
        b = rng.normal(size=(4, 4)).astype(np.float32)
        want = np.asarray(jnp.asarray(a) @ jnp.asarray(b))
        assert tb.compose_f32(a, b).tobytes() == want.tobytes()


def test_build_scene_patch_light_matches_reference():
    """build_scene with patches, a patch area light (shape kind 2) and the
    power light sampler: the patch table and every light column and weight
    equal to the reference's; the patch's area enters its power."""
    ensure_reference_sah()
    rng = np.random.default_rng(9)
    dicts = _random_patch_dicts(rng, n=3, curved=True)
    dicts[1]["area_light_id"] = 0
    m = np.eye(4)
    m[:3, 3] = (0.3, -0.2, 1.0)
    lights = [{"kind": 3, "spectrum": None, "scale": 4.0, "shape_kind": 2, "shape_idx": 1},
              {"kind": 4, "spectrum": None, "scale": 0.5}]
    jl = [dict(ld, spectrum=JConstant(2.0)) for ld in lights]
    tl = [dict(ld, spectrum=ConstantSpectrum(2.0)) for ld in lights]
    mats = [{"kind": 0, "reflectance": [0.5, 0.4, 0.3]}]
    jsc = jax_build_scene(patches=dicts, materials=mats, lights=jl, light_sampler="power",
                          render_from_world=JTransform(m=jnp.asarray(m, jnp.float32),
                                                       m_inv=jnp.asarray(np.linalg.inv(m),
                                                                         jnp.float32)))
    tsc = build_scene(None, patches=dicts, materials=mats, lights=tl, light_sampler="power",
                      render_from_world=Transform.from_matrix(m), device="cpu")
    assert tsc.has_patches and not tsc.has_triangles and not tsc.has_instanced
    _assert_table_equal(tsc.patches, jsc.patches)
    for f in ("kind", "shape_idx", "shape_kind", "scale", "scene_radius"):
        np.testing.assert_array_equal(getattr(tsc.lights, f).numpy(),
                                      np.asarray(getattr(jsc.lights, f)), f)
    np.testing.assert_array_equal(tsc.light_sample_weights.numpy(),
                                  np.asarray(jsc.light_sample_weights))
    assert tlt.PATCH_SHAPE == 2 == int(tsc.lights.shape_kind[0])


# --- intersection ---


@pytest.mark.parametrize("shape", ["curved", "flat", "curved_uv"])
def test_intersect_matches_reference(shape):
    rng = np.random.default_rng({"curved": 0, "flat": 1, "curved_uv": 2}[shape])
    dicts = _random_patch_dicts(rng, curved=shape != "flat", uv=shape == "curved_uv")
    jd, td = _both_tables(dicts)
    o, d = _aimed_rays(rng, td)
    n = o.shape[0]
    t_max = np.full(n, np.inf, np.float32)
    t_max[::7] = 2.5                                   # some hits beyond t_max
    with jax.disable_jit():
        js = jb.bilinear_intersect(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
        jocc = jb.bilinear_occluded(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    to, tdir, tt = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)
    ts = tb.bilinear_intersect(td, to, tdir, tt)
    tocc = tb.bilinear_occluded(td, to, tdir, tt)
    valid = np.asarray(js.valid)
    assert valid.sum() > 200
    np.testing.assert_array_equal(ts.valid.numpy(), valid)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    for f in ("t", "p", "uv", "dpdu", "dpdv", "material_id", "area_light_id"):
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert got.tobytes() == np.ascontiguousarray(want, got.dtype).tobytes(), f
    gap = ulp_gap(ts.n.numpy()[valid], np.asarray(js.n)[valid])
    print(f"{shape}: {int(valid.sum())} hits, t bit-equal, n within {gap} ulps")
    assert gap <= 2


# --- the area light ---


def test_light_sample_and_pdf_match_reference():
    rng = np.random.default_rng(2)
    dicts = _random_patch_dicts(rng, n=3, curved=True)
    jd, td = _both_tables(dicts)
    n = 512
    # Ids of the table, and ids another light kind would carry (-1, a
    # triangle's id): the reference clamps them.
    idx = rng.integers(0, 3, n).astype(np.int32)
    idx[-16:] = -1
    idx[-8:] = 327_682
    ref_p = rng.uniform(-4, -3, (n, 3)).astype(np.float32)
    ref_ns = np.zeros((n, 3), np.float32)
    ref_ns[:, 1] = 1.0
    u = rng.uniform(size=(n, 2)).astype(np.float32)
    with jax.disable_jit():
        jp, jn, jpdf = jb.bilinear_light_sample(jd, jnp.asarray(idx), jnp.asarray(ref_p),
                                                 jnp.asarray(ref_ns), jnp.asarray(u))
        wi = jp - jnp.asarray(ref_p)
        wi = wi / jnp.linalg.norm(wi, axis=-1, keepdims=True)
        jpdf2 = jb.bilinear_light_pdf(jd, jnp.asarray(idx), jnp.asarray(ref_p),
                                      jnp.asarray(ref_ns), wi, jp, jn)
    tp, tn, tpdf = tb.bilinear_light_sample(td, torch.from_numpy(idx), torch.from_numpy(ref_p),
                                            torch.from_numpy(ref_ns), torch.from_numpy(u))
    tpdf2 = tb.bilinear_light_pdf(td, torch.from_numpy(idx), torch.from_numpy(ref_p),
                                  torch.from_numpy(ref_ns), torch.from_numpy(np.array(wi)),
                                  torch.from_numpy(np.array(jp)), torch.from_numpy(np.array(jn)))
    for got, want in ((tp, jp), (tn, jn), (tpdf, jpdf), (tpdf2, jpdf2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert (np.asarray(jpdf) > 0).mean() > 0.9 and (np.asarray(jpdf2) > 0).mean() > 0.5


def test_flat_quad_matches_two_triangles():
    """tests/test_bilinear.py::TestIntersect::test_flat_quad_matches_triangles
    on the port (16x its rays): a planar quad agrees with its two-triangle
    split."""
    q = [[-1.0, 0.3, -1.0], [1.0, 0.3, -1.0], [1.0, 0.3, 1.0], [-1.0, 0.3, 1.0]]
    data = tb.make_bilinear_data([{"p00": q[0], "p10": q[1], "p01": q[3], "p11": q[2]}],
                                 device="cpu")
    tris = build_triangle_scene([quad_mesh(Transform.identity(), *q).as_scene_dict(0)],
                                device="cpu")
    rng = np.random.default_rng(1)
    n = 4096
    o = torch.from_numpy(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    t_max = torch.full((n,), torch.inf)
    si_p = tb.bilinear_intersect(data, o, d, t_max)
    si_t = triangle_scene_intersect(tris, o, d, t_max)
    hp, ht = si_p.valid.numpy(), si_t.valid.numpy()
    assert hp.sum() > 20
    assert (hp == ht).mean() > 0.99
    both = hp & ht
    np.testing.assert_allclose(si_p.t.numpy()[both], si_t.t.numpy()[both], rtol=1e-4)
    np.testing.assert_array_equal(tb.bilinear_occluded(data, o, d, t_max).numpy(), hp)
