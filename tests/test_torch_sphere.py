"""Analytic spheres of the port (shimmer_tpu_torch/shapes/sphere.py and the
quadratic of ops/math.py) against the reference's, on the CPU.

The reference runs op by op (``jax.disable_jit``), the port on CPU tensors,
on the same seeded rays and sphere tables.  Criteria: the quadratic's
roots bit-equal in every branch (a = 0, b = 0, a negative and a zero
discriminant); the hit mask, ids, ``t``, ``p``, ``dpdu`` and ``dpdv``
bit-equal; ``n``, ``uv`` and ``wo`` within 2e-6 absolute (they pass
through atan2, acos and rsqrt, whose CPU implementations differ in the
last ulp); the
samples and pdfs of the light-sampling functions within rtol 2e-5.  The
table holds a full sphere, a z-clipped one, a phi-clipped one, a
reversed one and a scaled and rotated one; the rays come from outside
aimed at the spheres, from inside them, and at grazing angles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.ops.math import quadratic as jax_quadratic
from shimmer_tpu.ops.transform import Transform as JaxTransform
from shimmer_tpu.shapes import sphere as jsph
from shimmer_tpu_torch.ops.math import quadratic as torch_quadratic
from shimmer_tpu_torch.ops.transform import Transform as TorchTransform
from shimmer_tpu_torch.shapes import sphere as tsph

torch.set_num_threads(1)

SEED = 11
N = 512
FIELD_ATOL = 2e-6
SAMPLE_RTOL, SAMPLE_ATOL = 2e-5, 2e-5


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def sphere_specs():
    """(radius, z_min, z_max, phi_max, reverse, object_to_render as float64)."""
    rng = np.random.default_rng(SEED)
    specs = []
    for k, (radius, zlim, phi_max, rev, scale) in enumerate([
        (1.0, None, 360.0, False, 1.0),
        (0.8, (-0.3, 0.5), 360.0, False, 1.0),
        (0.7, None, 250.0, False, 1.0),
        (0.6, None, 360.0, True, 1.0),
        (0.5, (-0.4, 0.45), 300.0, False, 1.7),
    ]):
        m = np.eye(4)
        m[:3, :3] = _rotation(rng) * scale
        m[:3, 3] = [2.2 * (k - 2), 0.3 * k, 0.5 * (k % 2)]
        specs.append((radius, zlim, phi_max, rev, m))
    return specs


def sphere_dicts(transform_cls):
    out = []
    for i, (radius, zlim, phi_max, rev, m) in enumerate(sphere_specs()):
        d = {"radius": radius, "phi_max": phi_max, "reverse_orientation": rev,
             "object_to_render": transform_cls.from_matrix(m), "material_id": i,
             "area_light_id": 10 + i}
        if zlim is not None:
            d["z_min"], d["z_max"] = zlim
        out.append(d)
    return out


@pytest.fixture(scope="module")
def tables():
    return (jsph.make_sphere_data(sphere_dicts(JaxTransform)),
            tsph.make_sphere_data(sphere_dicts(TorchTransform), device="cpu"))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def ray_set(kind: str):
    """(o, d, t_max) float32 rays of one kind, aimed at the spheres."""
    rng = np.random.default_rng(SEED + ["outside", "inside", "grazing"].index(kind))
    specs = sphere_specs()
    idx = rng.integers(0, len(specs), N)
    centers = np.stack([specs[i][4][:3, 3] for i in idx])
    scale = np.array([np.linalg.norm(specs[i][4][:3, 0]) * specs[i][0] for i in idx])
    if kind == "outside":
        o = centers + _unit(rng.normal(size=(N, 3))) * 6.0
        d = _unit(centers + rng.normal(size=(N, 3)) * 0.5 * scale[:, None] - o)
    elif kind == "inside":
        o = centers + rng.normal(size=(N, 3)) * 0.1 * scale[:, None]
        d = _unit(rng.normal(size=(N, 3)))
    elif kind == "grazing":
        d = _unit(rng.normal(size=(N, 3)))
        e = _unit(np.cross(d, rng.normal(size=(N, 3))))
        r = scale * (1.0 + rng.uniform(-2e-6, 2e-6, N))
        o = centers + e * r[:, None] - 4.0 * d
    else:
        raise ValueError(kind)
    t_max = np.where(rng.random(N) < 0.2, 3.0, np.inf)
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


def test_quadratic_branches():
    a = np.array([0, 0, 0, 1, 1, 2, 1, 4, -1, 1e-30, 3], np.float32)
    b = np.array([2, 0, 0, 0, 0, 4, 2, 4, 3, 1, -7], np.float32)
    c = np.array([-4, 1, 0, -4, 4, 2, 5, 1, 10, -1, 2], np.float32)
    rng = np.random.default_rng(SEED)
    a = np.concatenate([a, rng.normal(size=200).astype(np.float32)])
    b = np.concatenate([b, rng.normal(size=200).astype(np.float32) * 3])
    c = np.concatenate([c, rng.normal(size=200).astype(np.float32)])
    with jax.disable_jit():
        want = [np.asarray(x) for x in jax_quadratic(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))]
    got = [x.numpy() for x in torch_quadratic(*(torch.from_numpy(x) for x in (a, b, c)))]
    # a = 0 takes the linear root, b = 0 the symmetric pair, disc < 0 no
    # root, disc = 0 (a=1, b=2, c=1 scaled: a=4, b=4, c=1) a double root.
    assert got[0][:11].tolist() == [True, False, False, True, False, True, False, True, True,
                                    True, True]
    assert got[1][7] == got[2][7] == -0.5
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _intersect_both(tables, kind):
    jd, td = tables
    o, d, t_max = ray_set(kind)
    with jax.disable_jit():
        jsi = jsph.sphere_intersect(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    tsi = tsph.sphere_intersect(td, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(t_max))
    return jsi, tsi


@pytest.mark.parametrize("kind", ["outside", "inside", "grazing"])
def test_sphere_intersect_matches_reference(tables, kind):
    jsi, tsi = _intersect_both(tables, kind)
    valid = np.asarray(jsi.valid)
    assert valid.mean() > 0.3
    for f in ("valid", "t", "material_id", "area_light_id", "med_in", "med_out"):
        np.testing.assert_array_equal(getattr(tsi, f).numpy(), np.asarray(getattr(jsi, f)),
                                      err_msg=f)
    for f in ("p", "dpdu", "dpdv", "dpdus"):
        np.testing.assert_array_equal(getattr(tsi, f).numpy()[valid],
                                      np.asarray(getattr(jsi, f))[valid], err_msg=f)
    for f in ("n", "uv", "wo", "ns"):
        np.testing.assert_allclose(getattr(tsi, f).numpy()[valid],
                                   np.asarray(getattr(jsi, f))[valid],
                                   rtol=0, atol=FIELD_ATOL * max(1.0, float(np.abs(
                                       np.asarray(getattr(jsi, f))[valid]).max())), err_msg=f)
    pred = tsph.sphere_intersect_predicate(tables[1], *(torch.from_numpy(x)
                                                        for x in ray_set(kind)))
    np.testing.assert_array_equal(pred.numpy(), valid)


def test_partial_and_reversed_spheres_are_exercised(tables):
    """The clipped spheres reject hits beyond their limits and the
    reversed one flips its normal: counted on the reference's own hits."""
    jsi, tsi = _intersect_both(tables, "outside")
    ids = tsi.material_id.numpy()
    assert set(np.unique(ids[ids >= 0]).tolist()) == {0, 1, 2, 3, 4}
    jd, td = tables
    # A clipped sphere lets rays through its cut: some lanes aimed at it
    # miss it and hit nothing or another sphere behind.
    o, d, t_max = ray_set("outside")
    full = tsph.sphere_intersect(
        tsph.make_sphere_data([{**s, "z_min": -9.0, "z_max": 9.0, "phi_max": 360.0}
                               for s in sphere_dicts(TorchTransform)], device="cpu"),
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    assert int((full.valid & ~tsi.valid).sum()) > 0
    # Reversed: the normal points inward (against the center-to-hit vector).
    center = sphere_specs()[3][4][:3, 3]
    rev = ids == 3
    outward = np.sum((tsi.p.numpy()[rev] - center) * tsi.n.numpy()[rev], axis=-1)
    assert rev.any() and (outward < 0).all()


@pytest.mark.parametrize("where", ["outside", "inside"])
def test_sphere_sampling_matches_reference(tables, where):
    jd, td = tables
    rng = np.random.default_rng(SEED + 7)
    specs = sphere_specs()
    idx = rng.integers(-1, len(specs) + 1, N).astype(np.int32)  # includes clamped ids
    ci = np.clip(idx, 0, len(specs) - 1)
    centers = np.stack([specs[i][4][:3, 3] for i in ci])
    radius = np.array([specs[i][0] * np.linalg.norm(specs[i][4][:3, 0]) for i in ci])
    if where == "outside":
        ref_p = centers + _unit(rng.normal(size=(N, 3))) * (radius * rng.uniform(1.5, 8, N))[:, None]
    else:
        ref_p = centers + _unit(rng.normal(size=(N, 3))) * (radius * 0.3)[:, None]
    ref_p = ref_p.astype(np.float32)
    ref_ns = _unit(rng.normal(size=(N, 3))).astype(np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    with jax.disable_jit():
        jp, jn, jpdf = jsph.sphere_sample_with_context(
            jd, jnp.asarray(idx), jnp.asarray(ref_p), jnp.asarray(ref_ns), jnp.asarray(u))
        wi = jnp.asarray(_unit(np.asarray(jp) - ref_p).astype(np.float32))
        jpdf2 = jsph.sphere_pdf_with_context(jd, jnp.asarray(idx), jnp.asarray(ref_p), wi, jp, jn)
        jsp, jsn, jspdf = jsph.sphere_sample(jd, jnp.asarray(idx), jnp.asarray(u))
        jarea = jsph.sphere_area(jd)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    tp, tn, tpdf = tsph.sphere_sample_with_context(td, t(idx), t(ref_p), t(ref_ns), t(u))
    tpdf2 = tsph.sphere_pdf_with_context(td, t(idx), t(ref_p), t(wi), t(jp), t(jn))
    tsp, tsn, tspdf = tsph.sphere_sample(td, t(idx), t(u))
    np.testing.assert_array_equal(tsph.sphere_area(td).numpy(), np.asarray(jarea))
    for got, want in ((tp, jp), (tn, jn), (tpdf, jpdf), (tpdf2, jpdf2), (tsp, jsp), (tsn, jsn),
                      (tspdf, jspdf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SAMPLE_RTOL,
                                   atol=SAMPLE_ATOL)
    assert np.all(np.asarray(jpdf) > 0)
