"""Two-level instancing in the port (shimmer_tpu_torch/shapes/instanced.py)
against the reference, on the CPU, on tests/test_instanced.py's
60-triangle object under 4 instances and its 400 rays.

- The tables byte-equal to ``build_instanced``'s: the combined row table,
  ``attr_rows``, ``inst_inv`` / ``inst_fwd``, the world bounds and
  ``stack_depth``.
- The per-lane affine product and the transposed normal product bit-equal
  to the reference's einsums run op by op (left to right with fused
  multiply-adds on the CPU).
- Oracle 1, the port against itself: each lane's ray mapped into every
  instance's object space by the port's ``_apply12``, the port's
  ``intersect_triangle`` over the object's triangles by brute force, the
  nearest kept.  The two-level loop's ``t``, triangle and instance equal
  that bit for bit; any-hit lanes agree on occlusion.
- Oracle 2, the port against the reference's ``_traverse_inst``: the
  reference runs its loop compiled (a ``lax.while_loop`` body is an XLA
  computation even op by op), where XLA contracts the slab test, the
  affine maps and the watertight test into fused multiply-adds.  So
  ``valid`` is equal on every lane, triangle and instance ids equal, and
  ``t`` within a few ulps; the test prints the largest gap and the count
  of lanes that are not bit-equal.
- The world-space interaction against the reference's
  ``instanced_intersect``; tests/test_instanced.py's memory ratios on the
  port.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.shapes import instanced as ji
from shimmer_tpu_torch.shapes import instanced as ti
from shimmer_tpu_torch.shapes.triangle import (
    _A_P0,
    build_triangle_scene,
    intersect_triangle,
    triangle_scene_intersect,
    triangle_scene_occluded,
)
from torch_parity import ensure_reference_sah, ulp_gap

torch.set_num_threads(1)

# Largest t gap allowed against the reference's compiled loop, in ulps.
T_ULPS = 8


def _object_mesh(rng, n_tri=60):
    """tests/test_instanced.py's random triangle soup (object space)."""
    c = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (n_tri, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (n_tri, 3)).astype(np.float32)
    p = np.concatenate([c, c + e1, c + e2], axis=0)
    idx = np.stack([np.arange(n_tri), np.arange(n_tri) + n_tri, np.arange(n_tri) + 2 * n_tri],
                   axis=1).astype(np.int32)
    return {"p": p, "indices": idx, "material_id": 0}


def _transforms():
    """tests/test_instanced.py's four instance transforms."""
    def m(tx, ty, tz, s, ry):
        c, sn = np.cos(ry), np.sin(ry)
        out = np.eye(4)
        out[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float64) * s
        out[:3, 3] = [tx, ty, tz]
        return out

    return [m(0, 0, 0, 1.0, 0.0), m(3.0, 0.5, 0, 0.7, 0.8), m(-2.5, -0.5, 1.5, 1.4, 2.1),
            m(0.5, 2.5, -2.0, 0.5, -1.2)]


@pytest.fixture(scope="module")
def setup():
    ensure_reference_sah()
    rng = np.random.default_rng(11)
    mesh = _object_mesh(rng)
    mats = _transforms()
    jinst = ji.build_instanced([[mesh]], [(0, m) for m in mats])
    tinst = ti.build_instanced([[mesh]], [(0, m) for m in mats], device="cpu")
    flat = []
    for m in mats:
        ph = np.concatenate([mesh["p"], np.ones((len(mesh["p"]), 1), np.float32)], axis=1)
        flat.append({"p": (m @ ph.T).T[:, :3].astype(np.float32), "indices": mesh["indices"],
                     "material_id": 0})
    flat = build_triangle_scene(flat, device="cpu")
    o = rng.uniform(-6, 6, (400, 3)).astype(np.float32)
    target = rng.uniform(-1.5, 3.0, (400, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jinst, tinst, flat, o, d


def test_tables_match_reference(setup):
    jinst, tinst, _, _, _ = setup
    for f in ("rows8", "attr_rows", "inst_inv", "inst_fwd", "world_min", "world_max"):
        got = getattr(tinst, f)
        assert got.dtype == torch.float32, f
        assert got.numpy().tobytes() == np.asarray(getattr(jinst, f)).tobytes(), f
    assert (tinst.stack_depth, tinst.has_normals, tinst.has_uv) == (
        jinst.stack_depth, jinst.has_normals, jinst.has_uv)
    # Four instance-entry rows (col 80 = 9), each naming the object's root.
    rows = tinst.rows8.numpy()
    entry = rows[rows[:, 80] == 9]
    assert sorted(entry[:, 72].astype(int)) == [0, 1, 2, 3]
    assert (entry[:, 48] == entry[0, 48]).all() and rows[int(entry[0, 48]), 80] == 0


def test_affine_products_match_reference():
    rng = np.random.default_rng(4)
    a12 = rng.normal(size=(256, 12)).astype(np.float32)
    p = rng.normal(size=(256, 3)).astype(np.float32) * 3
    with jax.disable_jit():
        want_p = np.asarray(ji._apply12(jnp.asarray(a12), jnp.asarray(p), 1.0))
        want_v = np.asarray(ji._apply12(jnp.asarray(a12), jnp.asarray(p), 0.0))
        m = jnp.asarray(a12).reshape(256, 3, 4)[..., :3]
        want_n = np.asarray(jnp.einsum("...ji,...j->...i", m, jnp.asarray(p)))
    ta, tp = torch.from_numpy(a12), torch.from_numpy(p)
    assert ti._apply12(ta, tp, 1.0).numpy().tobytes() == want_p.tobytes()
    assert ti._apply12(ta, tp, 0.0).numpy().tobytes() == want_v.tobytes()
    assert ti._apply_transposed(ta, tp).numpy().tobytes() == want_n.tobytes()


def _brute_force(tinst, o, d, t_max):
    """Nearest hit of each lane over every instance and every object
    triangle, each ray mapped by the port's _apply12: (t, tri, inst)."""
    n = o.shape[0]
    attr = tinst.attr_rows
    p0, p1, p2 = (attr[None, :, _A_P0 + 3 * k: _A_P0 + 3 * k + 3] for k in range(3))
    best_t = torch.full((n,), torch.inf)
    best_tri = torch.full((n,), -1, dtype=torch.int64)
    best_inst = torch.full((n,), -1, dtype=torch.int64)
    for i in range(tinst.inst_inv.shape[0]):
        inv = tinst.inst_inv[i].expand(n, 12)
        oo, dd = ti._apply12(inv, o, 1.0), ti._apply12(inv, d, 0.0)
        hit, t, *_ = intersect_triangle(oo[:, None], dd[:, None], t_max[:, None], p0, p1, p2)
        t = torch.where(hit, t, torch.inf)
        tmin, arg = torch.min(t, dim=1)
        closer = tmin < best_t
        best_t = torch.where(closer, tmin, best_t)
        best_tri = torch.where(closer, arg, best_tri)
        best_inst = torch.where(closer, i, best_inst)
    return best_t, best_tri, best_inst


@pytest.fixture(scope="module")
def forty():
    """Forty turned and scaled instances of a 24-triangle object in a
    12-unit box: the top tree has levels below its root, so a lane goes on
    through world-space top rows after a restore marker."""
    rng = np.random.default_rng(21)
    mesh = _object_mesh(rng, n_tri=24)
    mats = []
    for _ in range(40):
        m = np.eye(4)
        axis = rng.normal(size=3)
        m[:3, :3] = _rotation(axis / np.linalg.norm(axis), rng.uniform(0, 2 * np.pi))
        m[:3, :3] *= rng.uniform(0.3, 1.2)
        m[:3, 3] = rng.uniform(-6, 6, 3)
        mats.append(m)
    tinst = ti.build_instanced([[mesh]], [(0, m) for m in mats], device="cpu")
    o = rng.uniform(-9, 9, (400, 3)).astype(np.float32)
    # Toward the instances' origins, so most rays meet one.
    target = np.stack(mats)[rng.integers(0, 40, 400), :3, 3] + rng.uniform(-0.4, 0.4, (400, 3))
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return None, tinst, None, o, d


def _rotation(axis, angle):
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


@pytest.mark.parametrize("t_max", ["inf", "clipped"])
@pytest.mark.parametrize("scene", ["four", "forty"])
def test_traversal_matches_brute_force(setup, forty, scene, t_max):
    _, tinst, _, o, d = setup if scene == "four" else forty
    if scene == "forty":
        rows = tinst.rows8.numpy()
        top = rows[: int(rows[rows[:, 80] == 9][0, 48])]
        assert (top[:, 80] == 0).sum() > 2   # the root and its internal children
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tm = torch.full((o.shape[0],), torch.inf)
    if t_max == "clipped":
        tm[::3] = 5.0
    t, tri, b0, b1, b2, verts, inst = ti._traverse_inst(tinst, to, td, tm)
    bt, btri, binst = _brute_force(tinst, to, td, tm)
    hit = tri >= 0
    assert int(hit.sum()) > 50
    np.testing.assert_array_equal(hit.numpy(), torch.isfinite(bt).numpy())
    assert t.numpy().tobytes() == torch.where(hit, bt, torch.inf).numpy().tobytes()
    np.testing.assert_array_equal(tri[hit].numpy(), btri[hit].numpy())
    np.testing.assert_array_equal(inst[hit].numpy(), binst[hit].numpy())
    np.testing.assert_array_equal(inst[~hit].numpy(), -1)
    # The object-space vertices carried out are the winning triangle's.
    attr = tinst.attr_rows[tri.clamp(min=0)][:, _A_P0:_A_P0 + 9]
    np.testing.assert_array_equal(verts[hit].numpy(), attr[hit].numpy())
    np.testing.assert_array_equal((b2[hit] == 1.0 - b0[hit] - b1[hit]).numpy(), True)
    any_tri = ti._traverse_inst(tinst, to, td, tm, any_hit=True)[1]
    np.testing.assert_array_equal((any_tri >= 0).numpy(), hit.numpy())
    np.testing.assert_array_equal(ti.instanced_occluded(tinst, to, td, tm).numpy(), hit.numpy())


@pytest.mark.parametrize("any_hit", [False, True, "mixed"], ids=["closest", "any_hit", "mixed"])
def test_traversal_matches_reference(setup, any_hit):
    jinst, tinst, _, o, d = setup
    n = o.shape[0]
    want_any = np.arange(n) >= n // 2 if any_hit == "mixed" else np.full(n, any_hit)
    jt, jtri, _, _, _, _, jinst_id = ji._traverse_inst(
        jinst, jnp.asarray(o), jnp.asarray(d), jnp.full(n, jnp.inf), any_hit=jnp.asarray(want_any))
    t, tri, *_, inst = ti._traverse_inst(tinst, torch.from_numpy(o), torch.from_numpy(d),
                                         torch.full((n,), torch.inf),
                                         any_hit=torch.from_numpy(want_any))
    jtri, jinst_id, jt = np.asarray(jtri), np.asarray(jinst_id), np.asarray(jt)
    valid = jtri >= 0
    np.testing.assert_array_equal(tri.numpy() >= 0, valid)
    closest = valid & ~want_any
    np.testing.assert_array_equal(tri.numpy()[closest], jtri[closest])
    np.testing.assert_array_equal(inst.numpy()[closest], jinst_id[closest])
    gap = ulp_gap(t.numpy()[closest], jt[closest])
    differ = int((t.numpy()[closest] != jt[closest]).sum())
    print(f"{any_hit}: {int(valid.sum())} hits, {int(closest.sum())} closest; t within {gap} "
          f"ulps of the reference's compiled loop, {differ} lanes not bit-equal")
    assert gap <= T_ULPS


def test_interaction_matches_reference(setup):
    """instanced_intersect's world-space record against the reference's
    (its loop compiled, the rest op by op): ids equal, geometry within
    float32 rounding of the few-ulp t gap."""
    jinst, tinst, _, o, d = setup
    n = o.shape[0]
    js = ji.instanced_intersect(jinst, jnp.asarray(o), jnp.asarray(d), jnp.full(n, jnp.inf))
    ts = ti.instanced_intersect(tinst, torch.from_numpy(o), torch.from_numpy(d),
                                torch.full((n,), torch.inf))
    valid = np.asarray(js.valid)
    np.testing.assert_array_equal(ts.valid.numpy(), valid)
    for f in ("material_id", "area_light_id", "med_in", "med_out"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), f)
    for f in ("p", "n", "ns", "uv", "dpdu", "dpdv", "wo"):
        np.testing.assert_allclose(getattr(ts, f).numpy()[valid], np.asarray(getattr(js, f))[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_matches_flattened(setup):
    """tests/test_instanced.py::test_matches_flattened and
    ::test_occlusion_matches on the port."""
    _, tinst, flat, o, d = setup
    n = o.shape[0]
    to, td, tm = torch.from_numpy(o), torch.from_numpy(d), torch.full((n,), torch.inf)
    si_i = ti.instanced_intersect(tinst, to, td, tm)
    si_f = triangle_scene_intersect(flat, to, td, tm)
    hi, hf = si_i.valid.numpy(), si_f.valid.numpy()
    assert hi.sum() > 50 and (hi == hf).all()
    np.testing.assert_allclose(si_i.t.numpy()[hi], si_f.t.numpy()[hi], rtol=2e-5)
    np.testing.assert_allclose(si_i.p.numpy()[hi], si_f.p.numpy()[hi], rtol=1e-4, atol=1e-5)
    assert np.abs((si_i.n.numpy()[hi] * si_f.n.numpy()[hi]).sum(-1) - 1.0).max() < 1e-3
    np.testing.assert_array_equal(ti.instanced_occluded(tinst, to, td, tm).numpy(),
                                  triangle_scene_occluded(flat, to, td, tm).numpy())


def test_memory_is_shared(setup):
    """tests/test_instanced.py::test_memory_is_shared on the port: four
    instances share one object BVH."""
    _, tinst, flat, _, _ = setup
    assert tinst.rows8.shape[0] < flat.rows8.shape[0] * 0.45
    assert tinst.attr_rows.shape[0] * 4 == flat.attr_rows.shape[0]


def test_steps_are_recorded_in_chunks(setup):
    _, tinst, _, o, d = setup
    ti._traverse_inst.steps = []
    try:
        ti._traverse_inst(tinst, torch.from_numpy(o), torch.from_numpy(d),
                          torch.full((o.shape[0],), torch.inf))
        steps = ti._traverse_inst.steps
    finally:
        ti._traverse_inst.steps = None
    assert len(steps) == 1 and steps[0] > 0 and steps[0] % ti.TRAVERSE_CHUNK == 0


def test_area_light_in_an_object_is_refused():
    mesh = dict(_object_mesh(np.random.default_rng(0), 4), area_light_id=0)
    with pytest.raises(NotImplementedError, match="area lights inside an object"):
        ti.build_instanced([[mesh]], [(0, np.eye(4))], device="cpu")
