"""The traversal configurations beyond the default v1 (ops/traverse.py
TraverseConfig): v2 (ordered pops, postponed-leaf backlog), Moller-Trumbore
leaves and the min-id winner, plus the reference's streamed large-table
mode, against the reference and against the kernels' own bodies.

* The reference's Pallas kernel in interpret mode under SHIMMER_KERNEL_V1=0,
  SHIMMER_LEAF_MT=1 and SHIMMER_WINID_MIN=1 runs in a subprocess each (the
  reference reads the flags when it is imported), and in this process with
  ``n_res=2`` (most tiles streamed), against the port's plain version under
  the matching configuration.  Criteria as in test_torch_traverse.py: equal
  hit masks (so equal any-hit bits), closest-hit ``t`` within 8 ulps and
  rtol 1e-6 (XLA's CPU compiler contracts the kernel's products into FMAs,
  the port never does), ``tri`` equal except at exact ``t`` ties.
* The g++ build of the kernels' bodies (csrc/traverse_host.cpp) under each
  configuration against the plain version: ``t`` bit-equal.
* The re-intersection gate of ``triangle_interaction_from_raw`` and the
  configuration's own rules.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.ops.pallas.traverse import traverse_packets_raw
from shimmer_tpu.shapes.triangle import triangle_interaction_from_raw as jax_interaction
from shimmer_tpu_torch.ops import traverse as tv
from shimmer_tpu_torch.ops.traverse import TraverseConfig, traverse_raw
from shimmer_tpu_torch.shapes.triangle import (
    _A_P0,
    intersect_triangle_mt,
    triangle_interaction_from_raw,
)
from torch_parity import (
    CASES,
    build_host_bodies,
    host_traverse,
    traverse_case_rays,
    traverse_scene,
    triangle_t,
    ulp_gap,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MAX_ULP_VS_PALLAS = 8
SCENES = ["soup", "bench"]
JAX_CASES = ["closest", "any_hit", "mixed"]
# name: (the reference's environment, the port's configuration)
JAX_VARIANTS = {
    "v2": ({"SHIMMER_KERNEL_V1": "0"}, TraverseConfig("v2", "watertight", "slot")),
    "mt": ({"SHIMMER_LEAF_MT": "1"}, TraverseConfig("v1", "mt", "slot")),
    "min": ({"SHIMMER_WINID_MIN": "1"}, TraverseConfig("v1", "watertight", "min")),
}
BODY_CONFIGS = {
    "v2": TraverseConfig("v2", "watertight", "slot"),
    "mt": TraverseConfig("v1", "mt", "slot"),
    "min": TraverseConfig("v1", "watertight", "min"),
    "mt_min": TraverseConfig("v1", "mt", "min"),
}

_JAX_SIDE = """
import sys
import jax.numpy as jnp
import numpy as np
from shimmer_tpu.ops.pallas import traverse as tp
from torch_parity import traverse_case_rays, traverse_scene
got = (tp.KERNEL_V1, tp.LEAF_MT, tp.WINID_MIN)
assert got == {expect}, got
out = {{}}
for scene in {scenes}:
    sc = traverse_scene(scene)
    for case in {cases}:
        o, d, t_max, want = traverse_case_rays(sc, case)
        t, tri = tp.traverse_packets_raw(
            sc["jt"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            any_hit=jnp.asarray(want), interpret=True, sort_rays=True, compact_dead=False,
        )
        out[scene + "/" + case + "/t"] = np.asarray(t)
        out[scene + "/" + case + "/tri"] = np.asarray(tri)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def scenes():
    return {name: traverse_scene(name) for name in SCENES}


@pytest.fixture(scope="module")
def jax_variants(tmp_path_factory):
    """Interpret-mode reference results under each flag, the three
    subprocesses started together."""
    out_dir = tmp_path_factory.mktemp("jax_variants")
    base = {k: v for k, v in os.environ.items() if not k.startswith("SHIMMER_")}
    base["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    procs = {}
    for name, (env, _) in JAX_VARIANTS.items():
        mt = env.get("SHIMMER_LEAF_MT") == "1"
        expect = (env.get("SHIMMER_KERNEL_V1", "1") == "1" or mt, mt,
                  env.get("SHIMMER_WINID_MIN") == "1")
        script = _JAX_SIDE.format(expect=expect, scenes=SCENES, cases=JAX_CASES)
        path = out_dir / f"{name}.npz"
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", script, str(path)], cwd=ROOT, env={**base, **env},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ), path)
    results = {}
    for name, (proc, path) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        results[name] = dict(np.load(path))
    return results


@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    lib = build_host_bodies(tmp_path_factory.mktemp("traverse_host"))
    if lib is None:
        pytest.skip("g++ is not installed: the host build of the kernel bodies needs it")
    return lib


def _port(tt, o, d, t_max, want):
    t, tri = traverse_raw(tt, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(t_max), any_hit=torch.from_numpy(want))
    return t.numpy(), tri.numpy()


def _winner_t(tt, o, d, tri):
    """t of triangle ``tri`` (BVH order) per ray under the table's own
    leaf test."""
    if tt.traverse.leaf == "watertight":
        return triangle_t({"tt": tt}, o, d, tri)
    attr = tt.attr_rows[torch.from_numpy(np.maximum(tri, 0)).long()]
    p0 = attr[:, _A_P0:_A_P0 + 3]
    e1 = attr[:, _A_P0 + 3:_A_P0 + 6] - p0
    e2 = attr[:, _A_P0 + 6:_A_P0 + 9] - p0
    _, t = intersect_triangle_mt(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.full((len(o),), np.inf), p0, e1, e2)
    return t.numpy()


def _check(tt, rays, t, tri, t_ref, tri_ref, exact):
    o, d, t_max, want = rays
    hit = tri >= 0
    np.testing.assert_array_equal(hit, tri_ref >= 0, err_msg="hit masks differ")
    assert np.isinf(t[~hit]).all()
    closest = hit & ~want
    if exact:
        np.testing.assert_array_equal(t[closest], t_ref[closest])
    else:
        assert ulp_gap(t[closest], t_ref[closest]) <= MAX_ULP_VS_PALLAS
        np.testing.assert_allclose(t[closest], t_ref[closest], rtol=1e-6)
    differ = closest & (tri != tri_ref)
    # A different winner is allowed only at an exact tie in t.
    np.testing.assert_array_equal(_winner_t(tt, o, d, tri_ref)[differ], t[differ])
    return int(closest.sum())


@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_plain_matches_jax_variant(jax_variants, scenes, variant, scene, case):
    sc = scenes[scene]
    tt = sc["tt"].with_traverse(JAX_VARIANTS[variant][1])
    rays = traverse_case_rays(sc, case)
    t, tri = _port(tt, *rays)
    ref = jax_variants[variant]
    n_hits = _check(tt, rays, t, tri, ref[f"{scene}/{case}/t"], ref[f"{scene}/{case}/tri"],
                    exact=False)
    if case == "closest":
        assert n_hits >= 40  # most aimed rays hit


@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("scene", SCENES)
def test_plain_matches_jax_streaming(scenes, scene, case):
    """The reference's streamed large-table mode (a resident budget of two
    tiles; every deeper visit DMA'd) against the port's v1 plain version,
    which reads every row from the same table whatever its size."""
    sc = scenes[scene]
    assert sc["jt"].tiles8.shape[0] > 4, "scene too small to exercise streaming"
    o, d, t_max, want = rays = traverse_case_rays(sc, case)
    t_ref, tri_ref = traverse_packets_raw(
        sc["jt"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        any_hit=jnp.asarray(want), interpret=True, sort_rays=True, compact_dead=False, n_res=2,
    )
    tt = sc["tt"].with_traverse(TraverseConfig("v1", "watertight", "slot"))
    t, tri = _port(tt, *rays)
    _check(tt, rays, t, tri, np.asarray(t_ref), np.asarray(tri_ref), exact=False)


@pytest.mark.parametrize("case", CASES + ["grazing"])
@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("config", list(BODY_CONFIGS))
def test_host_body_matches_plain(host_body, scenes, config, scene, case):
    sc = scenes[scene]
    tt = sc["tt"].with_traverse(BODY_CONFIGS[config])
    rays = traverse_case_rays(sc, case)
    t_h, tri_h, steps = host_traverse(host_body, tt, *rays)
    t_p, tri_p = _port(tt, *rays)
    _check(tt, rays, t_h, tri_h, t_p, tri_p, exact=True)
    t_max = rays[2]
    assert (steps[t_max <= 0] == 0).all()
    assert (steps[t_max > 0] >= 1).all()


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("config", list(BODY_CONFIGS) + ["v1"])
def test_host_body_records_what_it_reads(host_body, scenes, config, scene):
    """The ``touched`` record behind the kernels' bound.  A ray visits a row
    at most once, so alone it touches as many rows as it takes steps, and a
    batch touches the union of its rays' rows.  Every body reads the meta
    word of each row it visits and no other: v2 takes its hit children's
    leaf bits from the visited row's child-leaf word, not from their meta
    words."""
    sc = scenes[scene]
    cfg = BODY_CONFIGS.get(config, tv.V1)
    tt = sc["tt"].with_traverse(cfg)
    n_rows = tt.rows8.shape[0]
    rays = traverse_case_rays(sc, "mixed")
    touched = np.zeros(2 * n_rows, np.uint8)
    host_traverse(host_body, tt, *rays, touched=touched)
    union = np.zeros(2 * n_rows, bool)
    for i in range(len(rays[0])):
        one = np.zeros(2 * n_rows, np.uint8)
        _, _, steps = host_traverse(host_body, tt, *(x[i:i + 1] for x in rays), touched=one)
        assert one[:n_rows].sum() == steps[0]
        union |= one.astype(bool)
    np.testing.assert_array_equal(touched.astype(bool), union)
    rows, metas = union[:n_rows], union[n_rows:]
    assert rows[0]
    np.testing.assert_array_equal(metas, rows)


def test_mt_with_v2_raises(monkeypatch):
    with pytest.raises(ValueError, match="kernel='v1'"):
        TraverseConfig("v2", "mt")
    monkeypatch.setenv("SHIMMER_KERNEL_V1", "0")
    monkeypatch.setenv("SHIMMER_LEAF_MT", "1")
    with pytest.raises(ValueError, match="kernel='v1'"):
        TraverseConfig()


def test_min_winner_with_v2_raises():
    """The reference's v2 never reads SHIMMER_WINID_MIN; the port offers
    no v2 with the min-id winner."""
    with pytest.raises(ValueError, match="kernel='v1'"):
        TraverseConfig("v2", "watertight", "min")


@pytest.mark.parametrize(
    "env, want",
    [({}, ("v1", "watertight", "slot")),
     ({"SHIMMER_KERNEL_V1": "0"}, ("v2", "watertight", "slot")),
     ({"SHIMMER_LEAF_MT": "1"}, ("v1", "mt", "slot")),
     ({"SHIMMER_WINID_MIN": "1"}, ("v1", "watertight", "min")),
     ({"SHIMMER_WINID_MIN": "1", "SHIMMER_KERNEL_V1": "0"}, ValueError)],
    ids=["default", "v2", "mt", "min", "v2_min"],
)
def test_config_defaults_follow_reference_flags(monkeypatch, env, want):
    """The defaults follow the reference's flags; a combination the port
    does not offer (v2 with the min-id winner) raises."""
    for key in ("SHIMMER_KERNEL_V1", "SHIMMER_LEAF_MT", "SHIMMER_WINID_MIN"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if want is ValueError:
        with pytest.raises(ValueError, match="kernel='v1'"):
            TraverseConfig()
        return
    cfg = TraverseConfig()
    assert (cfg.kernel, cfg.leaf, cfg.winner) == want
    assert cfg.name in tv.KERNEL_NAMES
    with pytest.raises(ValueError):
        TraverseConfig(kernel="v3")


def test_with_traverse_repacks_leaves(scenes):
    tt = scenes["bench"]["tt"]
    assert tt.traverse.leaf == "watertight"
    mt = tt.with_traverse(TraverseConfig("v1", "mt", "slot"))
    leaf = (tt.meta & 15) > 0
    np.testing.assert_array_equal(mt.rows8[leaf, 24:48].numpy(),
                                  (tt.rows8[leaf, 24:48] - tt.rows8[leaf, 0:24]).numpy())
    np.testing.assert_array_equal(mt.rows8[~leaf].numpy(), tt.rows8[~leaf].numpy())
    assert tt.with_traverse(TraverseConfig("v2", "watertight", "slot")).rows8 is tt.rows8
    with pytest.raises(ValueError, match="unpacked"):
        mt.with_traverse(TraverseConfig("v1", "watertight", "slot"))


def test_cpu_traversal_counts_no_launch(scenes):
    sc = scenes["soup"]
    before = dict(traverse_raw.launches)
    calls = tv.traverse_raw_plain.calls
    for cfg in BODY_CONFIGS.values():
        _port(sc["tt"].with_traverse(cfg), *traverse_case_rays(sc, "closest"))
    assert traverse_raw.launches == before
    assert tv.traverse_raw_plain.calls == calls + len(BODY_CONFIGS)


def test_reintersection_miss_is_a_clean_miss(scenes):
    """A traversal winner whose watertight re-intersection misses (what an
    MT leaf test can report at an edge) reaches shading as a miss: tri -1,
    t inf, material and light ids -1.  The reference keeps tri >= 0 with
    t = inf there (logged in ROADMAP queue 3)."""
    sc = scenes["bench"]
    tt = sc["tt"]
    o, d, t_max, _ = traverse_case_rays(sc, "closest")
    t, tri = _port(tt, o, d, t_max, np.zeros(len(o), bool))
    hit = np.nonzero(tri >= 0)[0]
    assert len(hit) >= 40
    # Half the hit lanes get another ray's winner, which they miss.
    wrong = hit[: len(hit) // 2]
    tri_fed = tri.copy()
    tri_fed[wrong] = tri[np.roll(wrong, 1)]
    t_fed = triangle_t(sc, o, d, tri_fed)
    miss = np.isinf(t_fed) & (tri_fed >= 0)
    assert miss.sum() >= 10
    si = triangle_interaction_from_raw(tt, torch.from_numpy(o), torch.from_numpy(d),
                                       torch.from_numpy(tri_fed))
    valid = si.valid.numpy()
    np.testing.assert_array_equal(valid, (tri_fed >= 0) & ~miss)
    assert np.isinf(si.t.numpy()[miss]).all()
    assert (si.material_id.numpy()[miss] == -1).all()
    assert (si.area_light_id.numpy()[miss] == -1).all()
    assert np.isfinite(si.p.numpy()).all()
    keep = (tri_fed >= 0) & ~miss
    np.testing.assert_array_equal(si.t.numpy()[keep], t_fed[keep])
    assert (si.material_id.numpy()[keep] >= 0).all()

    jsi = jax_interaction(sc["jt"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(tri_fed))
    assert np.asarray(jsi.valid)[miss].all()
    assert np.isinf(np.asarray(jsi.t)[miss]).all()
