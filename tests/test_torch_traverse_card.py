"""The traversal kernels (csrc/traverse.cu) on the card, against the plain
traversal (``ops.traverse.traverse_raw_plain``) on the same tensors:

* every kernel library builds and loads, and the native SAH builder loads
  (the scenes' tables are built with it);
* each configuration (v1, v2, v1 with Moller-Trumbore leaves, v1 with the
  min-id winner, and the combined v1 MT + min-id) on the primary, bounce
  and merged wavefront batches of the bench scene (``measure.bench_batches``);
* v1 and v2 on the merged batch of the 1.3M-triangle scene.

Equal hit masks (so equal occlusion bits on any-hit lanes), bit-equal t
where both hit, equal tri except at exact t ties; a closest hit whose
watertight re-intersection misses reaches shading as a miss.  Marked
``card``; run on the card as tests/card_checks.py says.
"""

import pytest
import torch

from card_checks import CONFIGS, card  # noqa: F401  (card: a fixture)
from shimmer_tpu_torch import native
from shimmer_tpu_torch.bench_scene import (
    BENCH_RESOLUTION,
    BENCH_TRIS,
    LARGE_TRIS,
    build_bench_scene,
)
from shimmer_tpu_torch.measure import bench_batches
from shimmer_tpu_torch.ops import cuda_build
from shimmer_tpu_torch.ops import traverse as tv
from shimmer_tpu_torch.ops.traverse import TraverseConfig
from shimmer_tpu_torch.shapes.triangle import (
    _A_P0,
    intersect_triangle,
    intersect_triangle_mt,
    triangle_interaction_from_raw,
)

pytestmark = pytest.mark.card

# The combined form the configuration allows, held to the plain version
# only (the reference never rendered with it).
ALL_CONFIGS = {**CONFIGS, "v1_mt_min": TraverseConfig("v1", "mt", "min")}


def test_every_kernel_library_builds_and_loads(card):
    built = cuda_build.build(force=True)
    for name in cuda_build.LIBRARIES:
        assert built[name]["built"], name
        assert cuda_build.library_path(name).exists(), name
        cuda_build.load(name)


def test_the_native_sah_builder_loads(card):
    assert native.sah_available(), native.sah_error()


class Batches:
    """A scene's traversal batches on the card, and the plain traversal's
    result on each, once per (leaf test, winner rule)."""

    def __init__(self, scene, cam, film, dev, names):
        self.scene = scene
        self.batches = {n: b for n, b in bench_batches(scene, cam, film, dev).items() if n in names}
        self._plain = {}

    def plain(self, cfg, name):
        key = (cfg.leaf, cfg.winner, name)
        if key not in self._plain:
            tris = self.scene.triangles.with_traverse(cfg)
            o, d, t_max, want = self.batches[name]
            self._plain[key] = tv.traverse_raw_plain(tris.rows8, tris.stack_depth, o, d, t_max,
                                                     want, leaf=cfg.leaf, winner=cfg.winner)
        return self._plain[key]


@pytest.fixture(scope="module")
def bench(card):
    scene, cam, film = build_bench_scene(BENCH_TRIS, BENCH_RESOLUTION, device="cpu")
    return Batches(scene.to(card), cam, film, card, ("primary", "bounce", "merged"))


@pytest.fixture(scope="module")
def large(card):
    scene, cam, film = build_bench_scene(LARGE_TRIS, BENCH_RESOLUTION, device="cpu")
    return Batches(scene.to(card), cam, film, card, ("merged",))


def winner_t(tris, o, d, tri):
    """t of triangle ``tri`` per ray under the table's own leaf test."""
    attr = tris.attr_rows[torch.clamp(tri, min=0).long()]
    p0, p1, p2 = (attr[:, _A_P0 + 3 * k:_A_P0 + 3 * k + 3] for k in range(3))
    inf = torch.full((o.shape[0],), float("inf"), device=o.device)
    if tris.traverse.leaf == "mt":
        return intersect_triangle_mt(o, d, inf, p0, p1 - p0, p2 - p0)[1]
    return intersect_triangle(o, d, inf, p0, p1, p2)[1]


def assert_kernel_equals_plain(batches, cfg, name):
    tris = batches.scene.triangles.with_traverse(cfg)
    o, d, t_max, any_hit = batches.batches[name]
    t_k, tri_k = tv.traverse_raw(tris, o, d, t_max, any_hit=any_hit)
    t_p, tri_p = batches.plain(cfg, name)
    hit_k, hit_p = tri_k >= 0, tri_p >= 0
    assert torch.equal(hit_k, hit_p), "hit masks differ"
    closest = hit_k & ~any_hit
    t_equal = t_k[closest] == t_p[closest]
    assert bool(t_equal.all()), f"t differs on {int((~t_equal).sum())} lanes"
    # A tri mismatch is allowed only where both triangles give the same t.
    tri_diff = closest & (tri_k != tri_p)
    assert torch.equal(winner_t(tris, o, d, tri_p)[tri_diff], t_k[tri_diff]), "tri off a tie"
    # Closest-hit winners whose watertight re-intersection misses: each
    # must reach shading as a miss, never as tri >= 0 with t = inf.
    attr = tris.attr_rows[torch.clamp(tri_k, min=0).long()]
    rehit, *_ = intersect_triangle(
        o, d, torch.full_like(t_max, float("inf")),
        attr[:, _A_P0:_A_P0 + 3], attr[:, _A_P0 + 3:_A_P0 + 6], attr[:, _A_P0 + 6:_A_P0 + 9],
    )
    si = triangle_interaction_from_raw(tris, o, d, torch.where(any_hit, -1, tri_k))
    assert torch.equal(si.valid, closest & rehit), "interaction validity"
    assert not bool((si.valid & torch.isinf(si.t)).any()), "a valid hit with t = inf"
    if cfg.leaf == "watertight":
        assert int((closest & ~rehit).sum()) == 0, "watertight hits miss on re-intersection"


@pytest.mark.parametrize("batch", ["primary", "bounce", "merged"])
@pytest.mark.parametrize("config", list(ALL_CONFIGS))
def test_kernel_equals_the_plain_traversal_on_the_bench_batches(bench, config, batch):
    assert_kernel_equals_plain(bench, ALL_CONFIGS[config], batch)


@pytest.mark.parametrize("config", ["v1", "v2"])
def test_kernel_equals_the_plain_traversal_on_the_large_table(large, config):
    assert_kernel_equals_plain(large, CONFIGS[config], "merged")
