"""The port's own host builders (shimmer_tpu_torch/ops/bvh.py, ops/bvh8.py,
native/) against the reference's: the same meshes give byte-identical
``rows8``, ``meta`` and ``perm``, through the native SAH builder and through
the numpy LBVH fallback; and the Moller-Trumbore leaf packing of ``rows8``
equals the reference's packing of its TPU tiles (``ops/bvh8.py:303-310``,
run in a subprocess with SHIMMER_LEAF_MT=1, since the reference reads the
flag when it is imported)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shimmer_tpu.ops import bvh8 as jbvh8
from shimmer_tpu_torch.bench_scene import bench_camera_film, bench_meshes, make_displaced_sphere
from shimmer_tpu_torch.ops import bvh8 as tbvh8
from shimmer_tpu_torch.shapes.triangle import _concat_meshes
from torch_parity import ensure_reference_sah, random_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _geometry(name):
    """(lo, hi, tri_p) of a test mesh: the small bench scene (1,280 sphere
    triangles plus the floor and light quads), the random soup of
    tests/test_pallas_traverse.py, or a 20,480-triangle displaced sphere."""
    if name == "bench":
        cam, _ = bench_camera_film((16, 8))
        cat = _concat_meshes(bench_meshes(1280, cam.camera_transform.render_from_world()))
        tri = cat["tri_p"]
    elif name == "soup":
        m = random_mesh(np.random.default_rng(7))
        tri = m["p"][m["indices"]]
    else:
        v, f = make_displaced_sphere(20_000)
        tri = v[f]
    tri = np.asarray(tri, np.float32)
    return tri.min(axis=1), tri.max(axis=1), tri


@pytest.mark.parametrize("builder", ["auto", "lbvh"])
@pytest.mark.parametrize("geometry", ["bench", "soup", "sphere20k"])
def test_pack_bvh8_byte_identical(geometry, builder):
    ensure_reference_sah()
    lo, hi, tri = _geometry(geometry)
    ref = jbvh8.pack_bvh8(lo, hi, tri, builder=builder)
    got = tbvh8.pack_bvh8(lo, hi, tri, builder=builder)
    for field in ("rows", "meta", "perm"):
        a, b = getattr(ref, field), getattr(got, field)
        assert b.dtype == a.dtype and b.shape == a.shape, field
        assert b.tobytes() == a.tobytes(), field
    assert (got.n_rows, got.max_depth) == (ref.n_rows, ref.max_depth)
    assert tbvh8.bvh8_validate(got, lo, hi)


_JAX_MT_TILES = """
import sys
import numpy as np
from shimmer_tpu.ops import bvh8
assert bvh8.LEAF_MT
z = np.load(sys.argv[1])
np.save(sys.argv[2], bvh8.pack_tiles8(z["rows"], z["meta"]))
"""


def _tile_fields(tiles, n_rows):
    """Invert pack_tiles8's layout: fields[r, slot, c] of node row r."""
    r8 = tiles.shape[0]
    return tiles.reshape(r8, 8, 8, 16).transpose(0, 2, 1, 3).reshape(r8 * 8, 8, 16)[:n_rows]


@pytest.mark.parametrize("geometry", ["bench", "soup"])
def test_mt_leaf_packing_matches_reference(tmp_path, geometry):
    lo, hi, tri = _geometry(geometry)
    arrs = tbvh8.pack_bvh8(lo, hi, tri)
    np.savez(tmp_path / "rows.npz", rows=arrs.rows, meta=arrs.meta)
    env = {k: v for k, v in os.environ.items() if not k.startswith("SHIMMER_")}
    env.update(SHIMMER_LEAF_MT="1", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_MT_TILES, str(tmp_path / "rows.npz"), str(tmp_path / "tiles.npy")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    fields = _tile_fields(np.load(tmp_path / "tiles.npy"), arrs.n_rows)

    mt = tbvh8.pack_leaves_mt(arrs.rows, arrs.meta)
    leaf = (arrs.meta & 15) > 0
    assert leaf.any()
    # Leaf fields c0..c8 (p0, e1, e2) of every slot, bit for bit.
    mt_fields = mt[:, :72].reshape(-1, 9, 8).transpose(0, 2, 1)
    assert mt_fields[leaf].tobytes() == np.ascontiguousarray(fields[leaf, :, 0:9]).tobytes()
    # Internal rows and the leaf ids / counts are untouched.
    np.testing.assert_array_equal(mt[~leaf], arrs.rows[~leaf])
    np.testing.assert_array_equal(mt[:, 72:], arrs.rows[:, 72:])
    np.testing.assert_array_equal(mt[leaf, 0:24], arrs.rows[leaf, 0:24])
