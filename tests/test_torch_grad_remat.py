"""tests/test_grad.py::TestProductionScaleGradients::test_remat_matches_nonremat
in the port: on that test's triangle scene (a displaced grid, a floor and
a quad light; 64x64, 1 spp, depth 3, seed 11), ``li_path(remat=...)``
for False, True and "full" gives the same forward value (``torch.equal``)
and the same gradient with respect to one reflectance coefficient (within
1e-6 relative; they have been equal where this was written).

"full" checkpoints each bounce: the backward reruns it, traversal
included, so the traversal runs 1 + depth times in the forward and depth
more in the backward, and not at all in the backward of the other forms.
The forward's traced-ray count does not change with the form."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np
import pytest
import torch

import shimmer_tpu_torch.ops.traverse as traverse_mod
from shimmer_tpu_torch.integrators.path import li_path
from shimmer_tpu_torch.samplers import IndependentSampler
import test_grad
from torch_grad import port_camera, port_film, port_scene, replace, set_entry
from torch_parity import ensure_reference_sah

torch.set_num_threads(1)

DEPTH = 3


@pytest.fixture(scope="module")
def tri_scene():
    ensure_reference_sah()
    jscene, jcam, _ = test_grad.TestProductionScaleGradients._tri_scene()
    res = jcam.resolution[0]
    return port_scene(jscene), port_camera(jcam, fov=42.0), port_film(res)


def _rays(cam, film):
    from shimmer_tpu_torch.film.filters import get_camera_sample

    res = film.resolution[0]
    sampler = IndependentSampler(1, seed=11)
    ys, xs = torch.meshgrid(torch.arange(res, dtype=torch.int32),
                            torch.arange(res, dtype=torch.int32), indexing="ij")
    pixel_xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    s_state = sampler.start_pixel_sample(pixel_xy, torch.tensor(0))
    u_lam, s_state = sampler.get_1d(s_state)
    swl = film.sample_wavelengths(u_lam)
    u_f, s_state = sampler.get_pixel_2d(s_state)
    u_l, s_state = sampler.get_2d(s_state)
    p_film, _, u_l = get_camera_sample(film.filter, pixel_xy, u_f, u_l)
    return cam.generate_ray(p_film, u_l), swl, sampler, s_state


def _value_grad(tri_scene, remat, calls):
    scene, cam, film = tri_scene
    ray, swl, sampler, s_state = _rays(cam, film)
    calls.clear()
    theta = torch.tensor(0.45, requires_grad=True)
    refl = set_entry(scene.materials.reflectance, (0, 1), theta)
    l, st = li_path(replace(scene, "materials", reflectance=refl), ray, swl, sampler, s_state,
                    DEPTH, return_stats=True, remat=remat)
    v = torch.mean(l)
    n_fwd = len(calls)
    (g,) = torch.autograd.grad(v, theta)
    return v.detach(), float(g), float(st["rays"]), n_fwd, len(calls) - n_fwd


@pytest.fixture
def traversal_calls(monkeypatch):
    calls = []
    plain = traverse_mod.traverse_raw

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return plain(*args, **kwargs)

    monkeypatch.setattr(traverse_mod, "traverse_raw", counted)
    return calls


def test_remat_matches_nonremat(tri_scene, traversal_calls):
    out = {r: _value_grad(tri_scene, r, traversal_calls) for r in (False, True, "full")}
    v0, g0, rays0, _, _ = out[False]
    assert np.isfinite(g0) and abs(g0) > 1e-6
    for remat, (v, g, rays, n_fwd, n_bwd) in out.items():
        assert torch.equal(v, v0), remat
        np.testing.assert_allclose(g, g0, rtol=1e-6, err_msg=str(remat))
        assert rays == rays0
        assert n_fwd == 1 + DEPTH, remat
        assert n_bwd == (DEPTH if remat == "full" else 0), remat


def test_remat_rejects_unknown_form(tri_scene):
    scene, cam, film = tri_scene
    ray, swl, sampler, s_state = _rays(cam, film)
    with pytest.raises(ValueError, match="remat"):
        li_path(scene, ray, swl, sampler, s_state, 1, remat="scan")
