"""Normal and bump mapping (port of ``shimmer_tpu/textures/normal_bump.py``):
adjusts the shading normal and tangent of a hit before its shading frame is
built.  Evaluated for every lane and kept where the lane's material carries
a map, as the reference does.  The bump map's three displacement lookups
(at uv, uv + (du, 0) and uv + (0, dv)) run as one batch.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.frozen.ops.math import take_wrapped
from benchmark.reference.frozen.ops.vecmath import Frame, cross, dot, gram_schmidt, length_squared, normalize
from benchmark.reference.frozen.textures.textures import eval_texture_raw


def apply_normal_bump(scene, si):
    """``si`` with ``ns`` / ``dpdus`` set by the material's normal or bump
    map (lanes without one untouched)."""
    table = scene.textures
    if table is None or not (scene.has_normal_maps or scene.has_bump_maps):
        return si
    materials = scene.materials
    ns, dpdus = si.ns, si.dpdus

    if scene.has_normal_maps:
        n_tex = take_wrapped(materials.normal_tex, si.material_id)
        has_normal = (n_tex >= 0)[..., None]
        raw = eval_texture_raw(table, torch.clamp(n_tex, min=0), si)
        # Tangent-space normal: rgb in [0, 1] -> 2x - 1.
        n_local = normalize(2.0 * raw[..., :3] - 1.0)
        frame = Frame.from_xz(normalize(gram_schmidt(si.dpdus, si.ns)), si.ns)
        n_new = frame.from_local(n_local)
        t_new = gram_schmidt(si.dpdus, n_new)
        bad = length_squared(t_new) < 1e-12
        t_new = torch.where(bad[..., None], frame.x, t_new)
        ns = torch.where(has_normal, normalize(n_new), ns)
        dpdus = torch.where(has_normal, t_new, dpdus)

    if scene.has_bump_maps:
        d_tex = take_wrapped(materials.displacement_tex, si.material_id)
        has_bump = (d_tex >= 0)[..., None]
        # Finite differences of the displacement along u and v: the normal
        # from the displaced partials.
        dudx, dvdx, dudy, dvdy = si.footprint()
        du = 0.5 * (torch.abs(dudx) + torch.abs(dudy))
        dv = 0.5 * (torch.abs(dvdx) + torch.abs(dvdy))
        du = torch.where(du == 0.0, 0.0005, du)
        dv = torch.where(dv == 0.0, 0.0005, dv)
        zero = torch.zeros_like(du)
        uv3 = torch.stack([si.uv,
                           si.uv + torch.stack([du, zero], -1),
                           si.uv + torch.stack([zero, dv], -1)])
        tex_id = torch.clamp(d_tex, min=0)
        disp3 = eval_texture_raw(table, tex_id.expand(3, *tex_id.shape),
                                 dataclasses.replace(si, uv=uv3))[..., 0]
        disp, disp_u, disp_v = disp3[0], disp3[1], disp3[2]
        dddu = (disp_u - disp) / du
        dddv = (disp_v - disp) / dv
        dpdu_b = si.dpdus + dddu[..., None] * si.ns
        dpdv_b = si.dpdv + dddv[..., None] * si.ns
        n_b = normalize(cross(dpdu_b, dpdv_b))
        # Keep the orientation of the shading normal.
        n_b = torch.where((dot(n_b, si.ns) < 0.0)[..., None], -n_b, n_b)
        ns = torch.where(has_bump, n_b, ns)
        dpdus = torch.where(has_bump, dpdu_b, dpdus)

    return dataclasses.replace(si, ns=ns, dpdus=dpdus)
