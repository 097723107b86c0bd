"""Surface interaction records, batched SoA (port of
``shimmer_tpu/shapes/interaction.py``).  Dead lanes carry finite values
and are masked by ``valid``.  The texture-filtering footprint (dudx, dvdx,
dudy, dvdy) is None until :meth:`SurfaceInteraction.with_camera_differentials`
sets it, which the path does only for a scene with textures; None reads
as zero (:meth:`SurfaceInteraction.footprint`)."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.frozen.ops.vecmath import Frame, coordinate_system, dot, gram_schmidt, normalize


@dataclasses.dataclass(frozen=True)
class SurfaceInteraction:
    valid: torch.Tensor        # (...,) bool
    t: torch.Tensor            # (...,)
    p: torch.Tensor            # (..., 3)
    n: torch.Tensor            # (..., 3) geometric normal
    uv: torch.Tensor           # (..., 2)
    wo: torch.Tensor           # (..., 3)
    dpdu: torch.Tensor         # (..., 3)
    dpdv: torch.Tensor         # (..., 3)
    ns: torch.Tensor           # (..., 3) shading normal
    dpdus: torch.Tensor        # (..., 3)
    material_id: torch.Tensor  # (...,) int32, -1 = none
    area_light_id: torch.Tensor  # (...,) int32, -1 = none
    med_in: torch.Tensor       # (...,) int32
    med_out: torch.Tensor      # (...,) int32
    # Texture-filtering footprint from ray differentials (None: zero).
    dudx: torch.Tensor | None = None
    dvdx: torch.Tensor | None = None
    dudy: torch.Tensor | None = None
    dvdy: torch.Tensor | None = None

    @staticmethod
    def make(valid, t, p, n, uv, wo, dpdu, dpdv, ns=None, dpdus=None, material_id=None,
             area_light_id=None, med_in=None, med_out=None) -> "SurfaceInteraction":
        """A record with the reference's defaults: shading frame = the
        geometric one, ids -1, and medium ids -2 (no interface)."""
        batch, dev = valid.shape, valid.device

        def ids(v, fill):
            return v if v is not None else torch.full(batch, fill, dtype=torch.int32, device=dev)

        return SurfaceInteraction(
            valid=valid, t=t, p=p, n=n, uv=uv, wo=wo, dpdu=dpdu, dpdv=dpdv,
            ns=ns if ns is not None else n,
            dpdus=dpdus if dpdus is not None else dpdu,
            material_id=ids(material_id, -1),
            area_light_id=ids(area_light_id, -1),
            med_in=ids(med_in, -2),
            med_out=ids(med_out, -2),
        )

    def footprint(self):
        """(dudx, dvdx, dudy, dvdy), zeros where no footprint was set."""
        if self.dudx is None:
            z = torch.zeros_like(self.t)
            return z, z, z, z
        return self.dudx, self.dvdx, self.dudy, self.dvdy

    def with_camera_differentials(self, ray_d, spread: float) -> "SurfaceInteraction":
        """Screen-space uv derivatives from an angular pixel footprint:
        dp/dx ~ t * spread along two axes perpendicular to the ray, then
        the least-squares projection onto (dpdu, dpdv)."""
        d = normalize(ray_d)
        ex, ey = coordinate_system(d)
        r = (self.t * spread)[..., None]
        r = torch.where(torch.isfinite(r), r, 0.0)
        dpdx = ex * r
        dpdy = ey * r
        ata00 = dot(self.dpdu, self.dpdu)
        ata01 = dot(self.dpdu, self.dpdv)
        ata11 = dot(self.dpdv, self.dpdv)
        det = ata00 * ata11 - ata01 * ata01
        inv = torch.where(torch.abs(det) > 1e-18, 1.0 / torch.where(det == 0, 1.0, det), 0.0)

        def solve(dp):
            b0 = dot(self.dpdu, dp)
            b1 = dot(self.dpdv, dp)
            du = (ata11 * b0 - ata01 * b1) * inv
            dv = (ata00 * b1 - ata01 * b0) * inv
            ok = torch.isfinite(du) & torch.isfinite(dv)
            return torch.where(ok, du, 0.0), torch.where(ok, dv, 0.0)

        dudx, dvdx = solve(dpdx)
        dudy, dvdy = solve(dpdy)
        return dataclasses.replace(self, dudx=dudx, dvdx=dvdx, dudy=dudy, dvdy=dvdy)

    def shading_frame(self) -> Frame:
        """Frame from the shading normal and tangent."""
        ns = self.ns
        t = normalize(gram_schmidt(self.dpdus, ns))
        bad = (torch.sum(t * t, dim=-1) < 1e-12)[..., None]
        fallback = Frame.from_z(ns)
        f = Frame.from_xz(t, ns)
        return Frame(
            x=torch.where(bad, fallback.x, f.x),
            y=torch.where(bad, fallback.y, f.y),
            z=ns,
        )
