"""Surface interaction records, batched SoA (port of
``shimmer_tpu/shapes/interaction.py``).  Dead lanes carry finite values
and are masked by ``valid``.  The texture-footprint fields (dudx ...) wait
for the texture slice: nothing in the port reads them yet."""

from __future__ import annotations

import dataclasses

import torch

from shimmer_tpu_torch.ops.vecmath import Frame, gram_schmidt, normalize


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
