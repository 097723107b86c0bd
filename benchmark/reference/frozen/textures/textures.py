"""Texture system: constant, scale, mix, direction-mix and image textures
over one texel atlas (port of ``shimmer_tpu/textures/textures.py``).

Every texture of a scene is a row of a :class:`TextureTable`, and every
image texel lives in one flat atlas of float32 x 4 texels: a float texture
uses channel 0, a spectrum texture stores the sigmoid coefficients of its
uplifted RGB and a per-texel scale, fitted once on the host.  The MIP
levels of an image are concatenated in the atlas with per-level offsets;
trilinear and the reference's fixed 8-tap EWA pick levels from the
ray-differential footprint.  Mappings: UV, spherical, cylindrical and
planar.

Evaluation is plain tensor code over lanes and follows the reference line
by line.  Two things differ in form, not in value:

- Every gather index is clamped into its table.  The reference reads a
  row that is not an image at MIP level -1 and relies on its gathers never
  faulting; those lanes are dropped by the kind mask in both packages.
- The image lookups of one evaluation (the texture itself and the
  operands of a scale or mix) run as one batch: ids of any leading shape
  broadcast against the interaction's lanes, so ``eval_texture_raw`` of a
  (K, N) id tensor evaluates K textures per lane in one pass.  Each lane's
  arithmetic is the same.

The table's census (kinds, mappings and filters present) skips branches
that no row takes, which gives the same values.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference.frozen.color.colorspace import get_named_color_space
from benchmark.reference.frozen.config import f32, i32, resolve_device
from benchmark.reference.frozen.film.image import Image
from benchmark.reference.frozen.ops.math import (
    dot_lanes,
    lerp,
    safe_acos,
    sqr,
    sqrt,
    take_clamped,
    take_wrapped,
    to_i32,
)
from benchmark.reference.frozen.ops.vecmath import dot, spherical_phi
from benchmark.reference.frozen.spectra.rgb2spec import fit_rgb_coeffs, sigmoid_poly_sample

# Texture kinds.
CONSTANT = 0
SCALED = 1
MIX = 2
IMAGE = 3
DIRECTION_MIX = 4

# Mappings.
MAP_UV = 0
MAP_SPHERICAL = 1
MAP_CYLINDRICAL = 2
MAP_PLANAR = 3

# Wrap modes.
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_BLACK = 2

# Filters.
FILTER_POINT = 0
FILTER_BILINEAR = 1
FILTER_TRILINEAR = 2
FILTER_EWA = 3

MAX_LEVELS = 16
EWA_TAPS = 8


@dataclasses.dataclass(frozen=True)
class TextureTable:
    """Per-texture parameter rows and the shared texel atlas."""

    kind: torch.Tensor           # (K,) int32
    const_value: torch.Tensor    # (K, 4) constant value, or coefficients + scale
    tex_a: torch.Tensor          # (K,) int32 operand texture (scale / mix)
    tex_b: torch.Tensor          # (K,) int32
    tex_c: torch.Tensor          # (K,) int32 mix amount texture (-1 = constant)
    mix_amount: torch.Tensor     # (K,)
    mix_dir: torch.Tensor        # (K, 3)
    level0_offset: torch.Tensor  # (K,) int32 texel offset of level 0
    level0_w: torch.Tensor       # (K,) int32
    level0_h: torch.Tensor       # (K,) int32
    n_levels: torch.Tensor       # (K,) int32
    wrap: torch.Tensor           # (K,) int32
    filter_kind: torch.Tensor    # (K,) int32
    scale: torch.Tensor          # (K,)
    invert: torch.Tensor         # (K,) bool: 1 - x
    mapping: torch.Tensor        # (K,) int32
    uv_scale: torch.Tensor       # (K, 2) su, sv
    uv_delta: torch.Tensor       # (K, 2) du, dv
    world_to_tex: torch.Tensor   # (K, 4, 4) for the spherical / cylindrical / planar maps
    planar_vs: torch.Tensor      # (K, 2, 3)
    atlas: torch.Tensor          # (A, 4) texel pool
    level_offsets: torch.Tensor  # (K, MAX_LEVELS) int32
    level_sizes: torch.Tensor    # (K, MAX_LEVELS, 2) int32 (w, h)
    # --- census ---
    kinds_present: tuple = ()
    has_amount_tex: bool = False  # a mix row with a textured amount
    mappings_present: tuple = (MAP_UV,)
    filters_present: tuple = ()


def census_of(kind, mapping, filter_kind) -> dict:
    """The port's extra census (mappings and filters the image rows use)
    from the host columns."""
    kind = np.asarray(kind)
    img = kind == IMAGE
    return {
        "mappings_present": tuple(sorted({MAP_UV} | {int(m) for m in np.asarray(mapping)[img]})),
        "filters_present": tuple(sorted({int(f) for f in np.asarray(filter_kind)[img]})),
    }


class TextureBuilder:
    """Host-side accumulation of a scene's textures into a TextureTable."""

    def __init__(self):
        self.rows = []
        self.atlas_chunks = []
        self.atlas_size = 0

    def _new_row(self, kind):
        row = {
            "kind": kind,
            "const_value": np.zeros(4, np.float32),
            "tex_a": -1,
            "tex_b": -1,
            "tex_c": -1,
            "mix_amount": 0.5,
            "mix_dir": np.array([0, 0, 1], np.float32),
            "level0_offset": 0,
            "level0_w": 0,
            "level0_h": 0,
            "n_levels": 0,
            "wrap": WRAP_REPEAT,
            "filter_kind": FILTER_TRILINEAR,
            "scale": 1.0,
            "invert": False,
            "mapping": MAP_UV,
            "uv_scale": np.array([1.0, 1.0], np.float32),
            "uv_delta": np.zeros(2, np.float32),
            "world_to_tex": np.eye(4, dtype=np.float32),
            "planar_vs": np.array([[1, 0, 0], [0, 1, 0]], np.float32),
            "level_offsets": np.zeros(MAX_LEVELS, np.int32),
            "level_sizes": np.zeros((MAX_LEVELS, 2), np.int32),
        }
        self.rows.append(row)
        return len(self.rows) - 1, row

    def add_constant_float(self, value: float) -> int:
        i, row = self._new_row(CONSTANT)
        row["const_value"][0] = value
        return i

    def add_constant_spectrum_coeffs(self, coeffs, scale: float = 1.0) -> int:
        i, row = self._new_row(CONSTANT)
        row["const_value"][:3] = np.asarray(coeffs, np.float32)
        row["const_value"][3] = scale
        return i

    def add_scaled(self, tex: int, scale_tex: int) -> int:
        i, row = self._new_row(SCALED)
        row["tex_a"] = tex
        row["tex_b"] = scale_tex
        return i

    def add_mix(self, tex1: int, tex2: int, amount: float = 0.5, amount_tex: int = -1) -> int:
        """lerp(amount, tex1, tex2); the amount may be a (leaf) float
        texture, else the constant column holds it."""
        i, row = self._new_row(MIX)
        row["tex_a"] = tex1
        row["tex_b"] = tex2
        row["mix_amount"] = amount
        row["tex_c"] = amount_tex
        return i

    def add_direction_mix(self, tex1: int, tex2: int, dir) -> int:
        """amt = dot(n, dir); tex1 * (1 - amt) + tex2 * amt."""
        i, row = self._new_row(DIRECTION_MIX)
        row["tex_a"] = tex1
        row["tex_b"] = tex2
        row["mix_dir"] = np.asarray(dir, np.float32)
        return i

    def add_image(
        self,
        texels: np.ndarray,
        is_spectrum: bool,
        colorspace=None,
        wrap=WRAP_REPEAT,
        filter_kind=FILTER_TRILINEAR,
        scale: float = 1.0,
        invert: bool = False,
        mapping=MAP_UV,
        uv_scale=(1.0, 1.0),
        uv_delta=(0.0, 0.0),
        max_levels: int = MAX_LEVELS,
        spectrum_type: str = "albedo",
        world_to_tex=None,
        planar_vs=None,
    ) -> int:
        """An image texture from (H, W) floats or (H, W, 3) linear RGB.  A
        spectrum texture is uplifted per texel to sigmoid coefficients
        (each unique color of each level fitted once): albedo clamps to
        [0, 1] with scale 1, unbounded divides by 2 max(rgb)."""
        i, row = self._new_row(IMAGE)
        row["wrap"] = wrap
        row["filter_kind"] = filter_kind
        row["scale"] = scale
        row["invert"] = invert
        row["mapping"] = mapping
        row["uv_scale"] = np.asarray(uv_scale, np.float32)
        row["uv_delta"] = np.asarray(uv_delta, np.float32)
        if world_to_tex is not None:
            row["world_to_tex"] = np.asarray(world_to_tex, np.float32)
        if planar_vs is not None:
            row["planar_vs"] = np.asarray(planar_vs, np.float32)

        pyramid = Image(np.asarray(texels, np.float32)).generate_pyramid()[:max_levels]
        row["n_levels"] = len(pyramid)
        for li, lvl in enumerate(pyramid):
            data = lvl.data
            h, w = data.shape[:2]
            if is_spectrum:
                rgb = data[..., :3].astype(np.float64)
                m = rgb.max(axis=-1)
                if spectrum_type == "albedo":
                    tscale = np.ones_like(m)
                    base = np.clip(rgb, 0.0, 1.0)
                else:
                    tscale = 2.0 * np.maximum(m, 1e-12)
                    base = rgb / tscale[..., None]
                flat = base.reshape(-1, 3).astype(np.float32)
                uniq, inv = np.unique(flat, axis=0, return_inverse=True)
                cs = colorspace or get_named_color_space("srgb")
                coeffs = fit_rgb_coeffs(uniq.astype(np.float64), cs)[inv]
                texel4 = np.concatenate(
                    [coeffs.reshape(h, w, 3), tscale.reshape(h, w, 1).astype(np.float32)],
                    axis=-1,
                )
            else:
                texel4 = np.zeros((h, w, 4), np.float32)
                texel4[..., 0] = data[..., 0]
            off = self.atlas_size
            self.atlas_chunks.append(texel4.reshape(-1, 4))
            self.atlas_size += h * w
            row["level_offsets"][li] = off
            row["level_sizes"][li] = (w, h)
            if li == 0:
                row["level0_offset"] = off
                row["level0_w"] = w
                row["level0_h"] = h
        return i

    def build(self, device=None) -> TextureTable:
        """The table on ``device`` (default: the CUDA card)."""
        device = resolve_device(device)
        if not self.rows:
            self.add_constant_float(0.0)

        def g(key, dt=np.float32):
            return np.asarray([r[key] for r in self.rows], dt)

        atlas = (np.concatenate(self.atlas_chunks) if self.atlas_chunks
                 else np.zeros((1, 4), np.float32))
        kind = g("kind", np.int32)
        return TextureTable(
            kind=i32(kind, device),
            const_value=f32(g("const_value"), device),
            tex_a=i32(g("tex_a", np.int32), device),
            tex_b=i32(g("tex_b", np.int32), device),
            tex_c=i32(g("tex_c", np.int32), device),
            mix_amount=f32(np.asarray([float(r["mix_amount"]) for r in self.rows], np.float32),
                           device),
            mix_dir=f32(g("mix_dir"), device),
            level0_offset=i32(g("level0_offset", np.int32), device),
            level0_w=i32(g("level0_w", np.int32), device),
            level0_h=i32(g("level0_h", np.int32), device),
            n_levels=i32(g("n_levels", np.int32), device),
            wrap=i32(g("wrap", np.int32), device),
            filter_kind=i32(g("filter_kind", np.int32), device),
            scale=f32(g("scale"), device),
            invert=torch.from_numpy(g("invert", bool)).to(device),
            mapping=i32(g("mapping", np.int32), device),
            uv_scale=f32(g("uv_scale"), device),
            uv_delta=f32(g("uv_delta"), device),
            world_to_tex=f32(g("world_to_tex"), device),
            planar_vs=f32(g("planar_vs"), device),
            atlas=f32(atlas, device),
            level_offsets=i32(g("level_offsets", np.int32), device),
            level_sizes=i32(g("level_sizes", np.int32), device),
            kinds_present=tuple(sorted({int(k) for k in kind})),
            has_amount_tex=any(int(r["tex_c"]) >= 0 for r in self.rows),
            **census_of(kind, g("mapping", np.int32), g("filter_kind", np.int32)),
        )


# --- device evaluation ---


def _apply_mapping(table: TextureTable, tex_id, si):
    """(u, v) and the screen-space derivatives of the texture's mapping."""
    mapping = take_clamped(table.mapping, tex_id)
    scale = take_clamped(table.uv_scale, tex_id)
    delta = take_clamped(table.uv_delta, tex_id)
    su, sv = scale[..., 0], scale[..., 1]
    du, dv = delta[..., 0], delta[..., 1]
    s_dudx, s_dvdx, s_dudy, s_dvdy = si.footprint()
    u = si.uv[..., 0] * su + du
    v = si.uv[..., 1] * sv + dv
    dudx = s_dudx * su
    dvdx = s_dvdx * sv
    dudy = s_dudy * su
    dvdy = s_dvdy * sv
    if table.mappings_present == (MAP_UV,):
        return u, v, dudx, dvdx, dudy, dvdy
    m = take_clamped(table.world_to_tex, tex_id)
    p = si.p
    p_t = torch.stack(
        [dot_lanes([(m[..., i, j], p[..., j]) for j in range(3)]) + m[..., i, 3]
         for i in range(3)],
        dim=-1,
    )
    norm = sqrt(torch.sum(p_t * p_t, dim=-1))
    sph_theta = safe_acos(torch.clamp(p_t[..., 2] / torch.clamp(norm, min=1e-9), -1.0, 1.0))
    sph_phi = spherical_phi(p_t)
    u_sph = sph_theta / math.pi * su + du
    v_sph = sph_phi / (2.0 * math.pi) * sv + dv
    vs = take_clamped(table.planar_vs, tex_id)
    u_pl = dot(p_t, vs[..., 0, :]) * su + du
    v_pl = dot(p_t, vs[..., 1, :]) * sv + dv
    u_cyl = (math.pi + torch.atan2(p_t[..., 1], p_t[..., 0])) / (2.0 * math.pi) * su + du
    v_cyl = p_t[..., 2] * sv + dv
    sph, pl, cyl = mapping == MAP_SPHERICAL, mapping == MAP_PLANAR, mapping == MAP_CYLINDRICAL
    u = torch.where(sph, u_sph, torch.where(pl, u_pl, torch.where(cyl, u_cyl, u)))
    v = torch.where(sph, v_sph, torch.where(pl, v_pl, torch.where(cyl, v_cyl, v)))
    return u, v, dudx, dvdx, dudy, dvdy


def _wrap_coord(x, n, wrap):
    """Integer texel coordinate -> (in-range coordinate, in-bounds flag)."""
    n = torch.clamp(n, min=1)
    rep = torch.remainder(x, n)
    clam = torch.minimum(torch.maximum(x, torch.zeros_like(x)), n - 1)
    inb = (x >= 0) & (x < n)
    out = torch.where(wrap == WRAP_REPEAT, rep, clam)
    ok = torch.where(wrap == WRAP_BLACK, inb, True)
    return out, ok


class _Rows:
    """The per-lane rows one image lookup reads, gathered once."""

    def __init__(self, table: TextureTable, tex_id):
        self.table = table
        self.tex = torch.clamp(tex_id.long(), 0, table.kind.shape[0] - 1)
        self.n_levels = table.n_levels[self.tex]
        self.wrap = table.wrap[self.tex]

    def level(self, level):
        """Offset, width and height of a MIP level (clamped to the row's
        levels, then into the table)."""
        lvl = torch.minimum(torch.clamp(level, min=0), self.n_levels - 1)
        lvl = torch.clamp(lvl, 0, self.table.level_offsets.shape[1] - 1).long()
        off = self.table.level_offsets[self.tex, lvl]
        wh = self.table.level_sizes[self.tex, lvl]
        return off, wh[..., 0], wh[..., 1]


def _fetch(rows: _Rows, off, w, h, x, y):
    """Atlas gather at integer texel (x, y) of the level at ``off`` (w x h),
    with wrap handling -> (..., 4)."""
    xi, okx = _wrap_coord(x, w, rows.wrap)
    yi, oky = _wrap_coord(y, h, rows.wrap)
    idx = off.long() + yi.long() * w.long() + xi.long()
    t = rows.table.atlas[torch.clamp(idx, 0, rows.table.atlas.shape[0] - 1)]
    return torch.where((okx & oky)[..., None], t, 0.0)


def _texel_fetch(rows: _Rows, level, x, y):
    return _fetch(rows, *rows.level(level), x, y)


def _bilerp_level(rows: _Rows, level, u, v):
    off, w, h = rows.level(level)
    x = u * w.to(torch.float32) - 0.5
    y = v * h.to(torch.float32) - 0.5
    x0 = to_i32(torch.floor(x))
    y0 = to_i32(torch.floor(y))
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    t00 = _fetch(rows, off, w, h, x0, y0)
    t10 = _fetch(rows, off, w, h, x0 + 1, y0)
    t01 = _fetch(rows, off, w, h, x0, y0 + 1)
    t11 = _fetch(rows, off, w, h, x0 + 1, y0 + 1)
    return (
        (1 - dx) * (1 - dy) * t00
        + dx * (1 - dy) * t10
        + (1 - dx) * dy * t01
        + dx * dy * t11
    )


def _ewa_level(rows: _Rows, level, u, v, dudx, dvdx, dudy, dvdy):
    """The reference's EWA: EWA_TAPS bilinear taps along the footprint's
    major axis with Gaussian weights, at one level."""
    major = torch.stack([dudx, dvdx], dim=-1)
    minor = torch.stack([dudy, dvdy], dim=-1)
    swap = torch.sum(major * major, -1) < torch.sum(minor * minor, -1)
    major = torch.where(swap[..., None], torch.stack([dudy, dvdy], -1), major)
    total = torch.zeros(u.shape + (4,), dtype=torch.float32, device=u.device)
    wsum = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(EWA_TAPS):
        t = (i + 0.5) / EWA_TAPS * 2.0 - 1.0  # [-1, 1]
        wgt = float(np.exp(-2.0 * t * t))
        uu = u + t * major[..., 0]
        vv = v + t * major[..., 1]
        total = total + wgt * _bilerp_level(rows, level, uu, vv)
        wsum = wsum + wgt
    return total / wsum[..., None]


def _eval_image(table: TextureTable, tex_id, si):
    u, v, dudx, dvdx, dudy, dvdy = _apply_mapping(table, tex_id, si)
    rows = _Rows(table, tex_id)
    w0 = take_clamped(table.level0_w, tex_id).to(torch.float32)
    h0 = take_clamped(table.level0_h, tex_id).to(torch.float32)
    fk = take_clamped(table.filter_kind, tex_id)
    # Level of detail from the longer screen-space axis.
    width2 = torch.maximum(
        (sqr(dudx) + sqr(dvdx)) * sqr(w0) * 0.0 + (sqr(dudx * w0) + sqr(dvdx * h0)),
        sqr(dudy * w0) + sqr(dvdy * h0),
    )
    lod = 0.5 * torch.log2(torch.clamp(width2, min=1e-12))
    lod = torch.minimum(torch.maximum(lod, torch.zeros_like(lod)),
                        rows.n_levels.to(torch.float32) - 1.0)
    l0 = to_i32(torch.floor(lod))
    frac = (lod - l0.to(torch.float32))[..., None]
    t_bil0 = _bilerp_level(rows, l0, u, v)
    t_bil1 = _bilerp_level(rows, torch.minimum(l0 + 1, rows.n_levels - 1), u, v)
    out = (1.0 - frac) * t_bil0 + frac * t_bil1
    if FILTER_EWA in table.filters_present:
        t_ewa = _ewa_level(rows, l0, u, v, dudx, dvdx, dudy, dvdy)
        out = torch.where((fk == FILTER_EWA)[..., None], t_ewa, out)
    out = torch.where((fk == FILTER_BILINEAR)[..., None], t_bil0, out)
    if FILTER_POINT in table.filters_present:
        nearest = _texel_fetch(rows, l0, to_i32(u * w0), to_i32(v * h0))
        out = torch.where((fk == FILTER_POINT)[..., None], nearest, out)
    return out


def eval_texture_raw(table: TextureTable, tex_id, si):
    """Texture rows -> the raw (..., 4) payload (a value, or coefficients
    and scale).  Scale and mix operands are one level deep (leaves or
    images), as the reference's builder flattens them."""
    tex_id = tex_id.long()
    batch = torch.broadcast_shapes(tex_id.shape, si.t.shape)
    out = torch.broadcast_to(take_clamped(table.const_value, tex_id), batch + (4,))
    kind = take_clamped(table.kind, tex_id)
    present = set(table.kinds_present)
    combinators = {SCALED, MIX, DIRECTION_MIX} & present
    has_image = IMAGE in present
    c_tid = None
    # The ids whose image lookups this evaluation needs, batched.
    ids = [tex_id]
    if combinators:
        ids += [torch.clamp(take_clamped(table.tex_a, tex_id), min=0),
                torch.clamp(take_clamped(table.tex_b, tex_id), min=0)]
        if MIX in present and table.has_amount_tex:
            c_tid = take_clamped(table.tex_c, tex_id)
            ids.append(torch.clamp(c_tid, min=0))
    ids = [torch.broadcast_to(i, batch) for i in ids]
    if has_image:
        images = _eval_image(table, torch.stack(ids), si)
        out = torch.where((kind == IMAGE)[..., None], images[0], out)
    if combinators:
        a_id, b_id = ids[1], ids[2]
        a_val = torch.broadcast_to(take_clamped(table.const_value, a_id), out.shape)
        b_val = torch.broadcast_to(take_clamped(table.const_value, b_id), out.shape)
        if has_image:
            a_val = torch.where((take_clamped(table.kind, a_id) == IMAGE)[..., None], images[1], a_val)
            b_val = torch.where((take_clamped(table.kind, b_id) == IMAGE)[..., None], images[2], b_val)
        if SCALED in present:
            out = torch.where((kind == SCALED)[..., None], a_val * b_val[..., 0:1], out)
        if MIX in present:
            amt = torch.broadcast_to(take_clamped(table.mix_amount, tex_id), batch)
            if c_tid is not None:
                c_id = ids[3]
                c_val = torch.broadcast_to(take_clamped(table.const_value, c_id)[..., 0], batch)
                if has_image:
                    c_val = torch.where(take_clamped(table.kind, c_id) == IMAGE, images[3][..., 0], c_val)
                amt = torch.where(c_tid >= 0, c_val, amt)
            mixed = lerp(amt[..., None], a_val, b_val)
            out = torch.where((kind == MIX)[..., None], mixed, out)
        if DIRECTION_MIX in present:
            d_amt = dot(si.n, take_clamped(table.mix_dir, tex_id))
            dmixed = lerp(d_amt[..., None], a_val, b_val)
            out = torch.where((kind == DIRECTION_MIX)[..., None], dmixed, out)
    out = out * take_clamped(table.scale, tex_id)[..., None]
    return torch.where(take_clamped(table.invert, tex_id)[..., None], 1.0 - out, out)


def eval_float_texture(table: TextureTable, tex_id, si):
    """A float texture -> (...,)."""
    return eval_texture_raw(table, tex_id, si)[..., 0]


def _spectrum(raw, swl):
    """A spectrum payload (coefficients and scale) at the hero wavelengths."""
    return sigmoid_poly_sample(raw[..., :3], swl.lam) * raw[..., 3][..., None]


def eval_spectrum_texture(table: TextureTable, tex_id, si, swl):
    """A spectrum texture -> (..., 4) samples at the hero wavelengths, from
    the baked sigmoid coefficients."""
    return _spectrum(eval_texture_raw(table, tex_id, si), swl)


# Material columns a texture may drive, and the material's constant column.
_MATERIAL_TEXTURES = (("reflectance", "tex_reflectance"), ("uroughness", "tex_uroughness"),
                      ("vroughness", "tex_vroughness"))


def textured_params(columns: dict) -> tuple:
    """The material parameters some material takes from a texture, from the
    host texture-id columns (the material table's census)."""
    return tuple(name for name, col in _MATERIAL_TEXTURES
                 if np.any(np.asarray(columns[col]) >= 0))


def evaluate_material_textures(table: TextureTable, materials, si, swl):
    """Per-lane texture-driven material parameters: ``reflectance`` (a
    (..., 4) spectrum), ``uroughness`` and ``vroughness``, each the
    texture's value where the lane's material has one and the constant
    elsewhere.  Only the parameters some material textures
    (``materials.textured_params``) are evaluated; the BSDFs read the
    others from their constant columns, which gives the same values."""
    columns = materials.textured_params
    if not columns:
        return {}
    mid = si.material_id
    tids = torch.stack([take_wrapped(getattr(materials, dict(_MATERIAL_TEXTURES)[c]), mid)
                        for c in columns])
    raw = eval_texture_raw(table, torch.clamp(tids, min=0), si)
    tex = {}
    for k, name in enumerate(columns):
        has = tids[k] >= 0
        if name == "reflectance":
            val = _spectrum(raw[k], swl)
            const = sigmoid_poly_sample(take_wrapped(materials.reflectance, mid), swl.lam)
            tex[name] = torch.where(has[..., None], val, const)
        else:
            tex[name] = torch.where(has, raw[k][..., 0], take_wrapped(getattr(materials, name), mid))
    return tex
