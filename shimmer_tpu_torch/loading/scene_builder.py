"""SceneBuilder: pbrt-v4 directive handling and device-scene creation (port
of ``shimmer_tpu/loading/scene_builder.py``).

The graphics state (CTM, reverse orientation, material, area light,
scoped ``Attribute`` parameters), named coordinate systems and the
attribute stack follow the reference; ``create()`` runs its creation
passes in its order (film and filter, camera, materials, shapes with
their area lights, the other lights, the triangle BVH, the instanced
objects' two-level BVH, the scene) and returns a ``RenderJob``.
Transforms are kept in float64 while parsing; each matrix and its float64
inverse are rounded once to float32, and every array reaches the device
through ``config.f32`` / ``config.i32``.

The port's slice of pbrt-v4: ``trianglemesh``, ``plymesh``, ``sphere``
and ``bilinearmesh`` shapes; ``ObjectBegin`` / ``ObjectEnd`` /
``ObjectInstance`` (an object's triangle meshes shared through the
two-level BVH, its other shapes copied per instance; an area light inside
an object raises); materials ``diffuse``, ``conductor``, ``dielectric``,
``thindielectric``, ``coateddiffuse``, ``coatedconductor`` and ``mix``
(named through ``MakeNamedMaterial`` / ``NamedMaterial`` or not), with
``"texture ..."`` parameters where the reference reads them (reflectance,
roughness, a mix's amount, displacement), and the material-less
``interface`` (``""``, ``"none"``); the ``Texture`` classes ``constant``,
``imagemap``, ``scale``, ``mix`` and ``directionmix``; ``diffuse`` area
lights on triangles, spheres and bilinear patches; ``point``, ``spot``
and ``distant`` lights; the ``infinite`` light with a constant ``L`` or an image
``filename``; ``homogeneous`` media through ``MakeNamedMedium`` and
``MediumInterface`` (the camera sits in the outside medium current at
``Camera``; triangle meshes carry the interface); the ``perspective``
(pinhole or thin lens), ``orthographic`` and ``spherical`` cameras with
the screen window, the shutter and the three render spaces of ``Option
"rendercoordsys"``; the ``rgb`` film with the CIE 1931 sensor, its ISO and
white balance; the ``box``, ``triangle``, ``gaussian``, ``mitchell`` and
``sinc`` filters; the ``independent``, ``stratified`` and ``zsobol``
samplers; the ``path`` (and ``volpath``), ``simplepath`` and
``randomwalk`` integrators; ``ColorSpace``; the jitter options.  Images are read by ``film.image.Image.read`` (PFM, and the
8-bit formats through PIL; not EXR).  Everything else raises
NotImplementedError naming what it lacks, and so does any parameter that
nothing looked up when the job was created: no directive or parameter is
dropped silently.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path

import numpy as np

from shimmer_tpu_torch.color.colorspace import get_named_color_space
from shimmer_tpu_torch.loading.errors import ParameterError
from shimmer_tpu_torch.loading.paramdict import ParameterDictionary, SpectrumType
from shimmer_tpu_torch.film.image import Image
from shimmer_tpu_torch.ops.transform import Transform
from shimmer_tpu_torch.spectra.rgb2spec import fit_rgb_coeffs
from shimmer_tpu_torch.spectra.spectrum import ConstantSpectrum, named_spectrum
from shimmer_tpu_torch.textures import textures as tx
from shimmer_tpu_torch.textures.textures import TextureBuilder


class _Mat4:
    """Host 4x4 CTM helpers in float64."""

    @staticmethod
    def identity():
        return np.eye(4, dtype=np.float64)

    @staticmethod
    def translate(d):
        m = np.eye(4)
        m[:3, 3] = d
        return m

    @staticmethod
    def scale(s):
        return np.diag([s[0], s[1], s[2], 1.0])

    @staticmethod
    def rotate(angle_deg, axis):
        a = np.asarray(axis, np.float64)
        a = a / max(np.linalg.norm(a), 1e-12)
        rad = np.deg2rad(angle_deg)
        s, c = np.sin(rad), np.cos(rad)
        x, y, z = a
        r = np.array(
            [
                [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
                [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s],
                [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c],
            ]
        )
        m = np.eye(4)
        m[:3, :3] = r
        return m

    @staticmethod
    def look_at(eye, look, up):
        """pbrt's LookAt: the world-to-camera matrix (the inverse of the
        camera-to-world frame)."""
        eye = np.asarray(eye, np.float64)
        look = np.asarray(look, np.float64)
        up = np.asarray(up, np.float64)
        d = look - eye
        d = d / np.linalg.norm(d)
        right = np.cross(up / np.linalg.norm(up), d)
        right /= max(np.linalg.norm(right), 1e-12)
        new_up = np.cross(d, right)
        m = np.eye(4)
        m[:3, 0] = right
        m[:3, 1] = new_up
        m[:3, 2] = d
        m[:3, 3] = eye
        return np.linalg.inv(m)


@dataclasses.dataclass
class _GraphicsState:
    ctm: np.ndarray
    reverse_orientation: bool = False
    # Index into materials (-1: the default), or NO_MATERIAL.
    material: int | str = -1
    area_light: tuple | None = None  # (name, ParameterDictionary)
    # MediumInterface names (None: not declared / vacuum).
    medium_inside: str | None = None
    medium_outside: str | None = None
    # Scoped `Attribute "target" ...` parameters: lower-priority defaults
    # for every later entity of that target in this scope.
    attributes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RenderJob:
    scene: object
    camera: object
    film: object
    sampler: object
    integrator: str
    max_depth: int
    spp: int
    filename: str
    light_sampler: str = "uniform"
    disable_pixel_jitter: bool = False
    disable_wavelength_jitter: bool = False


# The options the port carries out.
_OPTIONS = {"seed", "rendercoordsys", "forcediffuse", "disabletexturefiltering",
            "disablepixeljitter", "disablewavelengthjitter"}
# The integrators by scene-file name (volpath is the path estimator, which
# carries the media; the reference maps it so too).
_INTEGRATORS = {"path": "path", "volpath": "path", "simplepath": "simplepath",
                "randomwalk": "randomwalk"}


# The graphics state's material after ``Material "interface"`` (or "" or
# "none"): shapes get material id -1 and rays pass through them.
NO_MATERIAL = "none"
MATERIAL_LESS = ("", "none", "interface")


def _unported(what: str, lacks: str = ""):
    return NotImplementedError(f"{what} is not ported yet" + (f" ({lacks})" if lacks else ""))


class SceneBuilder:
    """Parser target: records the directives, builds the job in create()."""

    def __init__(self, search_dir=None):
        self.search_dir = search_dir
        self.gs = _GraphicsState(ctm=_Mat4.identity())
        self.state_stack: list[_GraphicsState] = []
        self.named_coords: dict[str, np.ndarray] = {}
        self.camera_spec = ("perspective", ParameterDictionary([]), _Mat4.identity())
        self.film_spec = ("rgb", ParameterDictionary([]))
        self.sampler_spec = ("zsobol", ParameterDictionary([]))
        self.filter_spec = ("box", ParameterDictionary([]))
        self.integrator_spec = ("path", ParameterDictionary([]))
        self.accelerator_spec = ("bvh", ParameterDictionary([]))
        self.colorspace = get_named_color_space("srgb")
        self.shapes: list[dict] = []   # deferred shape records
        self.lights: list[dict] = []   # lights other than area lights
        self.materials: list[dict] = [{"kind_name": "diffuse", "pd": ParameterDictionary([])}]
        self.named_materials: dict[str, int] = {}
        self.options: dict = {}
        self.float_textures: dict[str, int] = {}
        self.spectrum_textures: dict[str, int] = {}
        self.tex_builder = TextureBuilder()
        self.texture_pds: list[tuple] = []  # (what, ParameterDictionary) to check at create
        self.named_media: dict[str, dict] = {}
        self.medium_pds: list[tuple] = []  # (what, ParameterDictionary) to check at create
        self.camera_medium_name: str | None = None
        self.objects: dict[str, list[dict]] = {}  # ObjectBegin name -> shape records
        self.instances: list[tuple[str, np.ndarray]] = []  # (object name, CTM)
        self.current_object: str | None = None

    # --- transforms ---

    def look_at(self, eye, look, up, loc):
        self.gs.ctm = self.gs.ctm @ _Mat4.look_at(eye, look, up)

    def translate(self, d, loc):
        self.gs.ctm = self.gs.ctm @ _Mat4.translate(d)

    def scale(self, s, loc):
        self.gs.ctm = self.gs.ctm @ _Mat4.scale(s)

    def rotate(self, angle, axis, loc):
        self.gs.ctm = self.gs.ctm @ _Mat4.rotate(angle, axis)

    def transform(self, m16, loc):
        # pbrt matrices are column-major.
        self.gs.ctm = np.asarray(m16, np.float64).reshape(4, 4).T

    def concat_transform(self, m16, loc):
        self.gs.ctm = self.gs.ctm @ np.asarray(m16, np.float64).reshape(4, 4).T

    def identity(self, loc):
        self.gs.ctm = _Mat4.identity()

    def coordinate_system(self, name, loc):
        self.named_coords[name] = self.gs.ctm.copy()

    def coord_sys_transform(self, name, loc):
        if name in self.named_coords:
            self.gs.ctm = self.named_coords[name].copy()
        else:
            warnings.warn(f"{loc}: unknown coordinate system {name!r}; the CTM is unchanged")

    # --- options and the entities before WorldBegin ---

    def _pd(self, params):
        return ParameterDictionary(params, self.colorspace)

    def color_space(self, name, loc):
        self.colorspace = get_named_color_space(name)

    def option(self, params, loc):
        """In-scene ``Option``: seed, forcediffuse, rendercoordsys (camera,
        cameraworld or world; another value raises at create, as in the
        reference), disablepixeljitter, disablewavelengthjitter and
        disabletexturefiltering (recorded with no effect, as in the
        reference: textures filter as their ``filter`` parameter says);
        any other option warns and is ignored, as in the reference."""
        for p in params:
            v = p.values[0]
            if p.type == "bool":
                v = v in (True, "true")
            if p.name not in _OPTIONS:
                warnings.warn(f"{loc}: unsupported Option {p.name!r} ignored")
                continue
            self.options[p.name] = v

    def _merged_pd(self, target, params):
        """Directive parameters over the scope's Attribute parameters for
        ``target`` (the directive wins)."""
        attrs = self.gs.attributes.get(target, [])
        return ParameterDictionary(list(attrs) + list(params), self.colorspace)

    def camera(self, name, params, loc):
        self.camera_spec = (name, self._pd(params), self.gs.ctm.copy())
        self.named_coords["camera"] = self.gs.ctm.copy()
        # The camera sits in the current outside medium.
        self.camera_medium_name = self.gs.medium_outside

    def film(self, name, params, loc):
        self.film_spec = (name, self._pd(params))

    def sampler(self, name, params, loc):
        self.sampler_spec = (name, self._pd(params))

    def pixel_filter(self, name, params, loc):
        self.filter_spec = (name, self._pd(params))

    def integrator(self, name, params, loc):
        self.integrator_spec = (name, self._pd(params))

    def accelerator(self, name, params, loc):
        """Recorded and ignored: the port always builds its BVH8, and the
        choice of acceleration structure does not change the image."""
        self.accelerator_spec = (name, self._pd(params))

    def world_begin(self, loc):
        self.gs.ctm = _Mat4.identity()
        self.named_coords["world"] = self.gs.ctm.copy()

    # --- attribute stack ---

    def attribute_begin(self, loc, transform_only=False):
        self.state_stack.append(dataclasses.replace(self.gs, ctm=self.gs.ctm.copy()))

    def attribute_end(self, loc, transform_only=False):
        self.gs = self.state_stack.pop()

    def attribute(self, target, params, loc):
        if target not in ("shape", "light", "material", "medium", "texture"):
            raise ValueError(f"{loc}: unknown attribute target {target!r}")
        # A fresh dict and lists: the pushed states share the old ones.
        attrs = {k: list(v) for k, v in self.gs.attributes.items()}
        attrs.setdefault(target, []).extend(params)
        self.gs.attributes = attrs

    def object_begin(self, name, loc):
        self.attribute_begin(loc)
        self.current_object = name
        self.objects[name] = []

    def object_end(self, loc):
        self.current_object = None
        self.attribute_end(loc)

    def object_instance(self, name, loc):
        """An instance of an object: its triangle meshes stay shared (the
        two-level BVH of ``shapes/instanced.py``); its other shapes are
        copied into the world with the instance's CTM, one copy each."""
        if name not in self.objects:
            raise ValueError(f"{loc}: unknown object {name!r}")
        self.instances.append((name, self.gs.ctm.copy()))
        flat = [rec for rec in self.objects[name] if rec["kind"] not in ("trianglemesh", "plymesh")]
        if flat and sum(1 for nm, _ in self.instances if nm == name) == 8:
            warnings.warn(f"{loc}: object {name!r} holds {len(flat)} non-triangle shape(s); "
                          "each ObjectInstance flattens its own copy (8 instances so far)")
        for rec in flat:
            self.shapes.append(dict(rec, ctm=self.gs.ctm @ rec["ctm_relative"]))

    def reverse_orientation(self, loc):
        self.gs.reverse_orientation = not self.gs.reverse_orientation

    # --- materials ---

    def material(self, name, params, loc):
        if name in MATERIAL_LESS:
            # Rays pass straight through; only a MediumInterface acts.
            self.gs.material = NO_MATERIAL
            return
        self.materials.append({"kind_name": name, "pd": self._merged_pd("material", params),
                               "loc": str(loc)})
        self.gs.material = len(self.materials) - 1

    def make_named_material(self, name, params, loc):
        pd = self._merged_pd("material", params)
        kind = pd.get_one_string("type", "diffuse")
        # A named material-less material becomes a black diffuse row, as in
        # the reference (only the Material directive makes a shape
        # material-less).
        self.materials.append({"kind_name": kind, "pd": pd, "loc": str(loc)})
        self.named_materials[name] = len(self.materials) - 1

    def named_material(self, name, loc):
        if name not in self.named_materials:
            raise ValueError(f"{loc}: unknown named material {name!r}")
        self.gs.material = self.named_materials[name]

    def texture(self, name, type_, class_, params, loc):
        pd = self._merged_pd("texture", params)
        self.texture_pds.append((f"{loc}: Texture {name!r}", pd))
        is_spectrum = type_ == "spectrum"
        if class_ == "constant":
            if is_spectrum:
                spec = pd.get_one_spectrum("value", None, SpectrumType.ALBEDO)
                coeffs = getattr(spec, "coeffs", None)
                if coeffs is None:
                    coeffs = fit_rgb_coeffs(np.array([[0.5, 0.5, 0.5]]), self.colorspace)[0]
                tid = self.tex_builder.add_constant_spectrum_coeffs(
                    coeffs, getattr(spec, "scale", 1.0))
            else:
                tid = self.tex_builder.add_constant_float(pd.get_one_float("value", 1.0))
        elif class_ in ("imagemap", "image"):
            img = Image.read(self._path(pd.get_one_string("filename", "")))
            data = img.data[..., :3] if is_spectrum else img.data[..., 0]
            filt = {"point": tx.FILTER_POINT, "bilinear": tx.FILTER_BILINEAR,
                    "trilinear": tx.FILTER_TRILINEAR, "ewa": tx.FILTER_EWA,
                    }.get(pd.get_one_string("filter", "trilinear"), tx.FILTER_TRILINEAR)
            wrap = {"repeat": tx.WRAP_REPEAT, "clamp": tx.WRAP_CLAMP, "black": tx.WRAP_BLACK,
                    }.get(pd.get_one_string("wrap", "repeat"), tx.WRAP_REPEAT)
            mapping = {"uv": tx.MAP_UV, "spherical": tx.MAP_SPHERICAL,
                       "cylindrical": tx.MAP_CYLINDRICAL, "planar": tx.MAP_PLANAR,
                       }.get(pd.get_one_string("mapping", "uv"), tx.MAP_UV)
            planar_vs = np.asarray([pd.get_one_vector3("v1", (1.0, 0.0, 0.0)),
                                    pd.get_one_vector3("v2", (0.0, 1.0, 0.0))], np.float32)
            tid = self.tex_builder.add_image(
                data,
                is_spectrum=is_spectrum,
                colorspace=self.colorspace,
                wrap=wrap,
                filter_kind=filt,
                scale=pd.get_one_float("scale", 1.0),
                invert=pd.get_one_bool("invert", False),
                mapping=mapping,
                uv_scale=(pd.get_one_float("uscale", 1.0), pd.get_one_float("vscale", 1.0)),
                uv_delta=(pd.get_one_float("udelta", 0.0), pd.get_one_float("vdelta", 0.0)),
                # The inverse of the CTM at the declaration, as the
                # reference takes it (it is applied to render-space points).
                world_to_tex=np.linalg.inv(self.gs.ctm),
                planar_vs=planar_vs,
            )
        elif class_ == "scale":
            base = self._resolve_texture_param(pd, "tex", is_spectrum, default=1.0)
            sc = self._resolve_texture_param(pd, "scale", False, default=1.0)
            tid = self.tex_builder.add_scaled(base, sc)
        elif class_ == "mix":
            t1 = self._resolve_texture_param(pd, "tex1", is_spectrum, default=0.0)
            t2 = self._resolve_texture_param(pd, "tex2", is_spectrum, default=1.0)
            amt_tn = pd.get_texture_name("amount")
            if amt_tn is not None and amt_tn in self.float_textures:
                tid = self.tex_builder.add_mix(t1, t2, amount_tex=self.float_textures[amt_tn])
            else:
                tid = self.tex_builder.add_mix(t1, t2, pd.get_one_float("amount", 0.5))
        elif class_ == "directionmix":
            t1 = self._resolve_texture_param(pd, "tex1", is_spectrum, default=0.0)
            t2 = self._resolve_texture_param(pd, "tex2", is_spectrum, default=1.0)
            tid = self.tex_builder.add_direction_mix(
                t1, t2, pd.get_one_vector3("dir", (0.0, 1.0, 0.0)))
        else:
            raise ValueError(f"{loc}: unknown texture class {class_!r}")
        (self.spectrum_textures if is_spectrum else self.float_textures)[name] = tid

    def _resolve_texture_param(self, pd, name, is_spectrum, default):
        """A texture operand: a named texture of the matching type, else a
        constant texture made from the parameter's value (or ``default``)."""
        tn = pd.get_texture_name(name)
        if tn is not None:
            pool = self.spectrum_textures if is_spectrum else self.float_textures
            if tn in pool:
                return pool[tn]
        if is_spectrum:
            spec = pd.get_one_spectrum(name, None, SpectrumType.ALBEDO)
            coeffs = getattr(spec, "coeffs", None)
            if coeffs is None:
                coeffs = fit_rgb_coeffs(np.array([[default] * 3]), self.colorspace)[0]
            return self.tex_builder.add_constant_spectrum_coeffs(coeffs)
        return self.tex_builder.add_constant_float(pd.get_one_float(name, default))

    # --- lights ---

    def light_source(self, name, params, loc):
        self.lights.append({"kind_name": name, "pd": self._merged_pd("light", params),
                            "ctm": self.gs.ctm.copy(), "loc": str(loc)})

    def area_light_source(self, name, params, loc):
        if name != "diffuse":
            raise _unported(f"{loc}: AreaLightSource {name!r}")
        self.gs.area_light = (name, self._merged_pd("light", params))

    # --- media ---

    def make_named_medium(self, name, params, loc):
        pd = self._merged_pd("medium", params)
        kind = pd.get_one_string("type", "homogeneous")
        if kind != "homogeneous":
            # The reference warns and treats it as homogeneous.
            raise _unported(f"{loc}: MakeNamedMedium {name!r} of type {kind!r}",
                            "homogeneous media only")
        self.medium_pds.append((f"{loc}: MakeNamedMedium {name!r}", pd))
        self.named_media[name] = {
            "sigma_a": pd.get_one_rgb("sigma_a", (1.0, 1.0, 1.0)),
            "sigma_s": pd.get_one_rgb("sigma_s", (1.0, 1.0, 1.0)),
            "scale": pd.get_one_float("scale", 1.0),
            "g": pd.get_one_float("g", 0.0),
        }

    def medium_interface(self, inside, outside, loc):
        """A name must be a medium made earlier; "" is vacuum."""
        for nm in (inside, outside):
            if nm and nm not in self.named_media:
                raise ParameterError(f"MediumInterface references undefined medium {nm!r}",
                                     loc=loc)
        self.gs.medium_inside = inside or None
        self.gs.medium_outside = outside or None

    # --- shapes ---

    def shape(self, name, params, loc):
        in_object = self.current_object is not None
        if in_object and self.gs.area_light is not None:
            raise _unported(f"{loc}: an area light inside object {self.current_object!r}",
                            "the reference's two-level BVH has none")
        (self.objects[self.current_object] if in_object else self.shapes).append({
            "kind": name,
            "pd": self._merged_pd("shape", params),
            "ctm": self.gs.ctm.copy(),
            # Inside an object: the CTM relative to the innermost pushed one.
            "ctm_relative": (np.linalg.inv(self.state_stack[-1].ctm) @ self.gs.ctm
                             if in_object else self.gs.ctm.copy()),
            "material": self.gs.material,
            "area_light": self.gs.area_light,
            "reverse_orientation": self.gs.reverse_orientation,
            "medium_inside": self.gs.medium_inside,
            "medium_outside": self.gs.medium_outside,
            "loc": str(loc),
        })

    def end_of_files(self):
        pass

    # --- creation passes ---

    def _path(self, name: str) -> Path:
        path = Path(name)
        if not path.is_absolute() and self.search_dir:
            path = Path(self.search_dir) / path
        return path

    def create(self, device=None, traverse=None) -> RenderJob:
        """Build the RenderJob with every table on ``device`` (default: the
        CUDA card); ``traverse`` is the triangle table's TraverseConfig
        (default ``TraverseConfig()``)."""
        from shimmer_tpu_torch.cameras import (
            CameraTransform,
            OrthographicCamera,
            PerspectiveCamera,
            SphericalCamera,
        )
        from shimmer_tpu_torch.config import resolve_device
        from shimmer_tpu_torch.film.film import PixelSensor, RgbFilm
        from shimmer_tpu_torch.film.filters import Filter
        from shimmer_tpu_torch.lights import lights as lt
        from shimmer_tpu_torch.samplers import create_sampler
        from shimmer_tpu_torch.scene_builder import build_scene
        from shimmer_tpu_torch.shapes.mesh import TriangleMesh, read_ply
        from shimmer_tpu_torch.shapes.triangle import build_triangle_scene

        device = resolve_device(device)
        used = []  # (what, ParameterDictionary): every parameter must be read

        # -- film, filter, sensor --
        fname, fpd = self.film_spec
        if fname != "rgb":
            raise _unported(f"Film {fname!r}")
        used.append(("Film", fpd))
        xres = fpd.get_one_int("xresolution", 1280)
        yres = fpd.get_one_int("yresolution", 720)
        filt_name, filt_pd = self.filter_spec
        used.append(("PixelFilter", filt_pd))
        # Every filter reads the parameters of all of them, as in the
        # reference.
        filt_params = {}
        for k in ("xradius", "yradius", "sigma", "B", "C", "tau"):
            v = filt_pd.get_one_float(k, None)
            if v is not None:
                filt_params[k] = v
        filt = Filter.create(filt_name, **filt_params)
        sensor = PixelSensor.create(
            self.colorspace, exposure_time=1.0, iso=fpd.get_one_float("iso", 100.0),
            white_balance_temp=fpd.get_one_float("whitebalance", 0.0),
            sensor_name=fpd.get_one_string("sensor", "cie1931"),
        )
        film = RgbFilm((xres, yres), filt, sensor, self.colorspace,
                       max_component_value=fpd.get_one_float("maxcomponentvalue", float("inf")))
        filename = fpd.get_one_string("filename", "shimmer.pfm")

        # -- camera --
        cname, cpd, cam_ctm = self.camera_spec
        used.append(("Camera", cpd))
        ct = CameraTransform(Transform.from_matrix(np.linalg.inv(cam_ctm)),
                             rendering_space=str(self.options.get("rendercoordsys",
                                                                  "cameraworld")))
        common = dict(
            camera_transform=ct,
            resolution=(xres, yres),
            shutter_open=cpd.get_one_float("shutteropen", 0.0),
            shutter_close=cpd.get_one_float("shutterclose", 1.0),
        )
        sw = cpd.get_float_array("screenwindow")
        screen_window = ((sw[0], sw[2]), (sw[1], sw[3])) if len(sw) == 4 else None
        if cname == "perspective":
            camera = PerspectiveCamera(
                fov=cpd.get_one_float("fov", 90.0), screen_window=screen_window,
                lens_radius=cpd.get_one_float("lensradius", 0.0),
                focal_distance=cpd.get_one_float("focaldistance", 1e6), **common)
        elif cname == "orthographic":
            camera = OrthographicCamera(
                screen_window=screen_window, lens_radius=cpd.get_one_float("lensradius", 0.0),
                focal_distance=cpd.get_one_float("focaldistance", 1e6), **common)
        elif cname == "spherical":
            camera = SphericalCamera(mapping=cpd.get_one_string("mapping", "equalarea"), **common)
        else:
            raise ValueError(f"unknown camera {cname!r}")
        r2w = ct.render_from_world()
        r2w_np = np.asarray(r2w.m, np.float64)

        # -- materials --
        spectra_rows: list[np.ndarray] = []

        def add_spectrum_row(spec) -> int:
            spectra_rows.append(spec.to_dense())
            return len(spectra_rows) - 1

        force_diffuse = bool(self.options.get("forcediffuse", False))
        mat_dicts = []
        for m in self.materials:
            kind_name = m["kind_name"]
            if force_diffuse:
                # Every material becomes a diffuse one with its reflectance;
                # the parameters of its own kind are set aside on purpose.
                kind_name = "diffuse"
                for p in m["pd"].params.values():
                    p.looked_up = True
            mat_dicts.append(self._convert_material(kind_name, m["pd"], add_spectrum_row,
                                                    m.get("loc", "default material")))
            used.append((f"{m.get('loc', 'default')}: Material {m['kind_name']!r}", m["pd"]))

        # -- shapes and their area lights --
        media_order = sorted(self.named_media)

        def media_id(name):
            return media_order.index(name) if name in media_order else -1

        sphere_dicts, mesh_dicts, patch_dicts, light_dicts = [], [], [], []
        tri_count = 0
        for rec in self.shapes:
            pd, kind, loc = rec["pd"], rec["kind"], rec["loc"]
            used.append((f"{loc}: Shape {kind!r}", pd))
            o2r = r2w_np @ rec["ctm"]
            mat = rec["material"]
            mat_idx = -1 if mat == NO_MATERIAL else max(mat, 0)
            if rec["area_light"] is not None:
                used.append((f"{loc}: AreaLightSource", rec["area_light"][1]))
            if kind == "sphere":
                area_light_id = -1
                if rec["area_light"] is not None:
                    area_light_id = len(light_dicts)
                    light_dicts.append(self._area_light_dict(rec["area_light"], lt.SPHERE_SHAPE,
                                                             len(sphere_dicts)))
                radius = pd.get_one_float("radius", 1.0)
                sphere_dicts.append({
                    "radius": radius,
                    "z_min": pd.get_one_float("zmin", -radius),
                    "z_max": pd.get_one_float("zmax", radius),
                    "phi_max": pd.get_one_float("phimax", 360.0),
                    "object_to_render": Transform.from_matrix(o2r),
                    "reverse_orientation": rec["reverse_orientation"],
                    "material_id": mat_idx,
                    "area_light_id": area_light_id,
                })
            elif kind in ("trianglemesh", "plymesh"):
                if kind == "plymesh":
                    data = read_ply(self._path(pd.get_one_string("filename", "")))
                    p, idx, nrm, uv = data["p"], data["indices"], data["n"], data["uv"]
                else:
                    p = pd.get_point3_array("P")
                    idx = pd.get_int_array("indices").reshape(-1, 3)
                    nrm = pd.get_point3_array("N")
                    uv = pd.get_point2_array("uv")
                    if uv is None:
                        uv = pd.get_point2_array("st")
                mesh = TriangleMesh(Transform.from_matrix(o2r), idx, p, n=nrm, uv=uv,
                                    reverse_orientation=rec["reverse_orientation"])
                n_tris = mesh.n_triangles
                ali = -1
                if rec["area_light"] is not None:
                    # One light per triangle.
                    ali = np.arange(len(light_dicts), len(light_dicts) + n_tris, dtype=np.int32)
                    for k in range(n_tris):
                        light_dicts.append(self._area_light_dict(
                            rec["area_light"], lt.TRIANGLE_SHAPE, tri_count + k))
                md = mesh.as_scene_dict(mat_idx, ali)
                if rec["medium_inside"] is not None or rec["medium_outside"] is not None:
                    # Media-table ids in the sorted order of the names (-1:
                    # vacuum); a mesh without an interface stays -2.
                    md["medium_inside"] = media_id(rec["medium_inside"])
                    md["medium_outside"] = media_id(rec["medium_outside"])
                mesh_dicts.append(md)
                tri_count += n_tris
            elif kind == "bilinearmesh":
                # One patch per four indices, in pbrt-v4's corner order
                # p00 p10 p01 p11, and one area light per patch.  Without
                # indices the vertices are taken in order (the reference
                # means to, but its test for a missing array never fires:
                # its getter returns an empty one, so it loads no patch).
                p = pd.get_point3_array("P")
                q = pd.get_int_array("indices")
                if q.size == 0:
                    q = np.arange(len(p), dtype=np.int32)
                q = q.reshape(-1, 4)
                uvp = pd.get_point2_array("uv")
                if uvp is None:
                    uvp = pd.get_point2_array("st")
                for pi in range(q.shape[0]):
                    area_light_id = -1
                    if rec["area_light"] is not None:
                        area_light_id = len(light_dicts)
                        light_dicts.append(self._area_light_dict(rec["area_light"],
                                                                 lt.PATCH_SHAPE, len(patch_dicts)))
                    patch_dicts.append({
                        "p00": p[q[pi, 0]],
                        "p10": p[q[pi, 1]],
                        "p01": p[q[pi, 2]],
                        "p11": p[q[pi, 3]],
                        "uv": uvp[q[pi]] if uvp is not None else None,
                        "object_to_world": Transform.from_matrix(rec["ctm"]),
                        "reverse": rec["reverse_orientation"],
                        "material_id": mat_idx,
                        "area_light_id": area_light_id,
                    })
            else:
                raise _unported(f"{loc}: Shape {kind!r}")

        # -- the other lights --
        env_spec = None
        for ld in self.lights:
            pd, kindn, loc, l2w = ld["pd"], ld["kind_name"], ld["loc"], ld["ctm"]
            if kindn in ("point", "spot", "distant"):
                used.append((f"{loc}: LightSource {kindn!r}", pd))
                light_dicts.append(self._delta_light_dict(kindn, pd, l2w))
                continue
            if kindn != "infinite":
                raise _unported(f"{loc}: LightSource {kindn!r}")
            used.append((f"{loc}: LightSource 'infinite'", pd))
            fname = pd.get_one_string("filename", "")
            if fname:
                # Baked in build_scene, with the scene's radius.
                env_spec = {
                    "image": Image.read(self._path(fname)).data[..., :3],
                    "scale": pd.get_one_float("scale", 1.0),
                    "render_from_light": Transform.from_matrix(r2w_np @ ld["ctm"]),
                }
                light_dicts.append({"kind": lt.IMAGE_INFINITE,
                                    "spectrum": self.colorspace.illuminant, "scale": 1.0})
                continue
            light_dicts.append({
                "kind": lt.UNIFORM_INFINITE,
                "spectrum": pd.get_one_spectrum("L", self.colorspace.illuminant,
                                                SpectrumType.ILLUMINANT),
                "scale": pd.get_one_float("scale", 1.0),
                "photometric": True,
            })

        # -- sampler and integrator --
        sname, spd = self.sampler_spec
        used.append(("Sampler", spd))
        spp = spd.get_one_int("pixelsamples", 16)
        sampler = create_sampler(sname, spp, (xres, yres),
                                 spd.get_one_int("seed", int(self.options.get("seed", 0))))
        iname, ipd = self.integrator_spec
        if iname not in _INTEGRATORS:
            raise _unported(f"Integrator {iname!r}", "only path, volpath, simplepath and randomwalk")
        used.append(("Integrator", ipd))
        max_depth = ipd.get_one_int("maxdepth", 5)
        light_sampler = ipd.get_one_string("lightsampler", "uniform")
        if light_sampler == "bvh":
            light_sampler = "power"
        if light_sampler not in ("uniform", "power"):
            raise _unported(f"Integrator parameter lightsampler {light_sampler!r}")

        instanced = self._build_instanced(r2w_np, used, device)
        for what, pd in used + self.texture_pds + self.medium_pds:
            unused = pd.report_unused()
            if unused:
                raise _unported(f"{what}: parameters {unused}", "nothing reads them")

        tris = (build_triangle_scene(mesh_dicts, device=device, traverse=traverse)
                if mesh_dicts else None)
        scene = build_scene(
            tris,
            materials=mat_dicts,
            lights=light_dicts,
            colorspace=self.colorspace,
            light_sampler=light_sampler,
            spectra_table=np.stack(spectra_rows) if spectra_rows else None,
            device=device,
            spheres=sphere_dicts,
            render_from_world=r2w,
            textures=self.tex_builder.build(device) if self.tex_builder.rows else None,
            env_spec=env_spec,
            media=[self.named_media[k] for k in media_order] or None,
            camera_medium=media_id(self.camera_medium_name),
            patches=patch_dicts or None,
            instanced=instanced,
        )
        return RenderJob(scene=scene, camera=camera, film=film, sampler=sampler,
                         integrator=_INTEGRATORS[iname], max_depth=max_depth, spp=spp,
                         filename=filename, light_sampler=light_sampler,
                         disable_pixel_jitter=bool(self.options.get("disablepixeljitter", False)),
                         disable_wavelength_jitter=bool(
                             self.options.get("disablewavelengthjitter", False)))

    def _build_instanced(self, r2w_np, used, device):
        """The two-level BVH over the instanced objects' triangle meshes:
        objects in the order of their first instance, meshes in object
        space (material "none" or the default reads as material 0 and no
        MediumInterface applies, as in the reference), instances at
        render-from-world times their CTM.  An object without a triangle
        mesh has no entry (its other shapes are copied per instance)."""
        from shimmer_tpu_torch.shapes.instanced import build_instanced
        from shimmer_tpu_torch.shapes.mesh import TriangleMesh, read_ply

        obj_id, obj_meshes = {}, []
        for name, _ in self.instances:
            if name in obj_id:
                continue
            meshes = []
            for rec in self.objects[name]:
                if rec["kind"] not in ("trianglemesh", "plymesh"):
                    continue
                pd = rec["pd"]
                used.append((f"{rec['loc']}: Shape {rec['kind']!r} in object {name!r}", pd))
                if rec["kind"] == "plymesh":
                    data = read_ply(self._path(pd.get_one_string("filename", "")))
                    p, idx, nrm, uv = data["p"], data["indices"], data["n"], data["uv"]
                else:
                    p = pd.get_point3_array("P")
                    idx = pd.get_int_array("indices").reshape(-1, 3)
                    nrm = pd.get_point3_array("N")
                    uv = pd.get_point2_array("uv")
                    if uv is None:
                        uv = pd.get_point2_array("st")
                mat = rec["material"]
                mesh = TriangleMesh(Transform.from_matrix(rec["ctm_relative"]), idx, p, n=nrm,
                                    uv=uv, reverse_orientation=rec["reverse_orientation"])
                meshes.append(mesh.as_scene_dict(mat if isinstance(mat, int) and mat >= 0 else 0))
            obj_id[name] = len(obj_meshes) if meshes else -1
            if meshes:
                obj_meshes.append(meshes)
        pairs = [(obj_id[name], r2w_np @ ctm) for name, ctm in self.instances if obj_id[name] >= 0]
        return build_instanced(obj_meshes, pairs, device=device) if pairs else None

    def _delta_light_dict(self, kindn, pd, l2w):
        """A point, spot or distant light: ``from`` / ``to`` through the
        light's CTM in float64, its spectrum photometrically scaled."""
        from shimmer_tpu_torch.lights import lights as lt

        frm = pd.get_one_point3("from", (0, 0, 0))
        key = "L" if kindn == "distant" else "I"
        out = {
            "kind": {"point": lt.POINT, "spot": lt.SPOT, "distant": lt.DISTANT}[kindn],
            "spectrum": pd.get_one_spectrum(key, self.colorspace.illuminant,
                                            SpectrumType.ILLUMINANT),
            "scale": pd.get_one_float("scale", 1.0),
            "photometric": True,
        }
        if kindn != "distant":
            out["position"] = (l2w @ np.append(frm, 1.0))[:3]
        if kindn != "point":
            to = pd.get_one_point3("to", (0, 0, 1))
            out["direction"] = (l2w @ np.append(to - frm, 0.0))[:3]
        if kindn == "spot":
            out["cone_angle"] = pd.get_one_float("coneangle", 30.0)
            out["cone_delta"] = pd.get_one_float("conedeltaangle", 5.0)
        return out

    def _area_light_dict(self, area_light, shape_kind, shape_idx):
        from shimmer_tpu_torch.lights import lights as lt

        _, al_pd = area_light
        if al_pd.get_one_string("filename", ""):
            raise _unported("an image area light", "the reference does not read its image")
        return {
            "kind": lt.AREA,
            "spectrum": al_pd.get_one_spectrum("L", self.colorspace.illuminant,
                                               SpectrumType.ILLUMINANT),
            "scale": al_pd.get_one_float("scale", 1.0),
            "photometric": True,
            "shape_kind": shape_kind,
            "shape_idx": shape_idx,
            "two_sided": al_pd.get_one_bool("twosided", False),
        }

    def _convert_material(self, kind_name, pd, add_spectrum_row, loc):
        from shimmer_tpu_torch.materials import material as mtl
        from shimmer_tpu_torch.spectra.rgb2spec import _projection_matrix

        out = {}
        remap = pd.get_one_bool("remaproughness", True)
        r = pd.get_one_float("roughness", 0.0)
        u_r = pd.get_one_float("uroughness", r)
        v_r = pd.get_one_float("vroughness", r)
        if not remap:
            u_r, v_r = u_r * u_r, v_r * v_r
        out["uroughness"] = u_r
        out["vroughness"] = v_r
        # Roughness and displacement textures (read for every kind, as the
        # reference does).
        for key, cols in (("roughness", ("tex_uroughness", "tex_vroughness")),
                          ("uroughness", ("tex_uroughness",)),
                          ("vroughness", ("tex_vroughness",))):
            tn = pd.get_texture_name(key)
            if tn is not None and tn in self.float_textures:
                for c in cols:
                    out[c] = self.float_textures[tn]
        tn = pd.get_texture_name("displacement")
        if tn is not None and tn in self.float_textures:
            out["displacement_tex"] = self.float_textures[tn]

        def reflectance(param="reflectance", default=0.5):
            tn = pd.get_texture_name(param)
            if tn is not None and tn in self.spectrum_textures:
                out["tex_reflectance"] = self.spectrum_textures[tn]
                out["reflectance_coeffs"] = fit_rgb_coeffs(
                    np.array([[default] * 3]), self.colorspace)[0]
                return
            spec = pd.get_one_spectrum(param, None, SpectrumType.ALBEDO)
            if spec is not None and hasattr(spec, "coeffs"):
                out["reflectance_coeffs"] = np.asarray(spec.coeffs)
            elif spec is not None:
                # A non-rgb spectrum: project to rgb, then fit.
                rgb = _projection_matrix(self.colorspace) @ spec.get(np.arange(360.0, 831.0))
                out["reflectance_coeffs"] = fit_rgb_coeffs(
                    np.clip(rgb, 0, 1)[None], self.colorspace)[0]
            else:
                out["reflectance_coeffs"] = fit_rgb_coeffs(
                    np.array([[default] * 3]), self.colorspace)[0]

        def layer_params():
            out["thickness"] = pd.get_one_float("thickness", 0.01)
            out["g"] = pd.get_one_float("g", 0.0)
            alb = pd.get_one_spectrum("albedo", None, SpectrumType.ALBEDO)
            if alb is not None and hasattr(alb, "coeffs"):
                out["albedo_coeffs"] = np.asarray(alb.coeffs)
            out["eta_float"] = pd.get_one_float("interface.eta", pd.get_one_float("eta", 1.5))

        def metal(eta_key, k_key):
            eta = pd.get_one_spectrum(eta_key, None, SpectrumType.UNBOUNDED)
            k = pd.get_one_spectrum(k_key, None, SpectrumType.UNBOUNDED)
            if pd.get_one_spectrum("reflectance", None, SpectrumType.ALBEDO) is not None:
                reflectance()
                return
            if eta is None:
                eta = named_spectrum("metal-Cu-eta")
                k = named_spectrum("metal-Cu-k")
            out["eta_spec"] = add_spectrum_row(eta)
            out["k_spec"] = add_spectrum_row(k)
            out["reflectance_coeffs"] = np.zeros(3, np.float32)

        if kind_name == "diffuse":
            out["kind"] = mtl.DIFFUSE
            reflectance()
        elif kind_name == "coateddiffuse":
            out["kind"] = mtl.COATED_DIFFUSE
            reflectance()
            layer_params()
        elif kind_name == "coatedconductor":
            out["kind"] = mtl.COATED_CONDUCTOR
            layer_params()
            # The interface's roughness on top, the conductor's below.
            ir = pd.get_one_float("interface.roughness", 0.0)
            out["uroughness"] = pd.get_one_float("interface.uroughness", ir)
            out["vroughness"] = pd.get_one_float("interface.vroughness", ir)
            cr = pd.get_one_float("conductor.roughness", 0.0)
            out["bot_uroughness"] = pd.get_one_float("conductor.uroughness", cr)
            out["bot_vroughness"] = pd.get_one_float("conductor.vroughness", cr)
            metal("conductor.eta", "conductor.k")
        elif kind_name == "conductor":
            out["kind"] = mtl.CONDUCTOR
            metal("eta", "k")
        elif kind_name in ("dielectric", "thindielectric"):
            out["kind"] = mtl.DIELECTRIC if kind_name == "dielectric" else mtl.THIN_DIELECTRIC
            eta_f = pd.get_one_float("eta", 1.5)
            eta_spec = pd.get_one_spectrum("eta", None, SpectrumType.UNBOUNDED)
            if eta_spec is not None:
                if isinstance(eta_spec, ConstantSpectrum):
                    eta_f = eta_spec.c
                else:
                    out["eta_spec"] = add_spectrum_row(eta_spec)
            out["eta_float"] = eta_f
            out["reflectance_coeffs"] = np.zeros(3, np.float32)
        elif kind_name == "mix":
            out["kind"] = mtl.MIX
            amt_tn = pd.get_texture_name("amount")
            if amt_tn is not None and amt_tn in self.float_textures:
                out["tex_mix_amount"] = self.float_textures[amt_tn]
            else:
                out["mix_amount"] = pd.get_one_float("amount", 0.5)
            out["reflectance_coeffs"] = np.zeros(3, np.float32)
            names = pd.params.get("materials")
            if names is not None:
                names.looked_up = True
                for key, name in zip(("mix_m1", "mix_m2"), names.values[:2]):
                    if name not in self.named_materials:
                        raise ParameterError(f"mix of unknown material {name!r}", loc=loc)
                    out[key] = self.named_materials[name]
        elif kind_name in MATERIAL_LESS:
            out["kind"] = mtl.DIFFUSE
            out["reflectance_coeffs"] = np.zeros(3, np.float32)
        else:
            raise _unported(f"{loc}: material {kind_name!r}")
        return out
