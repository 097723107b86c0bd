"""Typed parameter lists and dictionaries (port of
``shimmer_tpu/loading/paramdict.py``): ``"float roughness" [0.1]`` style
declarations become typed Params; the ParameterDictionary gives typed
lookups with defaults and resolves spectrum parameters by SpectrumType
(albedo / unbounded / illuminant) to the port's host spectrum classes.
"""

from __future__ import annotations

import enum

import numpy as np

from shimmer_tpu_torch.loading.errors import ParameterError
from shimmer_tpu_torch.spectra.rgb2spec import (
    RgbAlbedoSpectrum,
    RgbIlluminantSpectrum,
    RgbUnboundedSpectrum,
)
from shimmer_tpu_torch.spectra.spectrum import (
    BlackbodySpectrum,
    ConstantSpectrum,
    PiecewiseLinearSpectrum,
    Spectrum,
    named_spectrum,
)


class SpectrumType(enum.Enum):
    ALBEDO = "albedo"
    UNBOUNDED = "unbounded"
    ILLUMINANT = "illuminant"


PARAM_TYPES = {
    "float", "integer", "bool", "string", "point2", "point3", "vector2",
    "vector3", "normal", "normal3", "rgb", "color", "blackbody", "spectrum",
    "texture", "point", "vector",
}


class Param:
    def __init__(self, type_: str, name: str, values, loc=None):
        self.type = type_
        self.name = name
        self.values = values
        self.loc = loc
        self.looked_up = False


def parse_param_declaration(decl: str):
    """'float roughness' -> ('float', 'roughness')."""
    parts = decl.strip().split()
    if len(parts) != 2 or parts[0] not in PARAM_TYPES:
        raise ParameterError(f"bad parameter declaration: {decl!r}")
    return parts[0], parts[1]


class ParameterDictionary:
    """Typed lookups with defaults."""

    def __init__(self, params: list[Param], colorspace=None):
        self.params = {p.name: p for p in params}
        self.colorspace = colorspace

    def _get(self, name, types):
        p = self.params.get(name)
        if p is not None and p.type in types:
            p.looked_up = True
            return p
        return None

    def get_one_float(self, name, default):
        p = self._get(name, ("float", "integer"))
        return float(p.values[0]) if p else default

    def get_one_int(self, name, default):
        p = self._get(name, ("integer", "float"))
        return int(p.values[0]) if p else default

    def get_one_bool(self, name, default):
        p = self._get(name, ("bool",))
        if not p:
            return default
        v = p.values[0]
        return v in (True, "true")

    def get_one_string(self, name, default):
        p = self._get(name, ("string", "texture"))
        return str(p.values[0]) if p else default

    def get_one_point3(self, name, default):
        p = self._get(name, ("point3", "point"))
        return (
            np.asarray(p.values[:3], np.float32)
            if p
            else np.asarray(default, np.float32)
        )

    def get_one_vector3(self, name, default):
        p = self._get(name, ("vector3", "vector", "normal", "normal3"))
        return (
            np.asarray(p.values[:3], np.float32)
            if p
            else np.asarray(default, np.float32)
        )

    def get_one_rgb(self, name, default):
        p = self._get(name, ("rgb", "color"))
        return (
            np.asarray(p.values[:3], np.float32)
            if p
            else (None if default is None else np.asarray(default, np.float32))
        )

    def get_float_array(self, name):
        p = self._get(name, ("float", "integer"))
        return np.asarray(p.values, np.float32) if p else np.zeros(0, np.float32)

    def get_int_array(self, name):
        p = self._get(name, ("integer",))
        return np.asarray(p.values, np.int64) if p else np.zeros(0, np.int64)

    def get_point3_array(self, name):
        p = self._get(name, ("point3", "point", "normal", "normal3", "vector3", "vector"))
        if not p:
            return None
        a = np.asarray(p.values, np.float32)
        return a.reshape(-1, 3)

    def get_point2_array(self, name):
        p = self._get(name, ("point2", "float"))
        if not p:
            return None
        return np.asarray(p.values, np.float32).reshape(-1, 2)

    def get_texture_name(self, name):
        p = self._get(name, ("texture",))
        return str(p.values[0]) if p else None

    def get_one_spectrum(
        self, name, default, spectrum_type: SpectrumType, named_spectra=None
    ) -> Spectrum | None:
        """Spectrum resolution: rgb -> sigmoid spectra per type,
        blackbody -> normalized Planck, spectrum name / inline samples ->
        piecewise linear."""
        p = self.params.get(name)
        if p is None:
            return default
        p.looked_up = True
        cs = self.colorspace
        if p.type in ("rgb", "color"):
            rgb = np.asarray(p.values[:3], np.float64)
            if spectrum_type == SpectrumType.ALBEDO:
                return RgbAlbedoSpectrum(cs, rgb)
            if spectrum_type == SpectrumType.UNBOUNDED:
                return RgbUnboundedSpectrum(cs, rgb)
            return RgbIlluminantSpectrum(cs, rgb)
        if p.type == "blackbody":
            return BlackbodySpectrum(float(p.values[0]))
        if p.type in ("float", "integer"):
            return ConstantSpectrum(float(p.values[0]))
        if p.type == "spectrum":
            if isinstance(p.values[0], str):
                s = (named_spectra or {}).get(p.values[0]) or named_spectrum(
                    p.values[0]
                )
                if s is None:
                    raise ParameterError(f"unknown spectrum: {p.values[0]}", loc=p.loc)
                return s
            vals = np.asarray(p.values, np.float64)
            return PiecewiseLinearSpectrum(vals[0::2], vals[1::2])
        raise ParameterError(
            f"parameter {name} is not a spectrum (type {p.type})", loc=p.loc
        )

    def report_unused(self):
        return [p.name for p in self.params.values() if not p.looked_up]
