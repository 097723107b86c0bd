"""pbrt-v4 scene description parser (port of
``shimmer_tpu/loading/parser.py``).

``parse_str`` / ``parse_file`` drive the directive loop into a target, the
``SceneBuilder`` of ``loading/scene_builder.py``, whose ``create()`` runs
the creation passes.  ``Include`` and ``Import`` read files relative to
the including file's directory.  Animated transforms are not ported:
``ActiveTransform`` other than ``All`` and ``TransformTimes`` other than
``0 1`` raise NotImplementedError.
"""

from __future__ import annotations

from pathlib import Path

from shimmer_tpu_torch.loading.errors import DirectiveError, ParameterError
from shimmer_tpu_torch.loading.paramdict import PARAM_TYPES, Param
from shimmer_tpu_torch.loading.tokenizer import TokenStream

ALL_DIRECTIVES = {
    "AttributeBegin", "AttributeEnd", "Attribute", "ActiveTransform",
    "AreaLightSource", "Accelerator", "ConcatTransform", "CoordinateSystem",
    "CoordSysTransform", "ColorSpace", "Camera", "Film", "Identity",
    "Include", "Import", "LightSource", "LookAt", "MakeNamedMaterial",
    "MakeNamedMedium", "Material", "MediumInterface", "NamedMaterial",
    "ObjectBegin", "ObjectEnd", "ObjectInstance", "Option", "PixelFilter",
    "ReverseOrientation", "Rotate", "Sampler", "Scale", "Shape",
    "Integrator", "Texture", "TransformBegin", "TransformEnd",
    "TransformTimes", "Transform", "Translate", "WorldBegin", "WorldEnd",
}


def _unquote(tok: str) -> str:
    return tok[1:-1] if tok.startswith('"') else tok


def _parse_number(tok: str):
    try:
        return int(tok)
    except ValueError:
        return float(tok)


class Parser:
    """Directive pull-parser."""

    def __init__(self, stream: TokenStream, target):
        self.s = stream
        self.t = target

    def _numbers(self, n: int):
        out = []
        bracketed = False
        if self.s.peek() and self.s.peek()[0] == "[":
            self.s.next()
            bracketed = True
        while len(out) < n:
            tok, loc = self.s.next()
            out.append(float(tok))
        if bracketed:
            tok, _ = self.s.next()
            assert tok == "]", f"expected ], got {tok}"
        return out

    def _string(self):
        tok, loc = self.s.next()
        if tok == "[":
            tok, loc = self.s.next()
            close, _ = self.s.next()
            assert close == "]"
        return _unquote(tok), loc

    def _params(self) -> list[Param]:
        """Parse '"type name" [values...]' pairs until the next directive."""
        params = []
        while True:
            nxt = self.s.peek()
            if nxt is None:
                break
            tok, loc = nxt
            if not tok.startswith('"'):
                break
            decl = _unquote(tok)
            parts = decl.split()
            if len(parts) != 2:
                break  # not a parameter: e.g. the quoted name of a directive
            if parts[0] not in PARAM_TYPES:
                raise ParameterError(
                    f"unknown parameter type in declaration {decl!r}", loc=loc
                )
            self.s.next()
            type_, name = parts
            values = []
            nxt = self.s.peek()
            if nxt and nxt[0] == "[":
                self.s.next()
                while True:
                    tok2, _ = self.s.next()
                    if tok2 == "]":
                        break
                    values.append(self._value(tok2, type_))
            else:
                tok2, _ = self.s.next()
                values.append(self._value(tok2, type_))
            params.append(Param(type_, name, values, loc))
        return params

    @staticmethod
    def _value(tok: str, type_: str):
        if tok.startswith('"'):
            s = _unquote(tok)
            if type_ == "bool":
                return s == "true"
            return s
        if tok in ("true", "false"):
            return tok == "true"
        return _parse_number(tok)

    def parse(self):
        t = self.t
        while True:
            nxt = self.s.next()
            if nxt is None:
                break
            tok, loc = nxt
            if tok == "Include":
                name, _ = self._string()
                self.s.push_file(name)
            elif tok == "Import":
                name, _ = self._string()
                self.s.push_file(name)
            elif tok == "LookAt":
                v = self._numbers(9)
                t.look_at(v[0:3], v[3:6], v[6:9], loc)
            elif tok == "Translate":
                t.translate(self._numbers(3), loc)
            elif tok == "Scale":
                t.scale(self._numbers(3), loc)
            elif tok == "Rotate":
                v = self._numbers(4)
                t.rotate(v[0], v[1:4], loc)
            elif tok == "Transform":
                t.transform(self._numbers(16), loc)
            elif tok == "ConcatTransform":
                t.concat_transform(self._numbers(16), loc)
            elif tok == "Identity":
                t.identity(loc)
            elif tok == "CoordinateSystem":
                name, _ = self._string()
                t.coordinate_system(name, loc)
            elif tok == "CoordSysTransform":
                name, _ = self._string()
                t.coord_sys_transform(name, loc)
            elif tok == "ActiveTransform":
                which, _ = self._string()
                if which != "All":
                    raise NotImplementedError(
                        f"{loc}: ActiveTransform {which} (animated transforms) is not ported")
            elif tok == "TransformTimes":
                times = self._numbers(2)
                if times != [0.0, 1.0]:
                    raise NotImplementedError(
                        f"{loc}: TransformTimes {times} (animated transforms) is not ported")
            elif tok == "TransformBegin":
                t.attribute_begin(loc, transform_only=True)
            elif tok == "TransformEnd":
                t.attribute_end(loc, transform_only=True)
            elif tok == "ColorSpace":
                name, _ = self._string()
                t.color_space(name, loc)
            elif tok == "Option":
                params = self._params()
                t.option(params, loc)
            elif tok in (
                "Camera", "Film", "Sampler", "Integrator", "PixelFilter",
                "Accelerator",
            ):
                name, nloc = self._string()
                params = self._params()
                getattr(t, tok.lower().replace("pixelfilter", "pixel_filter"))(
                    name, params, nloc
                )
            elif tok == "WorldBegin":
                t.world_begin(loc)
            elif tok == "WorldEnd":
                pass  # pbrt-v3's end of the world block; v4 ends at end of file
            elif tok == "AttributeBegin":
                t.attribute_begin(loc)
            elif tok == "AttributeEnd":
                t.attribute_end(loc)
            elif tok == "Attribute":
                target_name, _ = self._string()
                params = self._params()
                t.attribute(target_name, params, loc)
            elif tok == "Shape":
                name, nloc = self._string()
                t.shape(name, self._params(), nloc)
            elif tok == "ObjectBegin":
                name, _ = self._string()
                t.object_begin(name, loc)
            elif tok == "ObjectEnd":
                t.object_end(loc)
            elif tok == "ObjectInstance":
                name, _ = self._string()
                t.object_instance(name, loc)
            elif tok == "LightSource":
                name, nloc = self._string()
                t.light_source(name, self._params(), nloc)
            elif tok == "AreaLightSource":
                name, nloc = self._string()
                t.area_light_source(name, self._params(), nloc)
            elif tok == "Material":
                name, nloc = self._string()
                t.material(name, self._params(), nloc)
            elif tok == "MakeNamedMaterial":
                name, nloc = self._string()
                t.make_named_material(name, self._params(), nloc)
            elif tok == "NamedMaterial":
                name, nloc = self._string()
                t.named_material(name, nloc)
            elif tok == "Texture":
                name, _ = self._string()
                type_, _ = self._string()
                class_, nloc = self._string()
                t.texture(name, type_, class_, self._params(), nloc)
            elif tok == "MakeNamedMedium":
                name, nloc = self._string()
                t.make_named_medium(name, self._params(), nloc)
            elif tok == "MediumInterface":
                inside, _ = self._string()
                nxt2 = self.s.peek()
                outside = ""
                if nxt2 and nxt2[0].startswith('"') and _unquote(nxt2[0]) not in ALL_DIRECTIVES:
                    # second quoted string that is not a parameter decl
                    parts = _unquote(nxt2[0]).split()
                    if len(parts) != 2 or parts[0] not in PARAM_TYPES:
                        outside, _ = self._string()
                t.medium_interface(inside, outside, loc)
            elif tok == "ReverseOrientation":
                t.reverse_orientation(loc)
            else:
                raise DirectiveError(f"unknown directive {tok!r}", loc=loc)
        t.end_of_files()


def parse_str(text: str, target, filename="<string>", search_dir=None):
    Parser(TokenStream(text, filename, search_dir), target).parse()
    return target


def parse_file(path, target):
    p = Path(path)
    return parse_str(p.read_text(), target, str(p), search_dir=p.parent)
