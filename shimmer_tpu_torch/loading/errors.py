"""Typed scene-loading errors (port of ``shimmer_tpu/loading/errors.py``,
unchanged): an exception hierarchy so callers can tell tokenizer,
directive and parameter failures apart.

All carry ``loc`` (a FileLoc or its string form) when known.
"""

from __future__ import annotations


class SceneLoadError(Exception):
    """Base class for every scene-loading failure."""

    def __init__(self, message: str, loc=None):
        self.loc = loc
        super().__init__(f"{loc}: {message}" if loc is not None else message)


class TokenError(SceneLoadError):
    """Lexical failure (unterminated string, bad escape)."""


class DirectiveError(SceneLoadError):
    """Unknown or malformed scene directive."""


class ParameterError(SceneLoadError):
    """Bad parameter declaration, type mismatch, unknown spectrum."""
