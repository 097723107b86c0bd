"""pbrt-v4 scene file tokenizer (port of
``shimmer_tpu/loading/tokenizer.py``, unchanged): comments, quoted
strings and brackets become (token, FileLoc) pairs that the parser pulls
as a stream, with an include stack.
"""

from __future__ import annotations

from shimmer_tpu_torch.loading.errors import TokenError


class FileLoc:
    """Source location for diagnostics."""

    def __init__(self, filename: str, line: int):
        self.filename = filename
        self.line = line

    def __str__(self):
        return f"{self.filename}:{self.line}"

    def __repr__(self):
        return str(self)


def tokenize(text: str, filename: str = "<string>"):
    """Yield (token, FileLoc) pairs.

    Tokens: directives/identifiers, quoted strings (quotes preserved),
    '[' and ']', numbers as raw text.  '#' starts a comment to EOL.
    """
    i = 0
    n = len(text)
    line = 1
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
        elif c in " \t\r":
            i += 1
        elif c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c in "[]":
            yield c, FileLoc(filename, line)
            i += 1
        elif c == '"':
            j = i + 1
            start_line = line
            while j < n and text[j] != '"':
                if text[j] == "\n":
                    line += 1
                j += 1
            if j >= n:
                raise TokenError("unterminated string", loc=f"{filename}:{start_line}")
            yield text[i : j + 1], FileLoc(filename, start_line)
            i = j + 1
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n"[]#':
                j += 1
            yield text[i:j], FileLoc(filename, line)
            i = j


class TokenStream:
    """Peekable token stream with an include stack."""

    def __init__(self, text: str, filename: str = "<string>", search_dir=None):
        self._stack = [tokenize(text, filename)]
        self._peeked = None
        self.search_dir = search_dir

    def push_file(self, path):
        from pathlib import Path

        p = Path(path)
        if not p.is_absolute() and self.search_dir is not None:
            p = Path(self.search_dir) / p
        self._stack.append(tokenize(p.read_text(), str(p)))

    def peek(self):
        if self._peeked is None:
            self._peeked = self._next_raw()
        return self._peeked

    def next(self):
        if self._peeked is not None:
            t, self._peeked = self._peeked, None
            return t
        return self._next_raw()

    def _next_raw(self):
        while self._stack:
            try:
                return next(self._stack[-1])
            except StopIteration:
                self._stack.pop()
        return None
