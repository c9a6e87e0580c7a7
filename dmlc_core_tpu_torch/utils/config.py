"""``key = value`` config files, for the port's CLI.

Counterpart of ``dmlc_core_tpu/utils/config.py`` (``Config``), reduced to
what ``models/cli.py`` uses: loading a file and reading it as a dict.
The grammar is the same:

* ``key = value`` pairs, whitespace-insensitive around ``=``;
* ``#`` starts a comment to the end of the line;
* values may be double-quoted strings with escapes (``\\n``, ``\\t``,
  ``\\"``, ``\\\\``, ``\\r``); the quotes are stripped;
* a repeated key keeps its last value.

The port keeps its own copy so that it never imports the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, TextIO, Tuple, Union

from .logging import DMLCError

__all__ = ["Config"]

_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "r": "\r"}


def _tokenize(text: str) -> Iterator[Tuple[str, bool]]:
    """Yield ``(token, was_quoted)``, skipping comments."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c == '"':
            i += 1
            buf: List[str] = []
            closed = False
            while i < n:
                c = text[i]
                if c == "\\" and i + 1 < n:
                    buf.append(_ESCAPES.get(text[i + 1], text[i + 1]))
                    i += 2
                    continue
                if c == '"':
                    closed = True
                    i += 1
                    break
                buf.append(c)
                i += 1
            if not closed:
                raise DMLCError("Config: unterminated quoted string")
            yield "".join(buf), True
        elif c == "=":
            i += 1
            yield "=", False
        elif c.isspace():
            i += 1
        else:
            j = i
            while (j < n and not text[j].isspace()
                   and text[j] not in ("=", "#", '"')):
                j += 1
            yield text[i:j], False
            i = j


class Config:
    """Ordered ``key -> value`` config, values as strings."""

    def __init__(self, source: Union[str, TextIO, None] = None) -> None:
        self._items: Dict[str, str] = {}
        if source is not None:
            self.load(source)

    def load(self, source: Union[str, TextIO]) -> None:
        text = source if isinstance(source, str) else source.read()
        toks = list(_tokenize(text))
        i = 0
        while i < len(toks):
            key, key_q = toks[i]
            if key == "=" and not key_q:
                raise DMLCError("Config: unexpected '='")
            if i + 1 >= len(toks) or toks[i + 1][0] != "=" or toks[i + 1][1]:
                raise DMLCError(f"Config: expected '=' after key {key!r}")
            if i + 2 >= len(toks):
                raise DMLCError(f"Config: missing value for key {key!r}")
            self._items[key] = toks[i + 2][0]
            i += 3

    def to_dict(self) -> Dict[str, str]:
        return dict(self._items)
