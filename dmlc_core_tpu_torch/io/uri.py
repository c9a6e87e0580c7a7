"""URI parsing and the datasource URI sugar.

Counterpart of ``dmlc_core_tpu/io/uri.py`` (the reference's
``src/io/uri_spec.h`` and the ``URI`` struct of ``src/io/filesys.h``),
kept as a copy so that the port imports nothing of the JAX package:

* ``URI{protocol, host, name}``: ``protocol`` keeps its trailing
  ``://`` (empty for a bare path), ``host`` is the authority and
  ``name`` the path within it;
* ``URISpec`` reads ``path?format=libsvm&key=value#cachefile``: the
  query becomes ``args``, and the fragment names a cache file, which
  gets a ``.split{N}.part{K}`` suffix when there is more than one part.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["URI", "URISpec"]


class URI:
    """Split ``proto://host/path`` (reference ``URI`` `filesys.h:18-52`)."""

    def __init__(self, uri: str):
        self.raw = uri
        pos = uri.find("://")
        if pos < 0:
            self.protocol = ""
            self.host = ""
            self.name = uri
            return
        self.protocol = uri[: pos + 3]  # includes '://', as in the reference
        rest = uri[pos + 3:]
        slash = rest.find("/")
        if slash < 0:
            self.host = rest
            self.name = ""
        else:
            self.host = rest[:slash]
            self.name = rest[slash:]

    @property
    def scheme(self) -> str:
        """Protocol without '://' ('' for local paths)."""
        return self.protocol[:-3] if self.protocol else ""

    def str_nohost(self) -> str:
        """Reconstruct without authority (local path form)."""
        return self.protocol + self.name if self.protocol else self.name

    def __str__(self) -> str:
        return self.raw

    def __repr__(self) -> str:
        return f"URI(protocol={self.protocol!r}, host={self.host!r}, name={self.name!r})"


class URISpec:
    """Datasource URI sugar ``path?k=v&k2=v2#cachefile`` (reference `uri_spec.h:29-77`)."""

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1):
        self.raw = uri
        self.args: Dict[str, str] = {}
        self.cache_file: Optional[str] = None

        body = uri
        frag = body.find("#")
        if frag >= 0:
            cache = body[frag + 1:]
            body = body[:frag]
            if cache:
                # per-partition cache suffix (reference `uri_spec.h:51-54`)
                if num_parts != 1:
                    cache = f"{cache}.split{num_parts}.part{part_index}"
                self.cache_file = cache
        q = body.find("?")
        if q >= 0:
            query = body[q + 1:]
            body = body[:q]
            for kv in query.split("&"):
                if not kv:
                    continue
                if "=" in kv:
                    k, v = kv.split("=", 1)
                else:
                    k, v = kv, ""
                self.args[k] = v
        self.uri = body

    def __repr__(self) -> str:
        return (f"URISpec(uri={self.uri!r}, args={self.args!r}, "
                f"cache_file={self.cache_file!r})")
