"""Global name -> factory registries, for the port's CLI.

Counterpart of ``dmlc_core_tpu/utils/registry.py`` (``Registry``),
reduced to what ``models/cli.py`` uses: a per-type singleton from
``Registry.get(type_name)``, a ``register`` decorator and lookup by
name.  The port keeps its own copy so that it never imports the JAX
package::

    MODELS = Registry.get("model")

    @MODELS.register("fm", "factorization machine")
    def _fm(p): ...

    model = MODELS["fm"](p)
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from .logging import DMLCError

__all__ = ["Registry", "RegistryEntry"]


class RegistryEntry:
    """A named factory with a description."""

    def __init__(self, name: str, body: Callable[..., Any],
                 description: str = "") -> None:
        self.name = name
        self.body = body
        self.description = description

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.body(*args, **kwargs)


class Registry:
    """Name -> entry registry; one per type name."""

    _registries: Dict[str, "Registry"] = {}
    _global_lock = threading.Lock()

    def __init__(self, type_name: str) -> None:
        self.type_name = type_name
        self._entries: Dict[str, RegistryEntry] = {}
        self._lock = threading.Lock()

    @classmethod
    def get(cls, type_name: str) -> "Registry":
        with cls._global_lock:
            reg = cls._registries.get(type_name)
            if reg is None:
                reg = cls._registries[type_name] = Registry(type_name)
            return reg

    def register(self, name: str, description: str = ""
                 ) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        """Decorator registering ``fn`` under ``name``; a name registers
        once."""
        def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
            with self._lock:
                if name in self._entries:
                    raise DMLCError(f"{self.type_name} '{name}' is already "
                                    f"registered")
                self._entries[name] = RegistryEntry(name, fn, description)
            return fn
        return deco

    def find(self, name: str) -> Optional[RegistryEntry]:
        with self._lock:
            return self._entries.get(name)

    def __getitem__(self, name: str) -> RegistryEntry:
        entry = self.find(name)
        if entry is None:
            raise KeyError(f"unknown {self.type_name} '{name}'; registered: "
                           f"{self.list_names()}")
        return entry

    def list_names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)
