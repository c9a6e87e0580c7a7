"""Declarative typed hyper-parameters, for the port's CLI.

Counterpart of ``dmlc_core_tpu/utils/parameter.py``, reduced to what
``models/cli.py`` uses: :class:`Parameter` structs of :func:`field`
descriptors with defaults, required fields, inclusive lower bounds,
enum domains (a list, or a callable read at each check), ``init``
from a ``{key: value}`` dict that rejects unknown keys, and
``doc_string``.  Bad values raise :class:`ParamError`.  Beside them,
:func:`get_env`, the typed environment read of the serving layer's
deployment settings, and :func:`env_int` / :func:`parse_lenient_bool`,
the lenient reads of knobs parsed on worker threads (a malformed value
logs one warning and reads as unset).  The port keeps its own copy so that it never
imports the JAX package::

    class TrainParams(Parameter):
        data = field(str, help="training data URI")       # required
        epochs = field(int, default=1, lower_bound=1)

    p = TrainParams()
    p.init({"data": "train.libsvm", "epochs": "3"})
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Type, Union

from .logging import DMLCError, log_warning

__all__ = ["Parameter", "field", "ParamError", "get_env", "env_int",
           "parse_lenient_bool"]

_NOTHING = object()


class ParamError(DMLCError, ValueError):
    """A bad, missing or unknown parameter."""


def _parse_bool(s: Any) -> bool:
    if isinstance(s, bool):
        return s
    if isinstance(s, (int, float)):
        return bool(s)
    t = str(s).strip().lower()
    if t in ("true", "1", "yes", "t"):
        return True
    if t in ("false", "0", "no", "f"):
        return False
    raise ValueError(f"invalid bool value {s!r}")


class FieldEntry:
    """One declared parameter field."""

    def __init__(self, dtype: Type[Any], default: Any = _NOTHING, *,
                 help: str = "",
                 enum: Optional[Union[Iterable[Any],
                                      Callable[[], Iterable[Any]]]] = None,
                 lower_bound: Any = None) -> None:
        self.dtype = dtype
        self.default = default
        self.help = help
        self.lower = lower_bound
        # a callable enum is a lazy domain, read at each check (the CLI's
        # model list comes from a registry)
        self.enum = (enum if callable(enum) else list(enum)) \
            if enum is not None else None
        self.name = "<unbound>"

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name

    def __get__(self, obj: Any, objtype: type = None) -> Any:
        if obj is None:
            return self
        if self.name in obj.__dict__:
            return obj.__dict__[self.name]
        if self.default is _NOTHING:
            raise AttributeError(f"required parameter '{self.name}' not set")
        return self.default

    def __set__(self, obj: Any, value: Any) -> None:
        obj.__dict__[self.name] = self.check_and_convert(value)

    def domain(self) -> Optional[List[Any]]:
        if self.enum is None:
            return None
        return list(self.enum()) if callable(self.enum) else self.enum

    def convert(self, value: Any) -> Any:
        if value is None:
            raise ValueError(f"parameter '{self.name}' cannot be None")
        if self.dtype is bool:
            return _parse_bool(value)
        if self.dtype is int:
            # "3" and "3.0" are 3; "2.5" is refused, not truncated
            if isinstance(value, (str, float)):
                f = float(value)
                if f != int(f):
                    raise ValueError(f"value {value!r} for int parameter "
                                     f"'{self.name}' is not integral")
                return int(f)
            return int(value)
        if self.dtype is float:
            f = float(value)
            if math.isnan(f):
                raise ValueError(f"value {value!r} for parameter "
                                 f"'{self.name}' is NaN")
            return f
        return self.dtype(value)

    def check_and_convert(self, value: Any) -> Any:
        try:
            v = self.convert(value)
        except (TypeError, ValueError, OverflowError) as e:
            raise ParamError(
                f"Invalid value {value!r} for parameter '{self.name}' "
                f"(expect {self.dtype.__name__}): {e}") from None
        domain = self.domain()
        if domain is not None and v not in domain:
            raise ParamError(f"Invalid value {v!r} for parameter "
                             f"'{self.name}': expected one of {domain}")
        if self.lower is not None and v < self.lower:
            raise ParamError(f"value {v!r} for parameter '{self.name}' is "
                             f"below lower bound {self.lower!r}")
        return v

    @property
    def required(self) -> bool:
        return self.default is _NOTHING

    def doc(self) -> str:
        parts = [f"{self.name} : {self.dtype.__name__}"]
        parts.append("(required)" if self.required
                     else f"(default={self.default!r})")
        if self.enum is not None:
            parts.append(f"choices={self.domain()}")
        if self.lower is not None:
            parts.append(f"range=[{self.lower}, None]")
        head = " ".join(parts)
        return head + ("\n    " + self.help if self.help else "")


def field(dtype: Type[Any], default: Any = _NOTHING, **kwargs: Any
          ) -> FieldEntry:
    """Declare a parameter field."""
    return FieldEntry(dtype, default, **kwargs)


class _ParamMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        entries: Dict[str, FieldEntry] = {}
        for base in reversed(cls.__mro__):
            for k, v in vars(base).items():
                if isinstance(v, FieldEntry):
                    entries[k] = v
        cls.__param_fields__ = entries
        return cls


class Parameter(metaclass=_ParamMeta):
    """Base class of declarative parameter structs."""

    __param_fields__: Dict[str, FieldEntry] = {}

    def init(self, kwargs: Dict[str, Any]) -> None:
        """Set fields from ``kwargs``.  Raises :class:`ParamError` on an
        unknown key, a bad or out-of-range value, or a missing required
        field."""
        fields = self.__param_fields__
        for k, v in kwargs.items():
            entry = fields.get(k)
            if entry is None:
                raise ParamError(
                    f"unknown parameter '{k}' for {type(self).__name__}; "
                    f"candidates: {sorted(fields)}")
            entry.__set__(self, v)
        missing = [k for k, e in fields.items()
                   if e.required and k not in self.__dict__]
        if missing:
            raise ParamError(f"required parameters {missing} of "
                             f"{type(self).__name__} not set")

    def init_allow_unknown(self, kwargs: Dict[str, Any]) -> None:
        """:meth:`init` with the keys this struct knows; the rest (other
        options of the same source) are ignored."""
        self.init({k: v for k, v in kwargs.items()
                   if k in self.__param_fields__})

    @classmethod
    def doc_string(cls) -> str:
        lines = [f"Parameters of {cls.__name__}", "-" * 30]
        lines += [e.doc() for e in cls.__param_fields__.values()]
        return "\n".join(lines)


def get_env(key: str, default: Any) -> Any:
    """Typed environment read: the value of ``key`` converted to
    ``type(default)`` (bools accept true/false/1/0), ``default`` when
    unset, the raw string when ``default`` is None."""
    raw = os.environ.get(key)
    if raw is None:
        return default
    t = type(default)
    if t is bool:
        return _parse_bool(raw)
    if default is None:
        return raw
    return t(raw)


# keys already warned about: a malformed value logs one warning a process,
# not one a worker thread's read
_env_warned: set = set()


def _warn_once(key: str, msg: str, *args: Any) -> None:
    if key not in _env_warned:
        _env_warned.add(key)
        log_warning(msg, *args)


def env_int(key: str, default: int, *, minimum: Optional[int] = None) -> int:
    """Lenient integer read of ``key``: ``default`` when unset or
    malformed (one warning a key and process), clamped at ``minimum``."""
    raw = os.environ.get(key)
    if raw is None or not raw.strip():
        return default
    try:
        v = int(raw)
    except ValueError:
        _warn_once(key, "ignoring malformed %s=%r (want an integer); "
                   "using default %r", key, raw, default)
        return default
    return v if minimum is None else max(minimum, v)


def parse_lenient_bool(key: str) -> Optional[bool]:
    """Lenient boolean read of ``key``: None when unset, or malformed
    (one warning a key and process)."""
    raw = os.environ.get(key)
    if raw is None or not raw.strip():
        return None
    try:
        return _parse_bool(raw)
    except ValueError:
        _warn_once(key, "ignoring malformed %s=%r (want true/false/1/0)",
                   key, raw)
        return None
