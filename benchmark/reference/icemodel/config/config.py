"""Model configuration: flat parameter namespace + Fortran-namelist parser.

TPU-native equivalent of the reference config system
(src/UPSY/basic/model_configuration/model_configuration.f90): a single flat
namespace of ~780 parameters with defaults, overridden by a `&CONFIG ... /`
namelist file. Keys in .cfg files carry the `_config` suffix, which is
stripped; unknown keys are an error (mirroring check_config_file_validity).

The Config object is immutable after creation and hashable by identity, so it
can be closed over by jitted functions without retracing on value changes that
don't happen. Only plain Python scalars live here; device arrays derive from
it at model build time.
"""

from __future__ import annotations

import copy
import re
import math
from pathlib import Path

from .config_schema import SCHEMA
from ..utils.logging_utils import crash, warning


class Config:
    """Flat, attribute-accessed configuration (the reference's `C`)."""

    __slots__ = ("_values", "_frozen")

    def __init__(self, **overrides):
        object.__setattr__(self, "_frozen", False)
        values = {k: v for k, (_t, v) in SCHEMA.items()}
        self._values = values
        for k, v in overrides.items():
            self.set(k, v)
        object.__setattr__(self, "_frozen", True)

    # -- attribute access -------------------------------------------------
    def __getattr__(self, k):
        # guard against lookups during construction/copying (e.g. __copy__)
        if k.startswith("_"):
            raise AttributeError(k)
        try:
            return object.__getattribute__(self, "_values")[k]
        except KeyError:
            raise AttributeError(f"unknown config parameter '{k}'") from None

    def __setattr__(self, k, v):
        if getattr(self, "_frozen", False):
            raise AttributeError("Config is immutable; use .replace()")
        object.__setattr__(self, k, v)

    def set(self, k, v):
        if self._frozen:
            raise AttributeError("Config is immutable; use .replace()")
        if k not in SCHEMA:
            crash("unknown config parameter '{}'", k)
        ptype = SCHEMA[k][0]
        self._values[k] = _coerce(k, ptype, v)

    def replace(self, **overrides) -> "Config":
        new = object.__new__(Config)
        object.__setattr__(new, "_values", dict(self._values))
        object.__setattr__(new, "_frozen", False)
        for k, v in overrides.items():
            new.set(k, v)
        object.__setattr__(new, "_frozen", True)
        return new

    def as_dict(self) -> dict:
        return dict(self._values)

    def __repr__(self):
        n = sum(1 for k, v in self._values.items() if v != SCHEMA[k][1])
        return f"Config({len(self._values)} params, {n} non-default)"


def _coerce(key, ptype, v):
    if ptype == "float":
        if isinstance(v, bool):
            crash("config parameter '{}' expects float, got bool", key)
        return float(v)
    if ptype == "int":
        if isinstance(v, float) and not v.is_integer():
            crash("config parameter '{}' expects int, got {}", key, v)
        return int(v)
    if ptype == "bool":
        return bool(v)
    if ptype == "str":
        return str(v)
    if ptype == "floatlist":
        if not isinstance(v, (list, tuple)):
            v = [v]
        return [float(x) for x in v]
    raise AssertionError(ptype)


_FORTRAN_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)(([eEdD][+-]?|[+-])\d+)?(_dp)?$")


def _parse_value(raw: str):
    """Parse a Fortran namelist literal into a Python value."""
    raw = raw.strip()
    if raw.startswith("'") and raw.endswith("'"):
        return raw[1:-1]
    if raw.startswith('"') and raw.endswith('"'):
        return raw[1:-1]
    low = raw.lower()
    if low in (".true.", "t", "true"):
        return True
    if low in (".false.", "f", "false"):
        return False
    if _FORTRAN_FLOAT.match(raw):
        if re.match(r"^[+-]?\d+$", raw):
            return int(raw)
        v = raw.replace("_dp", "").replace("d", "e").replace("D", "e")
        # Fortran permits exponents without E: '1.0-17' == 1.0e-17
        v = re.sub(r"(\d)([+-])(\d+)$", r"\1e\2\3", v)
        return float(v)
    # comma-separated list
    if "," in raw:
        return [_parse_value(p) for p in raw.split(",") if p.strip()]
    return raw


def parse_namelist(path: str | Path) -> dict:
    """Parse a reference-style `&CONFIG ... /` namelist file to a flat dict.

    Strips trailing `!` comments, handles `key_config = value` lines.
    """
    txt = Path(path).read_text()
    values = {}
    in_group = False
    for line in txt.splitlines():
        # strip comments (respecting quoted strings)
        out, in_q = [], None
        for ch in line:
            if in_q:
                out.append(ch)
                if ch == in_q:
                    in_q = None
            elif ch in "'\"":
                in_q = ch
                out.append(ch)
            elif ch == "!":
                break
            else:
                out.append(ch)
        line = "".join(out).strip()
        if not line:
            continue
        if line.startswith("&"):
            in_group = True
            continue
        if line == "/":
            in_group = False
            continue
        if not in_group or "=" not in line:
            continue
        key, _, raw = line.partition("=")
        key = key.strip()
        if key.endswith("_config"):
            key = key[: -len("_config")]
        values[key] = _parse_value(raw)
    return values


def load_config(path: str | Path, strict: bool = False, **extra_overrides) -> Config:
    """Read a reference .cfg namelist file into a Config.

    With strict=True unknown keys crash, mirroring the reference's
    config-file validity check (model_configuration.f90:
    check_config_file_validity). The default is to warn and ignore them,
    because several reference-shipped template configs carry keys from other
    development branches that this reference snapshot itself cannot parse.
    """
    values = parse_namelist(path)
    unknown = [k for k in values if k not in SCHEMA]
    if unknown:
        if strict:
            crash("unknown config parameters in {}: {}", path, unknown)
        warning("ignoring unknown config parameters in {}: {}", path, unknown)
        for k in unknown:
            del values[k]
    values.update(extra_overrides)
    return Config(**values)
