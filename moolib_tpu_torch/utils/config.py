"""Hierarchical YAML config with interpolation and CLI overrides.

A stdlib copy of the JAX package's ``utils/config.py`` (it imports no JAX,
but ``import moolib_tpu`` does).  Counterpart of the reference's
hydra/omegaconf setup
(``examples/vtrace/experiment.py:214-224``, ``examples/vtrace/config.yaml``):
YAML files, ``${section.key}`` interpolation, a ``${uid:}`` resolver for
per-run ids, and hydra-style ``key=value`` / ``section.key=value`` command
line overrides.  Implemented standalone (the image has PyYAML but not
hydra/omegaconf) and kept deliberately small.

Usage::

    cfg = Config.load("config.yaml", overrides=sys.argv[1:])
    cfg.optimizer.learning_rate   # attribute access
    cfg["optimizer"]["learning_rate"]  # mapping access
    cfg.to_dict(), cfg.to_yaml(), Config.from_dict({...})
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional

from . import create_uid

try:
    import yaml
except ImportError:  # pragma: no cover - pyyaml is in the image
    yaml = None

_INTERP = re.compile(r"\$\{([^}]*)\}")

# Registered ``${name:arg}`` resolvers (the reference registers ``uid``).
_RESOLVERS: Dict[str, Callable[[str], Any]] = {
    "uid": lambda _arg: create_uid(),
    "env": lambda name: __import__("os").environ.get(name, ""),
}


def register_resolver(name: str, fn: Callable[[str], Any]) -> None:
    _RESOLVERS[name] = fn


def _parse_scalar(text: str) -> Any:
    """Parse a CLI override value with YAML scalar rules (1 -> int, etc.)."""
    if yaml is not None:
        return yaml.safe_load(text)
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if text in ("true", "True"):
        return True
    if text in ("false", "False"):
        return False
    if text in ("null", "None", "~"):
        return None
    return text


class Config:
    """A nested dict with attribute access, interpolation, and overrides.

    Child nodes remember the root config: ``${a.b}`` interpolations always
    resolve against the root (omegaconf semantics)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, _root: "Config" = None):
        object.__setattr__(self, "_data", dict(data or {}) if _root is None else data)
        object.__setattr__(self, "_root", _root if _root is not None else self)
        if _root is None:
            # Resolver calls (e.g. ${uid:}) evaluate once per config: every
            # read — and every field using the same expression — sees the
            # same value (a per-run id must not change between accesses).
            object.__setattr__(self, "_resolver_cache", {})

    # ------------------------------------------------------------- creation
    @classmethod
    def load(
        cls,
        path: Optional[str] = None,
        overrides: Optional[List[str]] = None,
        defaults: Optional[Dict[str, Any]] = None,
    ) -> "Config":
        """Build a config from (in increasing priority): ``defaults``, the
        YAML file at ``path``, then ``key=value`` overrides."""
        data: Dict[str, Any] = {}
        if defaults:
            _merge(data, defaults)
        if path is not None:
            if yaml is None:
                raise RuntimeError("pyyaml unavailable; cannot read config files")
            with open(path) as f:
                loaded = yaml.safe_load(f) or {}
            if not isinstance(loaded, dict):
                raise ValueError(f"config root must be a mapping: {path}")
            _merge(data, loaded)
        cfg = cls(data)
        for ov in overrides or []:
            cfg.apply_override(ov)
        return cfg

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Config":
        return cls(dict(data))

    # ------------------------------------------------------------- overrides
    def apply_override(self, override: str) -> None:
        """Apply one hydra-style ``a.b.c=value`` override."""
        if "=" not in override:
            raise ValueError(f"override must look like key=value: {override!r}")
        key, _, value = override.partition("=")
        node = self._data
        parts = key.strip().split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = _parse_scalar(value)

    # ------------------------------------------------------------- access
    def __getattr__(self, name: str):
        if name not in self._data:
            # Only a genuinely missing key becomes AttributeError; errors
            # from resolving a *present* key (e.g. an interpolation typo)
            # must surface as-is, not be masked as a missing flag.
            raise AttributeError(name)
        return self[name]

    def __setattr__(self, name: str, value) -> None:
        self._data[name] = value

    def __getitem__(self, name: str):
        value = self._data[name]
        return self._resolve(value)

    def __setitem__(self, name: str, value) -> None:
        self._data[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def get(self, name: str, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, self[k]) for k in self._data)

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    # ---------------------------------------------------------- interpolation
    def _resolve(self, value, _depth: int = 0):
        if _depth > 16:
            raise ValueError("interpolation recursion limit (cycle?)")
        if isinstance(value, dict):
            return Config(value, _root=self._root)
        if isinstance(value, list):
            return [self._resolve(v, _depth + 1) for v in value]
        if isinstance(value, str):
            return self._interp(value, _depth)
        return value

    def _interp(self, text: str, depth: int):
        full = _INTERP.fullmatch(text)
        if full:  # whole-string interpolation keeps the referent's type
            return self._lookup(full.group(1), depth)
        return _INTERP.sub(lambda m: str(self._lookup(m.group(1), depth)), text)

    def _lookup(self, expr: str, depth: int):
        if ":" in expr:  # resolver call, e.g. ${uid:} or ${env:HOME}
            cache = self._root._resolver_cache
            if expr in cache:
                return cache[expr]
            name, _, arg = expr.partition(":")
            fn = _RESOLVERS.get(name)
            if fn is None:
                raise KeyError(f"no such resolver: {name!r}")
            cache[expr] = fn(arg)
            return cache[expr]
        node: Any = self._root._data
        for part in expr.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(f"interpolation target not found: {expr!r}")
            node = node[part]
        return self._resolve(node, depth + 1)

    # ------------------------------------------------------------- export
    def to_dict(self) -> Dict[str, Any]:
        """Fully-resolved plain dict (interpolations applied)."""

        def conv(v):
            if isinstance(v, Config):
                return v.to_dict()
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return {k: conv(self[k]) for k in self._data}

    def to_yaml(self) -> str:
        if yaml is None:
            raise RuntimeError("pyyaml unavailable")
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_yaml())


def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    import copy

    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            # Deep-copy containers: later overrides must never mutate the
            # caller's defaults/source dicts through shared references.
            dst[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
