"""Attribute-access config tree with freeze/merge semantics.

Copy of the JAX package's config tree (the port imports nothing of that
package); a replacement for the reference's yacs ``CfgNode`` singleton
(reference: lib/config/default.py:260-270).  Unlike yacs we keep it tiny:
a dict subclass with attribute access, deep-merge from YAML / dotted
key-value lists, and freezing.  ``new_allowed`` subtrees (MODEL.EXTRA)
accept unknown keys, everything else is validated against the defaults so
typos in experiment YAMLs fail loudly.
"""

from __future__ import annotations

import copy
from typing import Any, Iterable, Mapping


class ConfigNode(dict):
    """A dict with attribute access, optional open schema, and freezing."""

    __slots__ = ("_frozen", "_new_allowed")

    def __init__(self, data: Mapping[str, Any] | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        object.__setattr__(self, "_new_allowed", new_allowed)
        if data:
            for k, v in data.items():
                self[k] = _wrap(v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if self._frozen:
            raise AttributeError(f"ConfigNode is frozen; cannot set {name!r}")
        super().__setitem__(name, _wrap(value))

    # -- lifecycle ----------------------------------------------------------
    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def clone(self) -> "ConfigNode":
        node = ConfigNode(new_allowed=self._new_allowed)
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return node

    # -- merging ------------------------------------------------------------
    def merge_from_mapping(self, other: Mapping[str, Any], strict: bool = True) -> None:
        """Deep-merge ``other`` into self, validating keys against the schema.

        With ``strict=False`` unknown keys are skipped with a warning instead
        of raising — a few stale reference YAMLs carry typo'd keys (e.g.
        ``EXP_NAME`` indented under CUDNN in RHD_w32_256x256_adam_lr1e-3.yaml).
        """
        if self._frozen:
            raise AttributeError("ConfigNode is frozen")
        for k, v in other.items():
            if k not in self:
                if self._new_allowed:
                    self[k] = _wrap(v, new_allowed=True)
                elif strict:
                    raise KeyError(f"Unknown config key: {k!r}")
                else:
                    import warnings

                    warnings.warn(f"Ignoring unknown config key {k!r}", stacklevel=2)
                continue
            cur = self[k]
            if isinstance(cur, ConfigNode) and isinstance(v, Mapping):
                cur.merge_from_mapping(v, strict=strict)
            else:
                self[k] = _coerce(cur, v, k)

    def merge_from_list(self, opts: Iterable[Any]) -> None:
        """Merge ``[key, value, key, value, ...]`` pairs with dotted keys,
        matching yacs CLI-override semantics (reference config/default.py:263)."""
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError("opts must be key/value pairs")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            cur = node[leaf] if leaf in node else None
            node[leaf] = _coerce(cur, _parse_literal(value), key)

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else copy.deepcopy(v))
            for k, v in self.items()
        }


def _wrap(value: Any, new_allowed: bool = False) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, Mapping):
        return ConfigNode(value, new_allowed=new_allowed)
    if isinstance(value, list):
        return [_wrap(v, new_allowed) for v in value]
    return value


def _parse_literal(value: Any) -> Any:
    """Parse CLI string overrides into python literals when possible.

    Accepts YAML-style lowercase booleans (``true``/``false``) — users type
    them from the experiment-file habit and yacs-era muscle memory.
    """
    if not isinstance(value, str):
        return value
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    import ast

    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(current: Any, new: Any, key: str) -> Any:
    """Light type-check against the default value's type (yacs-like)."""
    if current is None or isinstance(current, ConfigNode):
        return _wrap(new)
    if isinstance(new, Mapping):
        raise TypeError(f"Cannot replace scalar key {key!r} with a mapping")
    if isinstance(current, bool) and not isinstance(new, bool):
        if isinstance(new, (int, float)) and new in (0, 1):
            return bool(new)
        raise TypeError(f"Key {key!r}: expected bool, got {type(new).__name__}")
    if isinstance(current, (int, float)) and isinstance(new, (int, float)):
        return new
    if isinstance(current, (list, tuple)):
        if isinstance(new, (list, tuple)):
            return _wrap(list(new))
        if isinstance(new, (str, int, float)):
            # a few legacy reference YAMLs write scalars where the schema
            # expects a list (`DATASET: 'RHD_kpt'`, `EMB_DIM: 96`); promote
            # scalars to singleton lists
            return [new]
        raise TypeError(f"Key {key!r}: expected sequence, got {type(new).__name__}")
    if type(current) is not type(new) and not isinstance(new, type(current)):
        raise TypeError(
            f"Key {key!r}: expected {type(current).__name__}, got {type(new).__name__}"
        )
    return new
