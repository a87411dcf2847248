"""String-keyed model registry (port of the JAX package's ``models/registry.py``).

Each model module registers a builder ``(cfg) -> nn.Module``; lookups fail
loudly with the known names.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn: Callable):
        if name in _REGISTRY:
            raise KeyError(f"model {name!r} already registered")
        _REGISTRY[name] = fn
        return fn
    return deco


def build_model(cfg):
    """Build the module named by ``cfg.MODEL.NAME``."""
    return get_builder(cfg.MODEL.NAME)(cfg)


def get_builder(name: str) -> Callable:
    # import model modules lazily so registration happens on first use
    from . import zoo  # noqa: F401  (registers everything)

    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown model {name!r}. Registered: {sorted(_REGISTRY)}"
        ) from None


def registered_models() -> list[str]:
    from . import zoo  # noqa: F401

    return sorted(_REGISTRY)
