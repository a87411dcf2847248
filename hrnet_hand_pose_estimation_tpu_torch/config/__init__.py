"""Config system: defaults + YAML experiment loading.

The port's own copy of the JAX package's config API, so that both packages
load the same ``experiments/**/*.yaml`` files into equal trees:

    cfg = load_config("experiments/RHD/RHD_HRNet_w32_..._v1.yaml",
                      opts=["TRAIN.LR", 3e-4])

``yaml`` is imported only when a file is read: the defaults and the
``POSE_HIGH_RESOLUTION_NET_EXTRA`` preset need nothing beyond the standard
library.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterable

from .defaults import default_config, POSE_HIGH_RESOLUTION_NET_EXTRA, POSE_RESNET_EXTRA
from .node import ConfigNode

__all__ = [
    "ConfigNode",
    "default_config",
    "load_config",
    "config_from_dict",
    "POSE_HIGH_RESOLUTION_NET_EXTRA",
    "POSE_RESNET_EXTRA",
]


def load_config(yaml_path: str | Path | None = None,
                opts: Iterable[Any] = (),
                freeze: bool = True) -> ConfigNode:
    """Build a config: defaults <- experiment YAML <- dotted CLI overrides."""
    cfg = default_config()
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        cfg.merge_from_mapping(_normalise(data), strict=False)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg.freeze() if freeze else cfg


def config_from_dict(data: dict, opts: Iterable[Any] = (), freeze: bool = True) -> ConfigNode:
    cfg = default_config()
    cfg.merge_from_mapping(_normalise(data))
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg.freeze() if freeze else cfg


def _normalise(data: Any) -> Any:
    """YAML quirk handling: reference YAMLs use python-tuple strings like
    ``GPUS: (4,5)`` which PyYAML parses as the string ``"(4,5)"``."""
    if isinstance(data, dict):
        return {k: _normalise(v) for k, v in data.items()}
    if isinstance(data, str) and data.startswith("(") and data.endswith(")"):
        try:
            inner = [int(x) for x in data[1:-1].split(",") if x.strip()]
            return inner
        except ValueError:
            return data
    return data
