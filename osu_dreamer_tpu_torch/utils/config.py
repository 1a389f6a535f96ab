"""Config plumbing: YAML -> nested dataclasses (counterpart of
osu_dreamer_tpu/utils/config.py ``dataclass_from_dict`` and
``load_yaml_config``; yaml is imported only when a config file is read)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, TypeVar, get_type_hints

T = TypeVar("T")


def dataclass_from_dict(cls: type[T], data: dict[str, Any]) -> T:
    """recursively build a dataclass from a nested dict, descending into
    fields whose type hint is a dataclass; unknown keys raise"""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    hints = get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    for key, value in data.items():
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        hint = hints.get(key)
        if isinstance(value, dict) and hint is not None and dataclasses.is_dataclass(hint):
            kwargs[key] = dataclass_from_dict(hint, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load_yaml_config(path: str | Path) -> dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}
