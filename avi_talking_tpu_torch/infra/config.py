"""Config (de)serialisation (port of ``avi_talking_tpu/infra/config.py``):
every component takes a frozen dataclass config; ``to_dict`` /
``from_dict`` (lists back to tuples, nested dataclasses, an unknown key
raises), ``save_config`` / ``load_config`` as JSON, and ``apply_overrides``
for ``key.subkey=value`` overrides (the value parsed as JSON where it is
JSON, else kept as a string)."""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict, List, Type, TypeVar

T = TypeVar("T")


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
    fields = {f.name for f in dataclasses.fields(cls)}
    try:
        hints = typing.get_type_hints(cls)  # resolves string annotations
    except (NameError, TypeError):  # an annotation that does not resolve here
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config field {cls.__name__}.{k}")
        t = hints.get(k)
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            kwargs[k] = from_dict(t, v)
        else:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def save_config(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_config(cls: Type[T], path: str) -> T:
    with open(path) as f:
        return from_dict(cls, json.load(f))


def apply_overrides(cfg: T, overrides: List[str]) -> T:
    """``["a.b=3", "c=true"]`` applied to a (nested) dataclass; an unknown
    key raises."""
    d = to_dict(cfg)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown override key {key}")
        node[parts[-1]] = val
    return from_dict(type(cfg), d)
