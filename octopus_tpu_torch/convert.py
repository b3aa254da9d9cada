"""Carry settings across from the reference package.

The slice has no learned weights to convert: its error-model tables are the
repository's resources/ files. What must match between the two packages is
configuration, so a run of each uses identical settings."""

from __future__ import annotations

import dataclasses
import typing

from .core.callers.base import BaseCallerConfig


def _from_dict(cls, values: dict):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        sub = hints[f.name]
        if dataclasses.is_dataclass(sub) and isinstance(v, dict):
            v = _from_dict(sub, v)
        kwargs[f.name] = v
    return cls(**kwargs)


def caller_config_from_reference(values: dict, device: str = "cuda",
                                 config_class: type = BaseCallerConfig):
    """The port's `config_class` (BaseCallerConfig, or a caller's own config
    such as CancerCallerConfig) from `dataclasses.asdict` of the
    reference's, nested configs included, running on `device`."""
    config = _from_dict(config_class, values)
    config.device = device
    config.likelihood.device = device
    return config


__all__ = ["caller_config_from_reference"]
