"""YAML -> typed Config with reflective type coercion.

Same job as the reference ConfigParser
(reference config/config_parser.py:16-110): map YAML sections onto the
five dataclasses, coerce lists to tuples, resolve Optional/Union annotations,
absolutise paths, and record the source file.  Unknown keys raise (instead of
the reference's silent KeyError crash path) with the offending section named.
"""
from __future__ import annotations

import dataclasses
import typing
from pathlib import Path
from typing import Any, Optional, Union

import yaml

from tpuslam_torch.config.schema import (
    Config,
    DatasetConfig,
    DepthPoseConfig,
    LoopClosureConfig,
    ReplayBufferConfig,
    SlamConfig,
)

_SECTIONS = {
    "Dataset": ("dataset", DatasetConfig),
    "DepthPosePrediction": ("depth_pose", DepthPoseConfig),
    "ReplayBuffer": ("replay_buffer", ReplayBufferConfig),
    "LoopClosureDetection": ("loop_closure", LoopClosureConfig),
    "Slam": ("slam", SlamConfig),
}


def _coerce(value: Any, annotation: Any) -> Any:
    origin = typing.get_origin(annotation)
    args = typing.get_args(annotation)
    if origin is Union:
        if value is None:
            if type(None) in args:
                return None
            raise TypeError(f"None not allowed for {annotation}")
        for arg in args:
            if arg is type(None):
                continue
            try:
                return _coerce(value, arg)
            except (TypeError, ValueError):
                continue
        raise TypeError(f"cannot coerce {value!r} to {annotation}")
    if origin in (tuple, typing.Tuple):
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"expected sequence for {annotation}, got {value!r}")
        inner = args[0] if args else Any
        return tuple(_coerce(v, inner) for v in value)
    if annotation is Path:
        if not isinstance(value, (str, Path)):
            raise TypeError(f"expected path, got {value!r}")
        return Path(value).expanduser().absolute()
    if annotation in (int, float, str, bool):
        if annotation is bool and not isinstance(value, bool):
            raise TypeError(f"expected bool, got {value!r}")
        if annotation in (int, float) and isinstance(value, bool):
            raise TypeError(f"expected number, got bool {value!r}")
        if annotation is int and isinstance(value, float) and not value.is_integer():
            raise TypeError(f"expected int, got {value!r}")
        return annotation(value)
    if annotation is Any or annotation is dataclasses.MISSING:
        return value
    return value


def _build_section(cls, data: dict, source: Optional[Path]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"unknown key '{key}' in section {cls.__name__}")
        kwargs[key] = _coerce(value, hints[key])
    section = cls(**kwargs)
    if hasattr(section, "config_file"):
        section.config_file = source
    return section


def parse_config(path) -> Config:
    """Load a YAML config file into a fully-typed Config."""
    path = Path(path)
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = Config()
    for section_name, data in raw.items():
        if section_name not in _SECTIONS:
            raise KeyError(
                f"unknown config section '{section_name}' "
                f"(expected one of {sorted(_SECTIONS)})"
            )
        attr, cls = _SECTIONS[section_name]
        setattr(cfg, attr, _build_section(cls, data or {}, path.absolute()))
    return cfg


def dump_config(cfg: Config) -> str:
    """Readable dump of every section (reference ConfigParser.__str__)."""
    lines = []
    for attr, _ in _SECTIONS.values():
        section = getattr(cfg, attr)
        lines.append(f"[{type(section).__name__}]")
        for f in dataclasses.fields(section):
            lines.append(f"  {f.name}: {getattr(section, f.name)}")
    return "\n".join(lines)


def save_config(cfg: Config, path) -> None:
    """Serialise the config back to YAML (checkpoint provenance)."""

    def clean(v):
        if isinstance(v, Path):
            return str(v)
        if isinstance(v, tuple):
            return list(v)
        return v

    out = {}
    for section_name, (attr, _) in _SECTIONS.items():
        section = getattr(cfg, attr)
        out[section_name] = {
            f.name: clean(getattr(section, f.name))
            for f in dataclasses.fields(section)
            if f.name != "config_file"
        }
    with open(path, "w") as f:
        yaml.safe_dump(out, f, sort_keys=False)
