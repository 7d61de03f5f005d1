"""JSON configuration (counterpart of :mod:`music_tpu.core.config`).

The reference's params JSONs come in a dialect that can lack the comma
between a value and the next key (its ``wavenet_autoencoder`` model
params did); :func:`load_json` parses that dialect too.  :class:`Schema`
validates a config dict against typed fields with defaults and adds
derived fields (the ``goal_out_size = sum(num_filters)`` pattern).
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Callable, Mapping


class ConfigError(ValueError):
    pass


def _repair_json(text: str) -> str:
    """Insert missing commas between a value and the next quoted key."""
    # value (number / string / bool / null / closing bracket) followed by a
    # newline and a quoted key with no separating comma
    pattern = re.compile(
        r'([0-9eE\.\+\-"\]\}]|true|false|null)([ \t]*\n[ \t]*")(?=[^"]*"\s*:)'
    )
    prev = None
    while prev != text:
        prev = text
        text = pattern.sub(r"\1,\2", text)
    return text


def load_json(path: str | Path) -> dict[str, Any]:
    """Load a JSON config file, repairing the missing-comma dialect."""
    raw = Path(path).read_text()
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        try:
            return json.loads(_repair_json(raw))
        except json.JSONDecodeError as e:
            raise ConfigError(f"cannot parse config {path}: {e}") from e


class _Required:
    """Sentinel: field has no default (dataclasses.MISSING can't be used as
    an actual default value — dataclass machinery strips it)."""


REQUIRED = _Required()


@dataclasses.dataclass(frozen=True)
class Field:
    """One schema entry: a type, an optional default, an optional validator."""

    type: type | tuple[type, ...]
    default: Any = REQUIRED
    validate: Callable[[Any], bool] | None = None
    help: str = ""

    @property
    def required(self) -> bool:
        return self.default is REQUIRED


class Schema:
    """A declarative config schema with derived fields.

    >>> schema = Schema(
    ...     fields={"num_filters": Field(list), "hidden": Field(int, 32)},
    ...     derived={"goal_out_size": lambda c: sum(c["num_filters"])},
    ... )
    >>> cfg = schema.resolve({"num_filters": [100, 200]})
    >>> cfg["goal_out_size"]
    300
    """

    def __init__(
        self,
        fields: Mapping[str, Field],
        derived: Mapping[str, Callable[[dict], Any]] | None = None,
        allow_extra: bool = True,
    ):
        self.fields = dict(fields)
        self.derived = dict(derived or {})
        self.allow_extra = allow_extra

    def resolve(self, raw: Mapping[str, Any]) -> dict[str, Any]:
        cfg: dict[str, Any] = {}
        for name, field in self.fields.items():
            if name in raw:
                value = raw[name]
            elif not field.required:
                value = field.default
            else:
                raise ConfigError(f"missing required config field {name!r}")
            if value is not None and not isinstance(value, field.type):
                # ints are acceptable where floats are expected
                if field.type is float and isinstance(value, int):
                    value = float(value)
                else:
                    raise ConfigError(
                        f"config field {name!r} expected {field.type}, "
                        f"got {type(value).__name__}={value!r}"
                    )
            if field.validate is not None and not field.validate(value):
                raise ConfigError(f"config field {name!r} failed validation: {value!r}")
            cfg[name] = value
        extra = set(raw) - set(self.fields)
        if extra:
            if not self.allow_extra:
                raise ConfigError(f"unknown config fields: {sorted(extra)}")
            for name in extra:
                cfg[name] = raw[name]
        for name, fn in self.derived.items():
            cfg[name] = fn(cfg)
        return cfg

    def load(self, path: str | Path) -> dict[str, Any]:
        return self.resolve(load_json(path))


def load_params_dir(params_dir: str | Path) -> dict[str, dict[str, Any]]:
    """Every ``*.json`` of a params directory as ``{stem: config_dict}``,
    e.g. ``{"wavenet_params": {...}}``."""
    return {p.stem: load_json(p) for p in sorted(Path(params_dir).glob("*.json"))}
