"""JSON params files (counterpart of the loading half of
:mod:`music_tpu.core.config`).

The reference's params JSONs come in a dialect that can lack the comma
between a value and the next key (its ``wavenet_autoencoder`` model
params did); :func:`load_json` parses that dialect too.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any


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


def load_params_dir(params_dir: str | Path) -> dict[str, dict[str, Any]]:
    """Every ``*.json`` of a params directory as ``{stem: config_dict}``,
    e.g. ``{"wavenet_params": {...}}``."""
    return {p.stem: load_json(p) for p in sorted(Path(params_dir).glob("*.json"))}
