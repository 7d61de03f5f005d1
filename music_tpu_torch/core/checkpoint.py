"""Checkpoints in the JAX package's format, without jax.

Counterpart of :mod:`music_tpu.core.checkpoint`.  A checkpoint is a
directory ``step_<N>`` holding ``arrays.npz`` (one ``leaf_<i>`` array per
leaf) and ``manifest.json`` (step, format 1, and for each leaf its key path
in ``jax.tree_util.keystr`` form, its npz key and dtype).  Key paths read
``['name']`` for a dict key, ``[i]`` for a list or tuple index and
``.name`` for a dataclass field, e.g. ``.params['fg']`` for the trainer's
``TrainState``.  Either package reads what the other writes.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_STEP_RE = re.compile(r"^step_(\d+)$")
_KEY_RE = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]|\.(\w+)")


def _flatten(state: Any, path: str = "") -> list[tuple[str, Any]]:
    """Leaves with their keystr paths, in jax's order (dict keys sorted)."""
    if state is None:
        return []
    if isinstance(state, dict):
        return [kv for k in sorted(state) for kv in _flatten(state[k], f"{path}[{k!r}]")]
    if isinstance(state, (list, tuple)):
        return [kv for i, v in enumerate(state) for kv in _flatten(v, f"{path}[{i}]")]
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return [
            kv for f in dataclasses.fields(state)
            for kv in _flatten(getattr(state, f.name), f"{path}.{f.name}")
        ]
    return [(path, state)]


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # numpy has no bfloat16
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def save(
    ckpt_dir: str | Path,
    step: int,
    state: Any,
    *,
    max_checkpoints: int | None = 10,
) -> Path:
    """Save ``state`` (nested dicts, lists, tuples and dataclasses of tensors,
    arrays or scalars) as ``step_<N>``: written to a temporary directory and
    renamed, then older checkpoints beyond ``max_checkpoints`` are removed."""
    ckpt_dir = Path(ckpt_dir)
    target = ckpt_dir / f"step_{step}"
    tmp = ckpt_dir / f".tmp_step_{step}"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays, leaves = {}, []
    for i, (path, leaf) in enumerate(_flatten(state)):
        arr = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        leaves.append({"path": path, "key": f"leaf_{i}", "dtype": str(arr.dtype)})
    np.savez(tmp / _ARRAYS, **arrays)
    manifest = {
        "step": int(step),
        "format": 1,
        "treedef": f"{len(leaves)} leaves: " + ", ".join(l["path"] for l in leaves),
        "leaves": leaves,
    }
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    if target.exists():
        shutil.rmtree(target)
    tmp.rename(target)
    if max_checkpoints is not None:
        steps = all_steps(ckpt_dir)
        for old in steps[: max(0, len(steps) - max_checkpoints)]:
            shutil.rmtree(ckpt_dir / f"step_{old}", ignore_errors=True)
    return target


def all_steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    steps = []
    for p in ckpt_dir.iterdir():
        m = _STEP_RE.match(p.name)
        if m and (p / _MANIFEST).exists():
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _parse_path(path: str) -> list[str | int]:
    keys, pos = [], 0
    for m in _KEY_RE.finditer(path):
        if m.start() != pos:
            raise ValueError(f"cannot parse key path {path!r}")
        pos = m.end()
        if m.group(1) is not None:
            keys.append(m.group(1).encode().decode("unicode_escape"))
        elif m.group(2) is not None:
            keys.append(int(m.group(2)))
        else:
            keys.append(m.group(3))
    if pos != len(path):
        raise ValueError(f"cannot parse key path {path!r}")
    return keys


def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_listify(node[i]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def restore_subtree(ckpt_dir: str | Path, prefix: str, step: int | None = None) -> Any:
    """The leaves under key path ``prefix`` (e.g. ``".params"``) of the
    latest checkpoint (or ``step``), rebuilt as nested dicts and lists of
    numpy arrays keyed by the path below the prefix: a WaveNet trainer
    checkpoint gives ``{"causal": ..., "fg": ..., ...}``."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    target = ckpt_dir / f"step_{step}"
    manifest = json.loads((target / _MANIFEST).read_text())
    tree: dict = {}
    with np.load(target / _ARRAYS) as data:
        for leaf in manifest["leaves"]:
            rest = leaf["path"][len(prefix):]
            # a whole key must match: ".params" is no prefix of ".params_ema"
            if not leaf["path"].startswith(prefix) or rest[:1] not in ("", "[", "."):
                continue
            keys = _parse_path(rest)
            if not keys:
                return data[leaf["key"]]
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = data[leaf["key"]]
    if not tree:
        raise KeyError(f"checkpoint {target} has no leaves under {prefix!r}")
    return _listify(tree)
