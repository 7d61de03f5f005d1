"""Checkpoints in the JAX package's format, without jax.

Counterpart of :mod:`music_tpu.core.checkpoint`.  A checkpoint is a
directory ``step_<N>`` holding ``arrays.npz`` (one ``leaf_<i>`` array per
leaf) and ``manifest.json`` (step, format 1, and for each leaf its key path
in ``jax.tree_util.keystr`` form, its npz key and dtype).  Key paths read
``['name']`` for a dict key, ``[i]`` for a list or tuple index and
``.name`` for a dataclass field, e.g. ``.params['fg']`` for the trainer's
``TrainState`` or ``.opt_state[0].mu['fg']`` for its Adam moments.  Either
package reads what the other writes.

From a mesh (``mesh=``, ``specs=``: parameter name -> partition spec, as
the trainers' ``param_specs``), every rank calls :func:`save`: the leaves
split over ranks (a parameter's, and its optimizer moments', by the last
key of their path) are gathered to whole arrays and only the mesh's first
rank writes, as the JAX package's ``save`` writes on process 0.  On
:func:`restore` every rank reads the whole arrays and keeps its block, so
a checkpoint crosses between meshes, and between the packages, unchanged.
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
import torch.distributed as dist

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


def _spec(path: str, specs: dict | None) -> tuple:
    """The partition spec of the leaf at ``path``: that of the parameter
    its last dict key names (replicated for the rest)."""
    if not specs:
        return ()
    keys = [k for k in _parse_path(path) if isinstance(k, str)]
    return specs.get(keys[-1], ()) if keys else ()


def save(
    ckpt_dir: str | Path,
    step: int,
    state: Any,
    *,
    max_checkpoints: int | None = 10,
    mesh=None,
    specs: dict | None = None,
) -> Path:
    """Save ``state`` (nested dicts, lists, tuples and dataclasses of tensors,
    arrays or scalars) as ``step_<N>``: written to a temporary directory and
    renamed, then older checkpoints beyond ``max_checkpoints`` are removed.
    With ``mesh``, every rank of it calls this: leaves split by ``specs``
    are gathered, the mesh's first rank writes, and all return once the
    checkpoint is in place."""
    from music_tpu_torch.parallel.mesh import gather

    ckpt_dir = Path(ckpt_dir)
    target = ckpt_dir / f"step_{step}"
    main = mesh is None or mesh.is_main
    arrays, leaves = {}, []
    for i, (path, leaf) in enumerate(_flatten(state)):
        if mesh is not None and isinstance(leaf, torch.Tensor):
            leaf = gather(mesh, leaf, _spec(path, specs))
        if main:
            arr = _to_numpy(leaf)
            arrays[f"leaf_{i}"] = arr
            leaves.append({"path": path, "key": f"leaf_{i}", "dtype": str(arr.dtype)})
    if main:
        _write(ckpt_dir, step, arrays, leaves, max_checkpoints)
    group = None if mesh is None else mesh.group(("data", "seq", "model"))
    if group is not None:
        dist.barrier(group=group)
    return target


def _write(ckpt_dir: Path, step: int, arrays: dict, leaves: list,
           max_checkpoints: int | None) -> None:
    target = ckpt_dir / f"step_{step}"
    tmp = ckpt_dir / f".tmp_step_{step}"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
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


def _checkpoint_dir(ckpt_dir: str | Path, step: int | None) -> Path:
    """``ckpt_dir/step_<step>``, the latest one when ``step`` is None."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return ckpt_dir / f"step_{step}"


def _map_leaves(state: Any, fn, path: str = "") -> Any:
    """``state`` rebuilt with every leaf replaced by ``fn(path, leaf)``;
    the structure (and ``_flatten``'s paths) unchanged."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: _map_leaves(v, fn, f"{path}[{k!r}]") for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        items = [_map_leaves(v, fn, f"{path}[{i}]") for i, v in enumerate(state)]
        return type(state)(items) if isinstance(state, list) else tuple(items)
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return dataclasses.replace(state, **{
            f.name: _map_leaves(getattr(state, f.name), fn, f"{path}.{f.name}")
            for f in dataclasses.fields(state)})
    return fn(path, state)


def _restored_leaf(key: str, arr: np.ndarray, ref: Any) -> Any:
    """The stored ``arr`` in the place of the example leaf ``ref``: the
    same shape, the same kind of number (float, integer or bool), cast to
    ``ref``'s dtype and, for a tensor, put on its device."""
    ref_arr = ref.detach() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    if tuple(ref_arr.shape) != arr.shape:
        raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != expected "
                         f"{tuple(ref_arr.shape)}")
    ref_float = ref_arr.is_floating_point() if isinstance(ref_arr, torch.Tensor) else (
        np.issubdtype(ref_arr.dtype, np.floating))
    ref_bool = ref_arr.dtype in (torch.bool, np.bool_)
    if (ref_float != np.issubdtype(arr.dtype, np.floating)
            or ref_bool != (arr.dtype == np.bool_)):
        raise TypeError(f"checkpoint leaf {key} has dtype {arr.dtype}, expected {ref_arr.dtype}")
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=ref.device, dtype=ref.dtype)
    return arr.astype(ref_arr.dtype)


def restore(ckpt_dir: str | Path, example_state: Any, step: int | None = None, *,
            mesh=None, specs: dict | None = None) -> Any:
    """The checkpoint at ``step`` (default: the latest) in the structure of
    ``example_state``: every leaf of the example must be stored with its
    shape and kind of number, and comes back in its dtype and on its
    device.  With ``mesh``, the example's leaves split by ``specs`` are
    this rank's blocks, and so are the leaves restored.  Raises
    ``FileNotFoundError`` when there is no checkpoint and ``KeyError`` for
    a missing leaf."""
    from music_tpu_torch.parallel.mesh import local_index

    target = _checkpoint_dir(ckpt_dir, step)
    manifest = json.loads((target / _MANIFEST).read_text())
    with np.load(target / _ARRAYS) as data:
        stored = {leaf["path"]: data[leaf["key"]] for leaf in manifest["leaves"]}

    def fill(path, leaf):
        if path not in stored:
            raise KeyError(f"checkpoint {target} missing leaf {path}")
        arr = stored[path]
        if mesh is not None:
            arr = arr[local_index(mesh, _spec(path, specs), arr.shape)]
        return _restored_leaf(path, arr, leaf)

    return _map_leaves(example_state, fill)


def restore_or_init(ckpt_dir: str | Path, init_state: Any, *, mesh=None,
                    specs: dict | None = None) -> tuple[Any, int]:
    """Resume if a checkpoint exists: ``(state, step)`` of the latest one,
    else ``(init_state, 0)`` (``mesh``, ``specs``: see :func:`restore`)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return init_state, 0
    return restore(ckpt_dir, init_state, step, mesh=mesh, specs=specs), step


def leaf_shapes(ckpt_dir: str | Path, prefix: str = "",
                step: int | None = None) -> dict[str, tuple]:
    """Shapes of the stored leaves under ``prefix``, keyed by their paths
    below it (e.g. ``"['fg']"`` under ``".params"``)."""
    target = _checkpoint_dir(ckpt_dir, step)
    manifest = json.loads((target / _MANIFEST).read_text())
    with np.load(target / _ARRAYS) as data:
        return {
            leaf["path"][len(prefix):]: data[leaf["key"]].shape
            for leaf in manifest["leaves"]
            if leaf["path"].startswith(prefix)
        }


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
    target = _checkpoint_dir(ckpt_dir, step)
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
