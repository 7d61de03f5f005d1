"""Run one cell of the port's benchmark once and print its result line.

    python -m portbench.run --workload wavenet.serve --seed 7 --seconds 30 --trace 0

The cell, its configuration, traffic and limits are found by name
(:mod:`portbench.registry`).  The run needs as many CUDA devices as the
cell asks for, and exits 2 without a result when they are missing; it
exits 3 without a result when a JAX module or the JAX package was loaded.
The last line of standard output is the result, a JSON object; the last
lines of standard error give every number the check compared beside its
limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "music_tpu")
"""Top-level module names that no run may load: JAX and the JAX package
(compared whole, since ``music_tpu_torch`` begins with ``music_tpu``)."""


def forbidden_modules(modules) -> list[str]:
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


def _caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its kernels under ``build/`` itself)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def _keep_freed_memory() -> None:
    """Have glibc serve every allocation from its heap and never hand freed
    memory back (``mallopt``: no ``mmap``, no trim), so that host buffers
    are reused.  The serving session copies each call's codes into a newly
    allocated 34.6 MB tensor; in fresh 4 KB pages the copy faults every
    page in, which on an H100 virtual machine cost 22 ms a call in some
    runs and 310 ms in others of the same cell."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:  # not glibc: nothing to set
        return
    libc.mallopt(-4, 0)  # M_MMAP_MAX
    libc.mallopt(-1, 2**30)  # M_TRIM_THRESHOLD


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _keep_freed_memory()

    from portbench import registry

    _caches(registry.HERE.parent)
    spec = registry.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"portbench: {args.workload} needs {spec['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from portbench import harness

    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                              t_start=T_START)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
