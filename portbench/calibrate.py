"""Readings that set a cell's limits: the program's compared numbers and
the control's (the reference in the precision below the cell's, put in
the program's place), over many seeds in one process, and with
``--faults`` each planted fault's (:mod:`portbench.faults`) on the first
three seeds.  Prints one JSON line a run and writes them all to
``--out``.

    python -m portbench.calibrate --workload wavenet.serve --seeds 11 12 13 \\
        --seconds 8 --faults --out build/calib/wavenet.serve.jsonl
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from portbench import faults, harness, registry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    spec = registry.cell(args.workload)
    planted = faults.SERVING if spec["traffic"]["kind"] == "serve" else faults.TRAINING
    runs = [(seed, None) for seed in args.seeds]
    if args.faults:
        runs += [(seed, name) for name in planted for seed in args.seeds[:3]]
    lines = []
    for seed, fault in runs:
        t0 = time.perf_counter()
        r = harness.run_cell(spec, seed, args.seconds, False, args.device, t_start=t0,
                             fault=planted[fault] if fault else None, readings=fault is None)
        line = {"workload": args.workload, "seed": seed, "fault": fault,
                "correct": r["correct"], "numbers": r["numbers"], "metrics": r["metrics"],
                "device": r["device"], "wall_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
