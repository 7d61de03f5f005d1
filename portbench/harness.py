"""One run of one cell: set-up, the measured window, the check, the
result line's contents.  :mod:`portbench.run` is its command line;
tests and :mod:`portbench.calibrate` call :func:`run_cell` directly."""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch

from portbench import check, counts, loops, registry, traffic as gen
from portbench.reference import adam
from portbench.reference.common import receptive_field

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}
"""The precision below each served or trained dtype that the control runs in."""


def _free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _device_info(device: torch.device, peak: int, summary: dict | None) -> dict:
    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": peak}
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                  "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
                                 capture_output=True, text=True, timeout=30)
            info["power_limit_w"] = float(out.stdout.strip())
        except (OSError, ValueError, subprocess.TimeoutExpired):
            pass
    if summary:
        info["busy_s"], info["window_s"] = summary["busy_s"], summary["window_s"]
    return info


def _serve(spec, s, seconds, traced, device, fault, readings):
    cfg, t = spec["config"], spec["traffic"]
    fam = registry.family(cfg)
    server = fam.Server(cfg, t, s, device)
    if fault:
        fault(server)
    loop = loops.ServeLoop(server, t, s[2])
    stats, w = loop.run(seconds, traced, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    sample = loop.sample(s[3])
    server.close()
    _free(device)
    gaps = [server.gap(c) for c in sample]
    numbers = {"max_logit_gap": max(gaps) if gaps else None, "clips_checked": len(sample),
               "codes_checked": sum(c.length for c in sample)}
    if readings and sample:
        numbers["control_gap"] = max(server.gap(c, CONTROL[t["dtype"]]) for c in sample)
    lat = stats["latency"]
    e2e = {
        t["rate_metric"]: (stats["samples"] / stats["window_s"], "samples/s"),
        t["tail_metric"]: (statistics.quantiles(lat, n=20)[18] if len(lat) >= 20 else None, "s"),
    }
    m = cfg["model"]
    ctx_counts = {
        "per_sample": counts.decode_flops_per_sample(m),
        "decode_launch": counts.decode_launch(m, server.rows_launched, t["steps_per_call"],
                                              t["dtype"]),
    }
    return stats, w, peak, numbers, e2e, ctx_counts, len(lat), 0


def _train(spec, s, seconds, traced, device, fault, readings):
    cfg, t = spec["config"], spec["traffic"]
    fam = registry.family(cfg)
    m = cfg["model"]
    rf, wl, B = receptive_field(m), t["window_length"], t["batch_size"]
    trainer = fam.Trainer(cfg, t, s, device)
    if fault:
        fault(trainer)
    clips = loops.corpus(t, s[1], fam.vocab(cfg), device)
    loop = loops.TrainLoop(trainer, t, clips, rf, s[2], device)
    checked = loop.checked_steps()
    stats, w = loop.run(seconds, traced)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    fed, losses_p, params0 = loop.fed, loop.losses, trainer.params0
    loop.close()
    trainer.close()
    _free(device)
    data, starts = loops.window_starts(clips, rf, wl)
    order = np.random.default_rng(s[2]).permutation(len(starts))
    batches = [np.stack([data[starts[j]: starts[j] + rf + wl] for j in order[i * B:(i + 1) * B]])
               for i in range(t["checked_steps"])]
    mismatch = sum(int((f.cpu().numpy() != b).sum()) for f, b in zip(fed, batches))
    ref_batches = [torch.as_tensor(b, device=device) for b in batches]
    lr = t["optimizer"]["learning_rate"]
    loss_fn = fam.reference_loss(cfg)
    losses_r, grads_r, params_r = adam.train(params0, ref_batches, loss_fn, lr)
    numbers = {"batch_mismatch": mismatch, **check.train_numbers(
        losses_p, losses_r, checked["grads"], grads_r, params0, checked["params"], params_r)}
    if readings:
        lc, gc, pc = adam.train(params0, ref_batches, loss_fn, lr, prec=CONTROL[t["dtype"]])
        numbers["control"] = check.train_numbers(lc, losses_r, gc, grads_r, params0, pc, params_r)
    e2e = {"train_step_ms": (1000.0 * stats["window_s"] / stats["steps"], "ms")}
    ctx_counts = {"step_flops": counts.train_flops(m, wl, B)}
    return stats, w, peak, numbers, e2e, ctx_counts, stats["steps"], stats["failed"]


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float | None = None, fault=None, readings: bool = False) -> dict:
    """Run cell ``spec`` (:func:`portbench.registry.cell`) once.  ``fault``
    is called on the server or trainer before the run (tests break the
    timed path with it); ``readings`` adds the control's numbers (for
    :mod:`portbench.calibrate`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    s = gen.seeds(seed)
    run = _serve if spec["traffic"]["kind"] == "serve" else _train
    stats, w, peak, numbers, e2e, ctx_counts, attempted, failed = run(
        spec, s, seconds, traced, device, fault, readings)
    e2e["setup_s"] = (stats["t_open"] - t_start, "s")
    correct, checks = check.verdict(numbers, spec["limits"])
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if traced:
        ctx = {"trace": w.summary, "stats": stats, "counts": ctx_counts, "config": spec["config"],
               "traffic": spec["traffic"], "cell": spec["name"]}
        values = {m["name"]: (registry.reader(m["name"])(ctx), m["unit"])
                  for m in spec["per_layer"]}
    else:
        values = {m["name"]: e2e.get(m["name"], (None, m["unit"])) for m in spec["end_to_end"]}
    result["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in values.items()
                         if v is not None}
    result["device"] = _device_info(device, peak, w.summary)
    if traced and w.summary:
        ops = sorted(w.summary["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                               "idle_gaps": w.summary["idle_gaps"]}
    result["numbers"] = numbers
    result["checks"] = checks
    return result
