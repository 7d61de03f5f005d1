"""Cells at a size a CPU test run holds: the shipped families at few layers
and narrow widths, the shipped mixes with few clients and short clips."""

from __future__ import annotations

import copy

from portbench import registry

WAVENET = {"family": "wavenet", "decode_kernel": "decode::", "model": {
    "filter_width": 2, "quantization_channels": 256, "dilations": [1, 2, 4, 8, 1, 2, 4, 8],
    "residual_channels": 8, "dilation_channels": 8, "skip_channels": 16, "use_bias": False}}
WAVENET_AE = {"family": "wavenet_ae", "decode_kernel": "decode::", "model": {
    "filter_width": 2, "quantization_channel": 256, "dilations": [1, 2, 4, 8, 1, 2, 4, 8],
    "en_residual_channel": 8, "en_dilation_channel": 8, "de_residual_channel": 8,
    "de_dilation_channel": 8, "de_skip_channel": 16, "en_bottleneck_width": 16,
    "en_pool_kernel_size": 32, "use_bias": False}}
CONFIGS = {"wavenet": WAVENET, "wavenet_ae": WAVENET_AE}


def traffic(name: str) -> dict:
    """The mix cut to the tiny size.  A serving mix's clips last a few calls
    so that a one-second window completes some dozens, and its temperature
    is 0.1: a check of some thousands of codes then sees a wrong context in
    the logits, where at temperature 1 only near-ties of the noise would
    show it (the cell's own size checks some hundreds of thousands)."""
    t = registry.traffic(name)
    if t["kind"] == "serve":
        t.update(clients=16, steps_per_call=32, clip_seconds=[0.004, 0.02], deck=16,
                 keep_share=1.0, check_clips=16, temperature=0.1)
    else:
        t.update(window_length=256, corpus_clips=3, clip_seconds=0.2)
    return t


CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def cell(name: str) -> dict:
    """Cell ``name`` with its configuration and mix cut to the tiny size;
    its limits, metrics and family as committed."""
    spec = copy.deepcopy(registry.cell(name))
    entry = next(w for w in registry.benchmark()["workloads"] if w["name"] == name)
    spec["config"] = copy.deepcopy(CONFIGS[entry["config"]])
    spec["traffic"] = traffic(entry["traffic"])
    return spec
