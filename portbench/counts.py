"""Operations and bytes of the model's work, from the configuration's
shapes alone, whatever implements it.

Operations are two a multiply-add of the matrix products (the code
embedding counted as its one-hot product, so that a decoded WaveNet sample
is 2 x the parameters); elementwise work is not counted.  A layer's
products run over the positions its output has.  The autoencoder's
conditioning projections run once a frame, as its encoding is constant
within one.  Bytes are each input read once and each output written once.
"""

from __future__ import annotations

import json
from pathlib import Path

from portbench.reference.common import receptive_field

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
ESIZE = {"float32": 4, "bfloat16": 2}


def _dims(m: dict) -> dict:
    """The decoder's widths under one set of names, for either family."""
    if "quantization_channels" in m:
        return dict(fw=m["filter_width"], L=len(m["dilations"]), Q=m["quantization_channels"],
                    Cr=m["residual_channels"], Cd=m["dilation_channels"], Cs=m["skip_channels"])
    return dict(fw=m["filter_width"], L=len(m["dilations"]), Q=m["quantization_channel"],
                Cr=m["de_residual_channel"], Cd=m["de_dilation_channel"],
                Cs=m["de_skip_channel"], W=m["en_bottleneck_width"],
                eCr=m["en_residual_channel"], eCd=m["en_dilation_channel"],
                pool=m["en_pool_kernel_size"])


def decoder_params(m: dict) -> int:
    """Weights a decoded sample multiplies (conditioning projections apart)."""
    d = _dims(m)
    fw, L, Q, Cr, Cd, Cs = (d[k] for k in ("fw", "L", "Q", "Cr", "Cd", "Cs"))
    return fw * Q * Cr + L * (fw * Cr * 2 * Cd + Cd * Cr + Cd * Cs) + Cs * Cs + Cs * Q


def cond_params(m: dict) -> int:
    """Conditioning projection weights a frame multiplies (0 for WaveNet)."""
    d = _dims(m)
    return d["L"] * d["W"] * 2 * d["Cd"] + d["W"] * d["Cs"] if "W" in d else 0


def decode_flops_per_sample(m: dict) -> int:
    return 2 * decoder_params(m)


def encoder_flops(m: dict, T: int) -> int:
    """The autoencoder's encoder over ``T`` codes, and the conditioning
    projections of the frames it makes."""
    d = _dims(m)
    n = T - (d["fw"] - 1)
    ops = 2 * d["fw"] * d["Q"] * d["eCr"] * n
    for dil in m["dilations"]:
        n -= (d["fw"] - 1) * dil
        ops += 2 * n * (d["fw"] * d["eCr"] * d["eCd"] + d["eCd"] * d["eCr"])
    return ops + 2 * n * d["eCr"] * d["W"] + 2 * (n // d["pool"]) * cond_params(m)


def forward_flops(m: dict, T: int) -> int:
    """One forward over ``T`` input codes (a training window's inputs),
    the encoder included for the autoencoder."""
    d = _dims(m)
    out_w = T - receptive_field(m) + 1
    n = T - (d["fw"] - 1)
    ops = 2 * d["fw"] * d["Q"] * d["Cr"] * n
    for dil in m["dilations"]:
        n -= (d["fw"] - 1) * dil
        ops += 2 * n * (d["fw"] * d["Cr"] * 2 * d["Cd"] + d["Cd"] * d["Cr"])
    ops += 2 * out_w * (d["L"] * d["Cd"] * d["Cs"] + d["Cs"] * d["Cs"] + d["Cs"] * d["Q"])
    return ops + (encoder_flops(m, T) if "W" in d else 0)


def train_flops(m: dict, window_length: int, batch: int) -> int:
    """A training step: forward and backward (2 x the forward) of ``batch``
    windows of ``RF + window_length`` codes."""
    return 3 * batch * forward_flops(m, receptive_field(m) + window_length - 1)


def decode_launch(m: dict, rows: int, steps: int, dtype: str) -> dict:
    """One decode launch of ``rows`` streams (padding included) and
    ``steps`` samples each, the first drawn before it: its operations and
    the bytes of its weights, ring state and codes."""
    d = _dims(m)
    e = ESIZE[dtype]
    ring = rows * sum(m["dilations"]) * d["Cr"] * e
    return {"flops": rows * (steps - 1) * decode_flops_per_sample(m),
            "bytes": decoder_params(m) * e + ring + rows * steps * 4}


def min_seconds(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    t_ops = flops / PEAKS["flops"][dtype]
    t_mem = nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
