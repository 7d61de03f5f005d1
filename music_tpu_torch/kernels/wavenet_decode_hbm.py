"""Weight-streaming fused WaveNet decode: one CUDA launch for the whole loop,
for models too large for :mod:`.wavenet_decode`'s kernel, with int8 modes.

Counterpart of :mod:`music_tpu.kernels.wavenet_decode_hbm` (the Pallas
kernel ``_decode_kernel_hbm`` and its wrapper
``generate_tokens_fused_hbm``).  The kernel is
``csrc/wavenet_decode_hbm.cu``: its working-dtype mode (mode 0) runs on
the resident body of :mod:`.wavenet_decode` with per-layer skip
(``csrc/decode_resident.cuh``, ``LAYER_SKIP``), its int8 modes (1 and 2)
on ``csrc/decode_hbm.cuh``.  :func:`decode_reference` is its plain PyTorch
version, with the same packs, rounding points, quantization and Philox
draws.

What it computes beyond :mod:`.wavenet_decode`:

- **Per-layer skip accumulation**: ``skip_acc += z_i @ skip_i`` in float32,
  layer by layer, then ``h = relu(skip_acc)``, ``h2 = relu(h @ post1)``,
  ``logits = h2 @ post2``, rounded to the working dtype where the TPU
  kernel's ``.astype(dtype)`` rounds.  The thread block holds no ``z`` of
  all layers, so the scaled model (Cr = Cd = 64, Cs = 1024) takes 4
  streams a block in mode 0 and 16 in the int8 modes (:func:`smem_layout`,
  :func:`max_streams`).
- **int8 weights** (``weight_dtype=torch.int8``): per-output-column
  symmetric scales ``max|w| / 127`` (1 for all-zero columns), quantized
  over the rows the TPU packs quantize them over (:func:`pack_weights`);
  the products run on the int8 values in the working dtype and the scale
  multiplies the float32 result.  Exact against the plain step loop on
  :func:`dequantized_params`.
- **int8 products** (``int8_matmul=True``): s8 x s8 -> s32 sums with
  per-row activation scales (dynamic, or static ``act_scales`` from
  :func:`calibrate_act_scales`, folded into the gate column scales).

Layout on the card: B1's (rings ``[B, sum(d), Cr]`` in device memory,
tokens as indices, embeddings as row gathers), unpadded packs ``fg [L, 2Cr,
2Cd]``, ``dense [L, Cd, Cr]``, ``skip [L, Cd, Cs]``, ``post1 [Cs, Cs]``,
``post2 [Cs, Q]`` and, for int8, f32 ``<name>_scale`` rows; in mode 0 also
the chain packs ``fg_t``, ``dense_t`` (:func:`.wavenet_decode.chain_packs`),
which the kernel stages in place of ``fg`` and ``dense``.  The TPU
kernel's d >= 3 guard for prefetched taps (``rings_in_hbm``) has no
counterpart (a layer's slot is written only by that layer, after its tap
was read or staged); nor have ``rings_in_hbm``, ``batched_ring_dma``,
``serving_stream_width`` and the stream-group caps, which manage 16 MB of
VMEM.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from music_tpu_torch.kernels import _build, wavenet_decode
from music_tpu_torch.kernels.wavenet_decode import (
    SMEM_LIMIT, SUPPORTED_STREAMS, _check_supported, _pad4, _sample_scores, chain_packs,
    check_aligned, check_tile, ring_offsets,
)
from music_tpu_torch.models.wavenet import WaveNetConfig, _gate
from music_tpu_torch.ops.conv import conv1x1, dilated_causal_conv, full_fp32, token_causal_conv

LAUNCHES = 0
"""Kernel launches so far in this process (the CUDA wrapper adds one per
launch; the CPU path never does)."""

THREADS = 512
"""Threads per block (``kThreads`` in ``csrc/decode_common.cuh``)."""
WEIGHT_KEYS = ("fg", "dense", "skip", "post1", "post2")
"""The packs that int8 mode quantizes (embeddings stay in the working dtype)."""
LAYER_SKIP_STREAMS = (1, 2, 4)
"""Streams per block mode 0 (the resident body with per-layer skip) is
compiled for.  The scaled width's carve fits 4 f32 or 8 bf16 streams
(:func:`max_streams`), but 8 bf16 streams a block ran slower on an H100
than the resident kernel's 4 a block in two waves (PERF.md, section 6), so
the tile is not compiled."""
SPAN_PHASES = ("embedding and first stage", "layer wait and barrier", "layer copies issued",
               "fg and gate", "dense and residual", "skip of the last layer", "post",
               "sampling", "total")
"""What each cycle count of a phase-timed launch sums (mode 0, as
:data:`.wavenet_decode.SPAN_PHASES`): the layer phases are the chain
warp's, so the other layers' skip shows as its wait at the barrier."""

_INV127 = float(np.float32(1.0 / 127.0))  # the f32 of 1/127, as the TPU kernel's 1.0 / 127.0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_layout(L: int, Cr: int, Cd: int, Cs: int, Q: int, S: int,
                dtype: torch.dtype = torch.float32, mode: int = 0,
                ae: bool = False) -> tuple[list[int], int]:
    """The kernel's shared-memory carve for ``S`` streams per block in
    ``mode`` (0 weights in the working dtype ``dtype``, 1 int8 weights, 2
    int8 products; ``ae`` for the autoencoder): ``(offsets, bytes)``.

    Mode 0 runs the resident body, whose carve is
    :func:`.wavenet_decode.smem_layout` with ``layer_skip`` (its stages hold
    ``dtype``, so it depends on it).  The int8 modes run
    ``csrc/decode_hbm.cuh``: offsets in floats of ``tap, xq, z, acc, red_a,
    red_b, ints`` (``x`` is at 0).  Per stream: x, the tap, x's int8 codes
    (mode 2), z, skip_acc ``[Cs]`` (then h, then h2) and two buffers of
    split partial sums (a product of N columns keeps ``max(THREADS, N)`` of
    them per stream); then ``cur, prev, frame`` per stream, ``dil, off`` per
    layer and two row scales per stream; activations in float32 whatever
    the working dtype."""
    if mode == 0:
        return wavenet_decode.smem_layout(L, Cr, Cd, Cs, Q, S, dtype, ae, layer_skip=True)
    int8_matmul = mode == 2
    sizes = [
        S * Cr,                                # x
        S * Cr,                                # tap
        S * Cr if int8_matmul else 0,          # xq
        S * Cd,                                # z
        S * Cs,                                # acc
        S * max(THREADS, 2 * Cd, Cr, Q),       # red_a: fg, dense, logits
        S * max(THREADS, 2 * Cd, Cs, Q),       # red_b: skip, post1, post2, fg's x part
    ]
    offsets, o = [], 0
    for n in sizes:
        offsets.append(o)
        o += _pad4(n)
    return offsets[1:] + [o], 4 * (o + 3 * S + 2 * L + 2 * S)


def mode_of(weight_dtype: torch.dtype | None, int8_matmul: bool = False) -> int:
    """The kernel's mode: 0 weights in the working dtype, 1 int8 weights, 2
    int8 products."""
    return 2 if int8_matmul else int(weight_dtype == torch.int8)


def streams_of(mode: int) -> tuple[int, ...]:
    """The tiles the kernel is compiled for in ``mode``."""
    return SUPPORTED_STREAMS if mode else LAYER_SKIP_STREAMS


def max_streams(cfg: WaveNetConfig, dtype: torch.dtype = torch.float32, mode: int = 0) -> int:
    """The most streams per block (of :func:`streams_of` ``mode``) whose
    carve (:func:`smem_layout`) fits :data:`SMEM_LIMIT`; 0 when none does."""
    dims = (cfg.n_blocks, cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels,
            cfg.quantization_channels)
    return max((s for s in streams_of(mode)
                if smem_layout(*dims, s, dtype, mode)[1] <= SMEM_LIMIT), default=0)


def _quantize_cols(w: torch.Tensor, dim: int):
    """Symmetric int8 per-output-column quantization along ``dim``:
    ``(q, scale)`` with ``q * scale`` the dequantized value; all-zero
    columns get scale 1.  Divisions are tensor by tensor (true division on
    every device)."""
    amax = w.abs().amax(dim=dim, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def pack_weights(w32: dict, dtype: torch.dtype, weight_dtype: torch.dtype | None) -> dict:
    """The kernel's packs from float32 ``w32`` (``ecur, eprev [Q, Cr], fg [L,
    2Cr, 2Cd], dense, skip, post1, post2``): every pack in ``dtype``, or
    with ``weight_dtype=torch.int8`` the :data:`WEIGHT_KEYS` in int8 with
    f32 ``<key>_scale`` rows (``[L, cols]`` per layer, ``[cols]`` for the
    post matrices).  Columns quantize over the rows music_tpu's padded
    packs quantize them over: fg's over both taps, dense's and skip's over
    Cd, post's over Cs, so codes and scales are the TPU kernel's."""
    out = {k: w32[k].to(dtype).contiguous() for k in ("ecur", "eprev")}
    if weight_dtype is None:
        out.update({k: w32[k].to(dtype).contiguous() for k in WEIGHT_KEYS})
        return out
    if weight_dtype != torch.int8:
        raise NotImplementedError("weight_dtype must be None or torch.int8")
    for k in WEIGHT_KEYS:
        v = w32[k].float()
        q, scale = _quantize_cols(v, dim=v.dim() - 2)
        out[k] = q.contiguous()
        out[f"{k}_scale"] = scale.squeeze(-2).contiguous()
    return out


def with_chain_packs(w: dict) -> dict:
    """``w`` with, for weights in the working dtype, the chain packs
    ``fg_t``, ``dense_t`` (:func:`.wavenet_decode.chain_packs`) that the
    kernel stages in mode 0; the plain version reads ``fg`` and ``dense``."""
    if w["fg"].dtype != torch.int8:
        w["fg_t"], w["dense_t"] = chain_packs(w["fg"], w["dense"])
    return w


def dequantize(w: dict) -> dict:
    """float32 ``q * scale`` of every int8 pack of :func:`pack_weights`."""
    return {k: w[k].float() * w[f"{k}_scale"].unsqueeze(-2) for k in WEIGHT_KEYS}


def col_scaled(w: dict, v: torch.Tensor, key: str, layer: int | None = None) -> torch.Tensor:
    """``v``, a product with pack ``key``, times that pack's int8 column
    scales (of ``layer`` for the per-layer packs); ``v`` itself when the
    weights are not int8."""
    if f"{key}_scale" not in w:
        return v
    scale = w[f"{key}_scale"]
    return v * (scale if layer is None else scale[layer])


def _build_hbm_weights(params: dict, cfg: WaveNetConfig, dtype: torch.dtype = torch.float32,
                       weight_dtype: torch.dtype | None = None) -> dict:
    """The model's packs (:func:`pack_weights`)."""
    L, Cr, Cd = cfg.n_blocks, cfg.residual_channels, cfg.dilation_channels
    w32 = {
        "ecur": params["causal"][1], "eprev": params["causal"][0],
        "fg": params["fg"].float().reshape(L, 2 * Cr, 2 * Cd),
        "dense": params["dense"], "skip": params["skip"],
        "post1": params["post1"], "post2": params["post2"],
    }
    return pack_weights(w32, dtype, weight_dtype)


def dequantized_params(params: dict, cfg: WaveNetConfig) -> dict:
    """The parameters the ``weight_dtype=torch.int8`` kernel computes with
    (pack, quantize, dequantize, unpack): the plain step loop
    (:func:`music_tpu_torch.models.wavenet.generate_tokens`) on them is the
    exact reference of the int8 weight-only kernel."""
    L, Cr, Cd = cfg.n_blocks, cfg.residual_channels, cfg.dilation_channels
    dq = dequantize(_build_hbm_weights(params, cfg, weight_dtype=torch.int8))
    return dict(params, fg=dq["fg"].reshape(L, 2, Cr, 2 * Cd), dense=dq["dense"],
                skip=dq["skip"], post1=dq["post1"], post2=dq["post2"])


@torch.no_grad()
def calibrate_act_scales(params: dict, cfg: WaveNetConfig, tokens: torch.Tensor,
                         margin: float = 1.25) -> tuple[float, ...]:
    """Static int8 scales of each layer's residual input for
    ``act_scales=``: the conv forward over representative ``tokens [B, T]``
    and, per layer, ``max|x| * margin / 127`` (as music_tpu's, in Python
    floats)."""
    p32 = {k: v.float() for k, v in params.items()}
    scales = []
    with full_fp32():
        x = token_causal_conv(tokens, p32["causal"])
        for i, d in enumerate(cfg.dilations):
            scales.append(float(x.abs().max()) * margin / 127.0)
            z = _gate(dilated_causal_conv(x, p32["fg"][i], dilation=d))
            x = conv1x1(z, p32["dense"][i]) + x[:, -z.shape[1]:]
    return tuple(scales)


def _check_modes(cfg: WaveNetConfig, weight_dtype, int8_matmul: bool, act_scales) -> None:
    if weight_dtype not in (None, torch.int8):
        raise NotImplementedError("weight_dtype must be None or torch.int8")
    if int8_matmul and weight_dtype != torch.int8:
        raise ValueError("int8_matmul requires weight_dtype=torch.int8")
    if act_scales is not None:
        if not int8_matmul:
            raise ValueError("act_scales requires int8_matmul=True")
        if len(act_scales) != cfg.n_blocks:
            raise ValueError("need one act scale per block")


def prepare(
    params: dict, prime: torch.Tensor, *, cfg: WaveNetConfig, n_streams: int,
    n_stream_groups: int = 1, dtype: torch.dtype = torch.float32,
    weight_dtype: torch.dtype | None = None, int8_matmul: bool = False,
    act_scales: tuple | None = None, sample_mode: str = "argmax",
    temperature: float = 1.0, seed: int = 0,
):
    """Pad the prime rows to ``n_streams * n_stream_groups`` and build the
    kernel inputs ``(weights, ring, s0, prev0)``; the prime state is
    :mod:`.wavenet_decode`'s.  In the working dtype the weights also hold
    the chain packs ``fg_t``, ``dense_t`` that mode 0 stages.  With
    ``int8_matmul`` the dense and skip scales carry the 1/127 of z's codes,
    and static ``act_scales`` fold into the fg scales (``act_inv`` holds
    their f32 inverses)."""
    _check_modes(cfg, weight_dtype, int8_matmul, act_scales)
    _, ring, s0, prev0 = wavenet_decode.prepare(
        params, prime, cfg=cfg, n_streams=n_streams, n_stream_groups=n_stream_groups,
        dtype=dtype, sample_mode=sample_mode, temperature=temperature, seed=seed,
    )
    w = with_chain_packs(_build_hbm_weights(params, cfg, dtype, weight_dtype))
    if int8_matmul:
        w["dense_scale"] = w["dense_scale"] * _INV127
        w["skip_scale"] = w["skip_scale"] * _INV127
        if act_scales is not None:
            act = torch.tensor(act_scales, dtype=torch.float32, device=prime.device)
            w["fg_scale"] = w["fg_scale"] * act[:, None]
            w["act_inv"] = torch.tensor([1.0 / s for s in act_scales], dtype=torch.float32,
                                        device=prime.device)
    return w, ring, s0, prev0


def _exact_mm(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact integer product of activation codes (integer-valued floats) and
    int8 weights: int64 on the CPU, float64 on the card (no integer matmul
    there; every partial sum is an integer below 2^53)."""
    if codes.device.type == "cpu":
        return codes.to(torch.int64) @ q.to(torch.int64)
    return codes.double() @ q.double()


def _quant_rows(v: torch.Tensor):
    """Per-row int8 codes and scales of ``v [B, n]``, as the kernel's
    ``quant_row`` and music_tpu's ``quant_rows``."""
    m = v.abs().amax(dim=-1, keepdim=True).clamp_min(1e-20)
    codes = torch.round(torch.clamp(v * (torch.full_like(m, 127.0) / m), -127.0, 127.0))
    return codes, m * _INV127


@torch.no_grad()
def decode_reference(
    w: dict, ring: torch.Tensor, s0: torch.Tensor, prev0: torch.Tensor, *,
    cfg: WaveNetConfig, n_steps: int, dtype: torch.dtype = torch.float32,
    int8_matmul: bool = False, sample_mode: str = "argmax", temperature: float = 1.0,
    seed: int = 0, forced: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the CUDA kernel, on any device.

    Products accumulate in float32 (int8 products exactly in integers); with
    ``dtype=bfloat16`` rings and embeddings hold bf16 and activations are
    rounded to bf16 after the embedding sum, z (not with ``int8_matmul``),
    the residual add, h and h2.  Returns ``[B, n_steps]`` int32; with
    ``forced`` (``[B, n_steps]`` tokens) it feeds those instead and returns
    the float32 logits ``[B, n_steps - 1, Q]`` of tokens ``1 ..``."""
    Cd, Q = cfg.dilation_channels, cfg.quantization_channels
    if dtype == torch.bfloat16:
        def rnd(v):
            return v.to(torch.bfloat16).float()
    else:
        def rnd(v):
            return v
    if int8_matmul and w["fg"].dtype != torch.int8:
        raise ValueError("int8_matmul requires int8 weights")
    offs, _ = ring_offsets(cfg)
    B = ring.shape[0]
    ring = ring.to(dtype=dtype, copy=True)
    wf = {k: w[k].float() for k in ("ecur", "eprev", *WEIGHT_KEYS)}
    act_inv = w.get("act_inv")
    out = torch.empty((B, n_steps), dtype=torch.int32, device=ring.device)
    out[:, 0] = s0
    if forced is not None:
        forced = forced.to(ring.device, torch.long)
        if tuple(forced.shape) != (B, n_steps) or n_steps < 2:
            raise ValueError(f"forced tokens {tuple(forced.shape)}: need {(B, n_steps)}, "
                             "n_steps >= 2")
        s0 = forced[:, 0]
    all_logits = []
    cur, prev = s0.long(), prev0.long()
    rows = torch.arange(B, device=ring.device)
    with full_fp32():
        for t in range(n_steps - 1):
            x = rnd(wf["ecur"][cur] + wf["eprev"][prev])
            skip_acc = torch.zeros((B, cfg.skip_channels), device=ring.device)
            for i, d in enumerate(cfg.dilations):
                slot = offs[i] + t % d
                tap = ring[:, slot].to(torch.float32, copy=True)  # the slot is overwritten next
                ring[:, slot] = x.to(dtype)  # after the read of the same slot
                Cr = tap.shape[1]
                if int8_matmul:
                    fq = w["fg"][i]
                    if act_inv is not None:
                        tq = torch.round(torch.clamp(tap * act_inv[i], -127.0, 127.0))
                        xq = torch.round(torch.clamp(x * act_inv[i], -127.0, 127.0))
                        fg = (_exact_mm(tq, fq[:Cr]) + _exact_mm(xq, fq[Cr:])).float()
                    else:
                        tq, ts = _quant_rows(tap)
                        xq, xs = _quant_rows(x)
                        fg = (_exact_mm(tq, fq[:Cr]).float() * ts
                              + _exact_mm(xq, fq[Cr:]).float() * xs)
                    zq = torch.round(_gate(col_scaled(w, fg, "fg", i)) * 127.0)
                    x = rnd(x + col_scaled(w, _exact_mm(zq, w["dense"][i]).float(), "dense", i))
                    skip_acc = skip_acc + col_scaled(w, _exact_mm(zq, w["skip"][i]).float(),
                                                     "skip", i)
                    continue
                fg = col_scaled(w, torch.cat([tap, x], dim=-1) @ wf["fg"][i], "fg", i)
                z = rnd(torch.tanh(fg[:, :Cd]) * torch.sigmoid(fg[:, Cd:]))
                x = rnd(x + col_scaled(w, z @ wf["dense"][i], "dense", i))
                skip_acc = skip_acc + col_scaled(w, z @ wf["skip"][i], "skip", i)
            h = rnd(torch.relu(skip_acc))
            if int8_matmul:
                hq, hs = _quant_rows(h)
                h2 = rnd(torch.relu(col_scaled(w, _exact_mm(hq, w["post1"]).float() * hs,
                                               "post1")))
                h2q, h2s = _quant_rows(h2)
                logits = col_scaled(w, _exact_mm(h2q, w["post2"]).float() * h2s, "post2")
            else:
                h2 = rnd(torch.relu(col_scaled(w, h @ wf["post1"], "post1")))
                logits = col_scaled(w, h2 @ wf["post2"], "post2")
            if forced is None:
                scores = _sample_scores(logits, rows, t + 1, sample_mode, temperature, seed, Q)
                nxt = torch.argmax(scores, dim=-1)
                out[:, t + 1] = nxt.to(torch.int32)
            else:
                all_logits.append(logits)
                nxt = forced[:, t + 1]
            prev, cur = cur, nxt
    if forced is not None:
        return torch.stack(all_logits, dim=1)
    return out


POINTERS = ("dil", "ring", "s0", "prev0", "pos0", "ecur", "eprev", *WEIGHT_KEYS,
            *(f"{k}_scale" for k in WEIGHT_KEYS), "act_inv", "cond_fg", "cond_post", "out",
            "spans")
"""The device pointers both weight-streaming kernels take, in the order of
``HbmPtr`` in ``csrc/decode_hbm.cuh`` (null where a kernel takes none; in
mode 0, ``fg`` and ``dense`` point at the chain packs)."""

ARGTYPES = (
    [ctypes.c_int] * 4          # dtype, mode, S, G
    + [ctypes.c_void_p] * 2     # dims (L, Cr, Cd, Cs, Q, ring_len, F, pool), carve offsets
    + [ctypes.c_int, ctypes.c_void_p]  # carve bytes, POINTERS
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint32]  # n_steps, mode, temp, seed
    + [ctypes.c_void_p]         # stream
)
"""The C signature both weight-streaming entry points share
(``decode_hbm.cuh::hbm_entry``)."""


def _library() -> ctypes.CDLL:
    lib = _build.load("wavenet_decode_hbm")
    lib.wavenet_decode_hbm.argtypes = ARGTYPES
    lib.wavenet_decode_hbm.restype = ctypes.c_int
    lib.wavenet_decode_hbm_error.argtypes = [ctypes.c_int]
    lib.wavenet_decode_hbm_error.restype = ctypes.c_char_p
    return lib


def check_kernel_inputs(w: dict, ring, tokens: dict, dims: tuple, n_streams: int,
                        dtype: torch.dtype, int8_matmul: bool, extra: dict | None = None,
                        ae: bool = False):
    """The checks both weight-streaming wrappers make before a launch: a
    tile the carve of the mode fits, then device, dtype, shape and
    contiguity of every input, and in mode 0 16-byte alignment.  ``dims =
    (L, Cr, Cd, Cs, Q, ring_len)``; ``tokens``: the int32 ``[B]`` vectors;
    ``extra``: other ``name: (tensor, shape)`` in ``dtype``; ``ae`` for the
    autoencoder's carve.  Returns ``(mode, carve offsets, carve bytes)``."""
    L, Cr, Cd, Cs, Q, ring_len = dims
    B = ring.shape[0]
    quant = w["fg"].dtype == torch.int8
    if int8_matmul and not quant:
        raise ValueError("int8_matmul requires int8 weights")
    mode = mode_of(torch.int8 if quant else None, int8_matmul)
    if n_streams not in streams_of(mode) or B % n_streams:
        raise ValueError(f"{B} rows do not split into blocks of n_streams={n_streams} "
                         f"(mode {mode} takes {streams_of(mode)}); take at most max_streams()")
    if mode == 0:
        offsets, nbytes = check_tile(dims[:5], n_streams, dtype, ae, layer_skip=True)
    else:
        offsets, nbytes = smem_layout(*dims[:5], n_streams, dtype, mode)
        if nbytes > SMEM_LIMIT:
            raise ValueError(f"{n_streams} streams per block need {nbytes} bytes of shared "
                             f"memory (limit {SMEM_LIMIT}); take at most max_streams()")
    device = ring.device
    if device.type != "cuda":
        raise ValueError(f"decode_cuda needs CUDA tensors, got {device}")
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype}")
    wdt = torch.int8 if quant else dtype
    shapes = {"ecur": ((Q, Cr), dtype), "eprev": ((Q, Cr), dtype),
              "fg": ((L, 2 * Cr, 2 * Cd), wdt), "dense": ((L, Cd, Cr), wdt),
              "skip": ((L, Cd, Cs), wdt), "post1": ((Cs, Cs), wdt), "post2": ((Cs, Q), wdt)}
    if quant:
        shapes.update({"fg_scale": ((L, 2 * Cd), torch.float32),
                       "dense_scale": ((L, Cr), torch.float32),
                       "skip_scale": ((L, Cs), torch.float32),
                       "post1_scale": ((Cs,), torch.float32),
                       "post2_scale": ((Q,), torch.float32)})
    else:
        pad = 16 // torch.tensor([], dtype=dtype).element_size()
        shapes.update({"fg_t": ((L, 2 * Cd, 2 * Cr + pad), dtype),
                       "dense_t": ((L, Cr, Cd + pad), dtype)})
    if "act_inv" in w:
        if not int8_matmul:
            raise ValueError("act_inv (static act_scales) requires int8_matmul")
        shapes["act_inv"] = ((L,), torch.float32)
    checks = {f"weight {k}": (w[k], shape, dt) for k, (shape, dt) in shapes.items()}
    checks["ring"] = (ring, (B, ring_len, Cr), ring.dtype)
    checks.update({k: (t, (B,), torch.int32) for k, t in tokens.items()})
    checks.update({k: (t, shape, dtype) for k, (t, shape) in (extra or {}).items()})
    for name, (t, shape, dt) in checks.items():
        if t.device != device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dt} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if mode == 0:  # the resident body's 16-byte copies and loads
        check_aligned({name: t for name, (t, _, _) in checks.items() if name not in tokens})
    return mode, (ctypes.c_int * len(offsets))(*offsets), nbytes


def launch(entry, dtype: torch.dtype, mode: int, n_streams: int, dims: tuple, offsets,
           nbytes: int, tensors: dict, n_steps: int, sample_mode: int = 0,
           temperature: float = 1.0, seed: int = 0) -> int:
    """Call a weight-streaming C entry point on the current stream of the
    ring's device: ``dims = (L, Cr, Cd, Cs, Q, ring_len, F, pool)``,
    ``tensors`` the checked inputs by :data:`POINTERS` name (those missing
    pass null).  Returns the entry point's CUDA error code."""
    ring = tensors["ring"]
    if mode == 0:  # the resident body stages the chain packs
        tensors = {**tensors, "fg": tensors["fg_t"], "dense": tensors["dense_t"]}
    ptrs = (ctypes.c_void_p * len(POINTERS))(
        *(tensors[k].data_ptr() if k in tensors else None for k in POINTERS))
    with torch.cuda.device(ring.device):
        stream = torch.cuda.current_stream(ring.device).cuda_stream
        return entry(
            _DTYPES[dtype], mode, n_streams, ring.shape[0] // n_streams,
            ctypes.cast((ctypes.c_int * 8)(*dims), ctypes.c_void_p),
            ctypes.cast(offsets, ctypes.c_void_p), nbytes, ctypes.cast(ptrs, ctypes.c_void_p),
            n_steps, sample_mode, float(temperature), seed & 0xFFFFFFFF, stream,
        )


def decode_cuda(
    w: dict, ring: torch.Tensor, s0: torch.Tensor, prev0: torch.Tensor, *,
    cfg: WaveNetConfig, n_steps: int, n_streams: int, dtype: torch.dtype = torch.float32,
    int8_matmul: bool = False, sample_mode: str = "argmax", temperature: float = 1.0,
    seed: int = 0, spans: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (same arguments and
    result as :func:`decode_reference`).  Raises on anything it does not
    take, a tile larger than :func:`max_streams` included, and when the
    launch is refused.  ``spans``, an int64 CUDA tensor with one entry per
    :data:`SPAN_PHASES`, runs the phase-timed build instead (mode 0,
    float32, one stream a block), which writes block 0's cycle counts per
    phase into it."""
    global LAUNCHES
    _check_supported(cfg)
    if sample_mode not in ("argmax", "categorical"):
        raise ValueError(f"unknown sample_mode {sample_mode!r}")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    L, Cr, Cd, Cs, Q = (cfg.n_blocks, cfg.residual_channels, cfg.dilation_channels,
                        cfg.skip_channels, cfg.quantization_channels)
    _, ring_len = ring_offsets(cfg)
    s0, prev0 = s0.contiguous(), prev0.contiguous()
    mode, offsets, nbytes = check_kernel_inputs(
        w, ring, {"s0": s0, "prev0": prev0}, (L, Cr, Cd, Cs, Q, ring_len), n_streams, dtype,
        int8_matmul)
    device = ring.device
    if spans is not None and (spans.device != device or spans.dtype != torch.int64
                              or tuple(spans.shape) != (len(SPAN_PHASES),) or mode != 0
                              or dtype != torch.float32 or n_streams != 1):
        raise ValueError(f"spans: need int64 [{len(SPAN_PHASES)}] on the decode's device, "
                         "weights and activations in float32, n_streams=1")
    ring = ring.to(dtype=dtype, copy=True).contiguous()  # the kernel updates it in place
    dil = torch.tensor(cfg.dilations, dtype=torch.int32, device=device)
    out = torch.empty((ring.shape[0], n_steps), dtype=torch.int32, device=device)
    tensors = {**w, "dil": dil, "ring": ring, "s0": s0, "prev0": prev0, "out": out}
    if spans is not None:
        tensors["spans"] = spans
    lib = _library()
    rc = launch(lib.wavenet_decode_hbm, dtype, mode, n_streams, (L, Cr, Cd, Cs, Q, ring_len, 1, 1),
                offsets, nbytes, tensors, n_steps, {"argmax": 0, "categorical": 1}[sample_mode],
                temperature, seed)
    if rc != 0:
        raise RuntimeError(
            f"wavenet_decode_hbm launch failed: {lib.wavenet_decode_hbm_error(rc).decode()}")
    LAUNCHES += 1
    return out


def generate_tokens_fused_hbm(
    params: dict,
    prime: torch.Tensor,
    *,
    cfg: WaveNetConfig,
    n_steps: int,
    n_streams: int,
    n_stream_groups: int = 1,
    dtype: torch.dtype = torch.float32,
    weight_dtype: torch.dtype | None = None,
    int8_matmul: bool = False,
    act_scales: tuple | None = None,
    sample_mode: str = "argmax",
    temperature: float = 1.0,
    seed: int = 0,
) -> torch.Tensor:
    """Generate ``n_steps`` codes per stream after priming with ``prime``
    ``[B, P]`` (``B <= n_streams * n_stream_groups``, ``P >=
    receptive_field + max dilation``).  Returns ``[B, n_steps]`` int32.

    ``weight_dtype=torch.int8``: int8 weights with per-column scales;
    ``int8_matmul``: int8 products too, with dynamic per-row activation
    scales or the static ``act_scales`` (one per layer).  Runs the CUDA
    kernel when ``prime`` lies on a CUDA device and its plain version
    (:func:`decode_reference`) when it lies on the CPU."""
    if prime.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {prime.device}")
    B = prime.shape[0]
    w, ring, s0, prev0 = prepare(
        params, prime, cfg=cfg, n_streams=n_streams, n_stream_groups=n_stream_groups,
        dtype=dtype, weight_dtype=weight_dtype, int8_matmul=int8_matmul,
        act_scales=act_scales, sample_mode=sample_mode, temperature=temperature, seed=seed,
    )
    kw = dict(cfg=cfg, n_steps=n_steps, dtype=dtype, int8_matmul=int8_matmul,
              sample_mode=sample_mode, temperature=temperature, seed=seed)
    if prime.device.type == "cuda":
        out = decode_cuda(w, ring, s0, prev0, n_streams=n_streams, **kw)
    else:
        out = decode_reference(w, ring, s0, prev0, **kw)
    return out[:B]
