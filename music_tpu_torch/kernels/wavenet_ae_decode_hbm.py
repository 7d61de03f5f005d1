"""Weight-streaming conditioned decode of the WaveNet autoencoder: one CUDA
launch for the whole loop, for decoders too large for
:mod:`.wavenet_ae_decode`'s kernel, with int8 weights.

Counterpart of :mod:`music_tpu.kernels.wavenet_ae_decode_hbm` (the Pallas
kernel ``_ae_kernel_hbm`` and its wrapper ``generate_tokens_fused_hbm``).
The kernel is ``csrc/wavenet_ae_decode_hbm.cu``: weights in the working
dtype (mode 0) on the resident body with per-layer skip
(``csrc/decode_resident.cuh``), int8 weights (mode 1) on
``csrc/decode_hbm.cuh``; :func:`decode_reference` is its plain PyTorch
version.

It is :mod:`.wavenet_decode_hbm`'s decode (per-layer skip accumulation,
the packs of :func:`.wavenet_decode_hbm.pack_weights`, int8 weight-only
mode) with the conditioning of :mod:`.wavenet_ae_decode`:

- the tables ``cond_fg [B, F, L*2Cd]`` and ``cond_post [B, F, Cs]`` in the
  working dtype (the int8 mode leaves them so: they are activations);
- per-stream clocks: stream ``b`` at step ``t`` takes frame ``min((pos0[b]
  + t) // pool, F - 1)``.  The TPU kernel's per-stream path rebases each
  stream's table column and stages frame rows ``w`` and ``w + 1`` in VMEM;
  that reaches the same frame, so the port keeps the tables in device
  memory and ports the clock;
- ``fg = (tap @ Wprev + x @ Wcur) * scale + cond_fg[b, frame, i]`` (the
  int8 scale before the bias), the swapped gate ``tanh(fg[Cd:]) *
  sigmoid(fg[:Cd])``, and ``h2 = relu(h @ post1 * scale + cond_post[b,
  frame])``.

Argmax only; float32 or bfloat16; weights in the working dtype or int8.
"""

from __future__ import annotations

import ctypes

import torch

from music_tpu_torch.kernels import _build, wavenet_ae_decode
from music_tpu_torch.kernels.wavenet_decode import ring_offsets
from music_tpu_torch.kernels.wavenet_decode_hbm import (
    ARGTYPES, SMEM_LIMIT, WEIGHT_KEYS, check_kernel_inputs, col_scaled, dequantize, launch,
    pack_weights, smem_layout, streams_of, with_chain_packs,
)
from music_tpu_torch.models.wavenet_ae import WaveNetAEConfig, frame_of, gate
from music_tpu_torch.ops.conv import full_fp32

LAUNCHES = 0
"""Kernel launches so far in this process (the CUDA wrapper adds one per
launch; the CPU path never does)."""

DECODER_KEYS = ("de_causal", "fg", "dense", "skip", "conn1", "conn2")
"""The parameters that enter the kernel (the encoder and the conditioning
projections do not: the tables are built on the host)."""


def max_streams(cfg: WaveNetAEConfig, dtype: torch.dtype = torch.float32, mode: int = 0) -> int:
    """The most streams per block whose carve
    (:func:`.wavenet_decode_hbm.smem_layout` with the conditioning rows in
    mode 0's stages) fits :data:`SMEM_LIMIT` in ``mode`` (0 working dtype
    ``dtype``, 1 int8 weights); 0 when none does."""
    dims = (cfg.n_blocks, cfg.de_residual_channel, cfg.de_dilation_channel,
            cfg.de_skip_channel, cfg.quantization_channel)
    return max((s for s in streams_of(mode)
                if smem_layout(*dims, s, dtype, mode, ae=True)[1] <= SMEM_LIMIT), default=0)


def _build_hbm_weights(params: dict, cfg: WaveNetAEConfig, dtype: torch.dtype = torch.float32,
                       weight_dtype: torch.dtype | None = None) -> dict:
    """The decoder's packs (:func:`.wavenet_decode_hbm.pack_weights`)."""
    L, Cr, Cd = cfg.n_blocks, cfg.de_residual_channel, cfg.de_dilation_channel
    w32 = {
        "ecur": params["de_causal"][1], "eprev": params["de_causal"][0],
        "fg": params["fg"].float().reshape(L, 2 * Cr, 2 * Cd),
        "dense": params["dense"], "skip": params["skip"],
        "post1": params["conn1"], "post2": params["conn2"],
    }
    return pack_weights(w32, dtype, weight_dtype)


def dequantized_params(params: dict, cfg: WaveNetAEConfig) -> dict:
    """The parameters the ``weight_dtype=torch.int8`` kernel computes with:
    the decoder packs (fg, dense, skip, conn1, conn2) quantized and
    dequantized; the embeddings, the encoder and the conditioning
    projections unchanged.  The AE step loop on them is the exact reference
    of the int8 kernel."""
    L, Cr, Cd = cfg.n_blocks, cfg.de_residual_channel, cfg.de_dilation_channel
    dq = dequantize(_build_hbm_weights(params, cfg, weight_dtype=torch.int8))
    return dict(params, fg=dq["fg"].reshape(L, 2, Cr, 2 * Cd), dense=dq["dense"],
                skip=dq["skip"], conn1=dq["post1"], conn2=dq["post2"])


def prepare(
    params: dict, encoding: torch.Tensor, prime: torch.Tensor, *, cfg: WaveNetAEConfig,
    n_streams: int, n_stream_groups: int = 1, dtype: torch.dtype = torch.float32,
    weight_dtype: torch.dtype | None = None, pos_offset: int | torch.Tensor = 0,
):
    """Pad the rows to ``n_streams * n_stream_groups`` with copies of the
    last row (prime, encoding and clock) and build the kernel inputs
    ``(weights, ring, s0, prev0, cond_fg, cond_post, pos0)``; the prime
    state and the tables are :mod:`.wavenet_ae_decode`'s.  In the working
    dtype the weights also hold the chain packs that mode 0 stages
    (:func:`.wavenet_decode_hbm.with_chain_packs`)."""
    _, *state = wavenet_ae_decode.prepare(
        params, encoding, prime, cfg=cfg, n_streams=n_streams,
        n_stream_groups=n_stream_groups, dtype=dtype, pos_offset=pos_offset,
    )
    return (with_chain_packs(_build_hbm_weights(params, cfg, dtype, weight_dtype)), *state)


@torch.no_grad()
def decode_reference(
    w: dict, ring: torch.Tensor, s0: torch.Tensor, prev0: torch.Tensor,
    cond_fg: torch.Tensor, cond_post: torch.Tensor, pos0: torch.Tensor, *,
    cfg: WaveNetAEConfig, n_steps: int, dtype: torch.dtype = torch.float32,
    forced: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the CUDA kernel, on any device: products in
    float32, int8 scales after each product and before the conditioning
    bias, bf16 rounding after the embedding sum, z, the residual add, h and
    h2.  Returns ``[B, n_steps]`` int32; with ``forced`` the float32 logits
    ``[B, n_steps - 1, Q]`` of tokens ``1 ..`` fed those tokens."""
    Cd, F, pool = cfg.de_dilation_channel, cond_fg.shape[1], cfg.en_pool_kernel_size
    if dtype == torch.bfloat16:
        def rnd(v):
            return v.to(torch.bfloat16).float()
    else:
        def rnd(v):
            return v
    offs, _ = ring_offsets(cfg)
    B = ring.shape[0]
    ring = ring.to(dtype=dtype, copy=True)
    wf = {k: w[k].float() for k in ("ecur", "eprev", *WEIGHT_KEYS)}
    fg_tab = cond_fg.float().reshape(B, F, cfg.n_blocks, 2 * Cd)
    post_tab = cond_post.float()
    rows = torch.arange(B, device=ring.device)
    pos0 = pos0.to(ring.device, torch.int64)
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
    with full_fp32():
        for t in range(n_steps - 1):
            frame = frame_of(pos0 + t, pool, F)
            cond = fg_tab[rows, frame]  # [B, L, 2Cd]
            x = rnd(wf["ecur"][cur] + wf["eprev"][prev])
            skip_acc = torch.zeros((B, cfg.de_skip_channel), device=ring.device)
            for i, d in enumerate(cfg.dilations):
                slot = offs[i] + t % d
                tap = ring[:, slot].to(torch.float32, copy=True)  # the slot is overwritten next
                ring[:, slot] = x.to(dtype)  # after the read of the same slot
                fg = col_scaled(w, torch.cat([tap, x], dim=-1) @ wf["fg"][i], "fg", i)
                fg = fg + cond[:, i]  # the int8 scale before the bias
                z = rnd(gate(fg, Cd))
                x = rnd(x + col_scaled(w, z @ wf["dense"][i], "dense", i))
                skip_acc = skip_acc + col_scaled(w, z @ wf["skip"][i], "skip", i)
            h = rnd(torch.relu(skip_acc))
            h2 = rnd(torch.relu(col_scaled(w, h @ wf["post1"], "post1") + post_tab[rows, frame]))
            logits = col_scaled(w, h2 @ wf["post2"], "post2")
            if forced is None:
                nxt = torch.argmax(logits, dim=-1)
                out[:, t + 1] = nxt.to(torch.int32)
            else:
                all_logits.append(logits)
                nxt = forced[:, t + 1]
            prev, cur = cur, nxt
    if forced is not None:
        return torch.stack(all_logits, dim=1)
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("wavenet_ae_decode_hbm")
    lib.wavenet_ae_decode_hbm.argtypes = ARGTYPES
    lib.wavenet_ae_decode_hbm.restype = ctypes.c_int
    lib.wavenet_ae_decode_hbm_error.argtypes = [ctypes.c_int]
    lib.wavenet_ae_decode_hbm_error.restype = ctypes.c_char_p
    return lib


def decode_cuda(
    w: dict, ring: torch.Tensor, s0: torch.Tensor, prev0: torch.Tensor,
    cond_fg: torch.Tensor, cond_post: torch.Tensor, pos0: torch.Tensor, *,
    cfg: WaveNetAEConfig, n_steps: int, n_streams: int, dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (same arguments and
    result as :func:`decode_reference`).  Raises on anything it does not
    take, a tile larger than :func:`max_streams` included, and when the
    launch is refused."""
    global LAUNCHES
    wavenet_ae_decode._check_supported(cfg)
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    L, Cr, Cd, Cs, Q = (cfg.n_blocks, cfg.de_residual_channel, cfg.de_dilation_channel,
                        cfg.de_skip_channel, cfg.quantization_channel)
    if Q % 4:
        raise NotImplementedError("fused decode needs quantization_channel % 4 == 0")
    _, ring_len = ring_offsets(cfg)
    B, F = ring.shape[0], cond_fg.shape[1]
    if F < 1:
        raise ValueError("need at least one encoding frame")
    s0, prev0, pos0 = s0.contiguous(), prev0.contiguous(), pos0.contiguous()
    mode, offsets, nbytes = check_kernel_inputs(
        w, ring, {"s0": s0, "prev0": prev0, "pos0": pos0}, (L, Cr, Cd, Cs, Q, ring_len),
        n_streams, dtype, False,
        extra={"cond_fg": (cond_fg, (B, F, L * 2 * Cd)), "cond_post": (cond_post, (B, F, Cs))},
        ae=True)
    if int(pos0.min()) < 0 or int(pos0.max()) + n_steps >= 2**31:
        raise ValueError("clock pos0 + n_steps must stay within [0, 2**31)")
    device = ring.device
    ring = ring.to(dtype=dtype, copy=True).contiguous()  # the kernel updates it in place
    dil = torch.tensor(cfg.dilations, dtype=torch.int32, device=device)
    out = torch.empty((B, n_steps), dtype=torch.int32, device=device)
    lib = _library()
    rc = launch(lib.wavenet_ae_decode_hbm, dtype, mode, n_streams,
                (L, Cr, Cd, Cs, Q, ring_len, F, cfg.en_pool_kernel_size), offsets, nbytes,
                {**w, "dil": dil, "ring": ring, "s0": s0, "prev0": prev0, "pos0": pos0,
                 "cond_fg": cond_fg, "cond_post": cond_post, "out": out}, n_steps)
    if rc != 0:
        raise RuntimeError(f"wavenet_ae_decode_hbm launch failed: "
                           f"{lib.wavenet_ae_decode_hbm_error(rc).decode()}")
    LAUNCHES += 1
    return out


def generate_tokens_fused_hbm(
    params: dict,
    encoding: torch.Tensor,
    prime: torch.Tensor,
    *,
    cfg: WaveNetAEConfig,
    n_steps: int,
    n_streams: int,
    n_stream_groups: int = 1,
    dtype: torch.dtype = torch.float32,
    weight_dtype: torch.dtype | None = None,
    pos_offset: int | torch.Tensor = 0,
) -> torch.Tensor:
    """Conditioned weight-streaming decode: ``n_steps`` codes per stream
    after priming with ``prime [B, P]``, conditioned by ``encoding [B, F,
    W]``; ``pos_offset`` (an int or ``[B]``) is the absolute time of
    ``prime[:, 0]``.  ``weight_dtype=torch.int8`` takes int8 decoder
    weights.  Returns ``[B, n_steps]`` int32.

    Runs the CUDA kernel when ``prime`` lies on a CUDA device and its
    plain version (:func:`decode_reference`) when it lies on the CPU."""
    if prime.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {prime.device}")
    B = prime.shape[0]
    inputs = prepare(params, encoding, prime, cfg=cfg, n_streams=n_streams,
                     n_stream_groups=n_stream_groups, dtype=dtype, weight_dtype=weight_dtype,
                     pos_offset=pos_offset)
    kw = dict(cfg=cfg, n_steps=n_steps, dtype=dtype)
    if prime.device.type == "cuda":
        out = decode_cuda(*inputs, n_streams=n_streams, **kw)
    else:
        out = decode_reference(*inputs, **kw)
    return out[:B]
