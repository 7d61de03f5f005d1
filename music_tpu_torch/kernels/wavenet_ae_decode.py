"""Fused conditioned decode of the WaveNet autoencoder: one CUDA launch
for the whole loop.

Counterpart of :mod:`music_tpu.kernels.wavenet_ae_decode` (the Pallas
kernel ``_ae_kernel_wrapper`` and its wrapper ``generate_tokens_fused``).
The kernel is ``csrc/wavenet_ae_decode.cu``; :func:`decode_reference` is
its plain PyTorch version, with the same weight packs, ring layout,
conditioning tables and bf16 rounding points.

It is the WaveNet decode of :mod:`.wavenet_decode` (same packs and ring
layout) plus three things:

- **Conditioning**: per-stream, per-frame bias tables ``cond_fg [B, F,
  L*2Cd]`` (``encoding @ cond_fg``, layer-major) and ``cond_post [B, F,
  Cs]``, computed in float32 and stored in the working dtype.  Layer ``i``
  adds ``cond_fg[b, frame, i*2Cd : (i+1)*2Cd]`` to its filter/gate
  pre-activation; the post stack adds ``cond_post[b, frame]`` after
  ``post1``.
- **Per-stream clocks**: stream ``b`` at step ``t`` consumes the token at
  absolute time ``pos0[b] + t`` (``pos0 = pos_offset + P``) and takes frame
  ``min((pos0[b] + t) // pool, F - 1)``.
- **The swapped gate**: ``tanh(fg[:, Cd:]) * sigmoid(fg[:, :Cd])``.

Argmax only (the TPU kernel has no sampling); float32 or bfloat16.
"""

from __future__ import annotations

import ctypes

import torch

from music_tpu_torch.kernels import _build
from music_tpu_torch.kernels.wavenet_decode import (
    ARGTYPES, SMEM_LIMIT, SUPPORTED_STREAMS, chain_packs, check_aligned, check_tile, fits,
    launch_args, ring_offsets, smem_layout,
)
from music_tpu_torch.models.wavenet_ae import WaveNetAEConfig, cond_tables, frame_of, gate
from music_tpu_torch.ops.conv import conv1x1, dilated_causal_conv, full_fp32, token_causal_conv

LAUNCHES = 0
"""Kernel launches so far in this process (the CUDA wrapper adds one per
launch; the CPU path never does)."""

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def max_streams(cfg: WaveNetAEConfig, dtype: torch.dtype = torch.float32,
                min_stages: int = 2) -> int:
    """The most streams per block (of :data:`SUPPORTED_STREAMS`) whose
    carve (:func:`.wavenet_decode.smem_layout` with the conditioning rows
    in its stages) fits :data:`SMEM_LIMIT` in ``dtype`` with at least
    ``min_stages`` stages; 0 when none does."""
    dims = (cfg.n_blocks, cfg.de_residual_channel, cfg.de_dilation_channel,
            cfg.de_skip_channel, cfg.quantization_channel)
    return max((s for s in SUPPORTED_STREAMS
                if fits(smem_layout(*dims, s, dtype, ae=True), min_stages)), default=0)


def _check_supported(cfg: WaveNetAEConfig) -> None:
    if cfg.filter_width != 2:
        raise NotImplementedError("fused decode assumes filter_width=2")


def _build_kernel_weights(params: dict, cfg: WaveNetAEConfig, dtype: torch.dtype) -> dict:
    """Repack the decoder parameters into the kernel's layouts (those of
    :func:`.wavenet_decode._build_kernel_weights`), contiguous, in the
    working dtype."""
    L, Cr, Cd, Cs = (
        cfg.n_blocks, cfg.de_residual_channel, cfg.de_dilation_channel, cfg.de_skip_channel,
    )
    w = {
        "ecur": params["de_causal"][1],
        "eprev": params["de_causal"][0],
        "fg": params["fg"].reshape(L, 2 * Cr, 2 * Cd),
        "dense": params["dense"],
        "skip": params["skip"].reshape(L * Cd, Cs),
        "post1": params["conn1"],
        "post2": params["conn2"],
    }
    return {k: v.to(dtype).contiguous() for k, v in w.items()}


def build_cond_tables(params: dict, encoding: torch.Tensor, cfg: WaveNetAEConfig,
                      dtype: torch.dtype):
    """The kernel's tables ``cond_fg [B, F, L*2Cd]`` and ``cond_post [B, F,
    Cs]``: products in float32, then cast to ``dtype``."""
    B, F, _ = encoding.shape
    p32 = {k: params[k].float() for k in ("cond_fg", "cond_post")}
    with full_fp32():
        cond_fg, cond_post = cond_tables(p32, encoding.float(), cfg)
    return (cond_fg.reshape(B, F, -1).to(dtype).contiguous(),
            cond_post.to(dtype).contiguous())


@torch.no_grad()
def _collect_prime_state(params: dict, prime: torch.Tensor, encoding: torch.Tensor,
                         cfg: WaveNetAEConfig, pos_offset: torch.Tensor):
    """Parallel conditioned prime: a conv forward over the prime fills the
    rings and draws the first token.

    ``pos_offset [B]``: absolute time of ``prime[:, 0]`` per stream.  A
    position at absolute time ``t`` is conditioned by frame ``min(t //
    pool, F - 1)``, as in the kernel.  Returns ``(ring [B, sum(d), Cr]
    float32, s0 [B] int32, prev0 [B] int32)``: entering kernel step 0, row
    ``s`` of layer ``i``'s ring holds its input at prime time ``P - d_i +
    s``; ``s0`` is the argmax after the prime, conditioned by the frame of
    time ``pos_offset + P - 1``.  Needs ``P >= receptive_field + max(d)``.
    """
    B, P = prime.shape
    need = cfg.receptive_field + max(cfg.dilations)
    if P < need:
        raise ValueError(f"prime length {P} < receptive_field + max_dilation = {need}")
    Cd, Cs, pool = cfg.de_dilation_channel, cfg.de_skip_channel, cfg.en_pool_kernel_size
    F = encoding.shape[1]
    offs, ring_len = ring_offsets(cfg)
    p32 = {k: v.float() for k, v in params.items()}
    enc = encoding.float()
    ring = torch.empty((B, ring_len, cfg.de_residual_channel), dtype=torch.float32,
                       device=prime.device)
    rows = torch.arange(B, device=prime.device)
    z_last = []  # each layer's gated activation at prime time P - 1
    with full_fp32():
        x = token_causal_conv(prime, p32["de_causal"])  # index j is prime time j + 1
        o = 1
        for i, d in enumerate(cfg.dilations):
            ring[:, offs[i] : offs[i] + d] = x[:, P - d - o : P - o]
            fg = dilated_causal_conv(x, p32["fg"][i], dilation=d)
            o += d
            t = pos_offset[:, None] + o + torch.arange(fg.shape[1], device=prime.device)
            proj = enc @ p32["cond_fg"][i]  # [B, F, 2Cd]
            z = gate(fg + proj[rows[:, None], frame_of(t, pool, F)], Cd)
            z_last.append(z[:, P - 1 - o])
            x = conv1x1(z, p32["dense"][i]) + x[:, -fg.shape[1]:]
        h = torch.relu(torch.cat(z_last, dim=-1) @ p32["skip"].reshape(-1, Cs))
        frame = frame_of(pos_offset + P - 1, pool, F)
        h = torch.relu(h @ p32["conn1"] + enc[rows, frame] @ p32["cond_post"])
        logits = h @ p32["conn2"]
    s0 = torch.argmax(logits, dim=-1).to(torch.int32)
    return ring, s0, prime[:, -1].to(torch.int32)


def prepare(
    params: dict, encoding: torch.Tensor, prime: torch.Tensor, *, cfg: WaveNetAEConfig,
    n_streams: int, n_stream_groups: int = 1, dtype: torch.dtype = torch.float32,
    pos_offset: int | torch.Tensor = 0,
):
    """Pad the rows to ``n_streams * n_stream_groups`` with copies of the
    last row (prime, encoding and clock) and build the kernel inputs
    ``(weights, ring, s0, prev0, cond_fg, cond_post, pos0)``."""
    _check_supported(cfg)
    B, P = prime.shape
    total = n_streams * n_stream_groups
    if B > total:
        raise ValueError(f"at most {total} streams, got {B}")
    if encoding.shape[0] != B:
        raise ValueError(f"encoding has {encoding.shape[0]} rows, prime {B}")
    pos = torch.as_tensor(pos_offset, dtype=torch.int64, device=prime.device).reshape(-1)
    pos = pos.expand(B).clone()
    if B < total:
        pad = total - B
        prime = torch.cat([prime, prime[-1:].expand(pad, -1)], dim=0)
        encoding = torch.cat([encoding, encoding[-1:].expand(pad, -1, -1)], dim=0)
        pos = torch.cat([pos, pos[-1:].expand(pad)])
    ring, s0, prev0 = _collect_prime_state(params, prime, encoding, cfg, pos)
    cond_fg, cond_post = build_cond_tables(params, encoding, cfg, dtype)
    pos0 = (pos + P).to(torch.int32)
    return _build_kernel_weights(params, cfg, dtype), ring, s0, prev0, cond_fg, cond_post, pos0


@torch.no_grad()
def decode_reference(
    w: dict, ring: torch.Tensor, s0: torch.Tensor, prev0: torch.Tensor,
    cond_fg: torch.Tensor, cond_post: torch.Tensor, pos0: torch.Tensor, *,
    cfg: WaveNetAEConfig, n_steps: int, dtype: torch.dtype = torch.float32,
    forced: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the CUDA kernel, on any device.

    Products accumulate in float32; with ``dtype=bfloat16`` the weights,
    rings and tables hold bf16 and activations are rounded to bf16 where
    the TPU kernel rounds them: after the embedding sum, z, the residual
    add, and h after each relu.  Logits stay float32.  Returns ``[B,
    n_steps]`` int32 ``[s0, s1, ...]``.

    With ``forced`` (``[B, n_steps]`` tokens, e.g. the kernel's output) the
    loop feeds those tokens instead of its own (teacher forcing) and
    returns the float32 logits ``[B, n_steps - 1, Q]`` it gave tokens
    ``1 .. n_steps - 1``.
    """
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
    wf = {k: v.float() for k, v in w.items()}
    cfg_tab = cond_fg.float().reshape(B, F, cfg.n_blocks, 2 * Cd)
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
            cond = cfg_tab[rows, frame]  # [B, L, 2Cd]
            x = rnd(wf["ecur"][cur] + wf["eprev"][prev])
            zs = []
            for i, d in enumerate(cfg.dilations):
                slot = offs[i] + t % d
                fg = torch.cat([ring[:, slot].float(), x], dim=-1) @ wf["fg"][i] + cond[:, i]
                ring[:, slot] = x.to(dtype)  # after the read of the same slot
                z = rnd(gate(fg, Cd))
                x = rnd(x + z @ wf["dense"][i])
                zs.append(z)
            h = rnd(torch.relu(torch.cat(zs, dim=-1) @ wf["skip"]))
            h = rnd(torch.relu(h @ wf["post1"] + post_tab[rows, frame]))
            logits = h @ wf["post2"]
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


# B1's arguments up to the pointers, then n_steps and the stream (argmax only)
_ARGTYPES = (*ARGTYPES[:7], ctypes.c_int, ctypes.c_void_p)


def _library() -> ctypes.CDLL:
    lib = _build.load("wavenet_ae_decode")
    lib.wavenet_ae_decode.argtypes = _ARGTYPES
    lib.wavenet_ae_decode.restype = ctypes.c_int
    lib.wavenet_ae_decode_error.argtypes = [ctypes.c_int]
    lib.wavenet_ae_decode_error.restype = ctypes.c_char_p
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
    _check_supported(cfg)
    L, Cr, Cd, Cs, Q = (
        cfg.n_blocks, cfg.de_residual_channel, cfg.de_dilation_channel,
        cfg.de_skip_channel, cfg.quantization_channel,
    )
    _, ring_len = ring_offsets(cfg)
    B, F = ring.shape[0], cond_fg.shape[1]
    if n_streams not in SUPPORTED_STREAMS or B % n_streams:
        raise ValueError(f"{B} rows do not split into blocks of n_streams={n_streams} "
                         f"(supported: {SUPPORTED_STREAMS})")
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype}")
    offsets, nbytes = check_tile((L, Cr, Cd, Cs, Q), n_streams, dtype, ae=True)
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    device = ring.device
    if device.type != "cuda":
        raise ValueError(f"decode_cuda needs CUDA tensors, got {device}")
    shapes = {
        "ecur": (Q, Cr), "eprev": (Q, Cr), "fg": (L, 2 * Cr, 2 * Cd), "dense": (L, Cd, Cr),
        "skip": (L * Cd, Cs), "post1": (Cs, Cs), "post2": (Cs, Q),
    }
    tensors = {f"weight {k}": (w[k], shape) for k, shape in shapes.items()}
    tensors["cond_fg"] = (cond_fg, (B, F, L * 2 * Cd))
    tensors["cond_post"] = (cond_post, (B, F, Cs))
    for name, (t, shape) in tensors.items():
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if F < 1:
        raise ValueError("need at least one encoding frame")
    if tuple(ring.shape) != (B, ring_len, Cr):
        raise ValueError(f"ring shape {tuple(ring.shape)} != {(B, ring_len, Cr)}")
    for name, t in (("s0", s0), ("prev0", prev0), ("pos0", pos0)):
        if t.device != device or t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name}: need int32 [{B}] on {device}")
    if int(pos0.min()) < 0 or int(pos0.max()) + n_steps >= 2**31:
        raise ValueError("clock pos0 + n_steps must stay within [0, 2**31)")
    ring = ring.to(dtype=dtype, copy=True).contiguous()  # the kernel updates it in place
    ptrs = {k: w[k] for k in shapes}
    ptrs["fg"], ptrs["dense"] = chain_packs(w["fg"], w["dense"])
    check_aligned({**ptrs, "cond_fg": cond_fg, "cond_post": cond_post, "ring": ring})
    ptrs.update(ring=ring, s0=s0.contiguous(), prev0=prev0.contiguous(), pos0=pos0.contiguous(),
                cond_fg=cond_fg, cond_post=cond_post,
                dil=torch.tensor(cfg.dilations, dtype=torch.int32, device=device),
                out=torch.empty((B, n_steps), dtype=torch.int32, device=device))
    dims_a, offs_a, ptrs_a = launch_args(
        [L, Cr, Cd, Cs, Q, ring_len, F, cfg.en_pool_kernel_size], offsets, ptrs)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.wavenet_ae_decode(_DTYPES[dtype], n_streams, B // n_streams, dims_a, offs_a,
                                   nbytes, ptrs_a, n_steps, stream)
    if rc != 0:
        raise RuntimeError(
            f"wavenet_ae_decode launch failed: {lib.wavenet_ae_decode_error(rc).decode()}")
    LAUNCHES += 1
    return ptrs["out"]


def generate_tokens_fused(
    params: dict,
    encoding: torch.Tensor,
    prime: torch.Tensor,
    *,
    cfg: WaveNetAEConfig,
    n_steps: int,
    n_streams: int,
    n_stream_groups: int = 1,
    dtype: torch.dtype = torch.float32,
    pos_offset: int | torch.Tensor = 0,
) -> torch.Tensor:
    """Conditioned fused decode: ``n_steps`` codes per stream after priming
    with ``prime [B, P]`` (``B <= n_streams * n_stream_groups``, ``P >=
    receptive_field + max dilation``), conditioned by ``encoding [B, F,
    W]``.  ``pos_offset`` (an int or a ``[B]`` vector) is the absolute
    time of ``prime[:, 0]``, so step ``t`` of stream ``b`` takes frame
    ``min((pos_offset[b] + P + t) // pool, F - 1)``.  Returns ``[B,
    n_steps]`` int32.

    Runs the CUDA kernel when ``prime`` lies on a CUDA device and its
    plain version (:func:`decode_reference`) when it lies on the CPU."""
    B = prime.shape[0]
    if prime.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {prime.device}")
    inputs = prepare(params, encoding, prime, cfg=cfg, n_streams=n_streams,
                     n_stream_groups=n_stream_groups, dtype=dtype, pos_offset=pos_offset)
    kw = dict(cfg=cfg, n_steps=n_steps, dtype=dtype)
    if prime.device.type == "cuda":
        out = decode_cuda(*inputs, n_streams=n_streams, **kw)
    else:
        out = decode_reference(*inputs, **kw)
    return out[:B]
