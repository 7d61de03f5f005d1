"""Philox4x32-10 counter-based generator on int64 tensors.

Counterpart of the TPU kernel's in-kernel ``pltpu.prng_*`` draws
(``music_tpu/kernels/wavenet_decode.py`` ``sample``).  The CUDA decode
kernel (``csrc/wavenet_decode.cu``) runs the same generator, so the kernel
and its plain version see the same uniforms bit for bit.  Constants are
Random123's (also ``ATen/core/PhiloxRNGEngine.h``).

Each 32-bit word is held in an int64 tensor; the 32x32 -> 64-bit products
are split into 16-bit halves so nothing overflows int64.

Decode draws: key ``(seed, stream row)``, counter ``(lane block, step, 0,
0)``, one call giving the uniforms of four consecutive logits.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``m * a`` for a 32-bit constant ``m``."""
    p_lo = m * (a & 0xFFFF)  # < 2**48
    p_hi = m * (a >> 16)     # < 2**48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK
    return hi, lo


def philox4x32(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10.  ``ctr``: ``[..., 4]``, ``key``: ``[..., 2]`` int64
    tensors holding 32-bit words (broadcast together).  Returns ``[..., 4]``."""
    c0, c1, c2, c3 = (ctr[..., i].to(torch.int64) & _MASK for i in range(4))
    k0, k1 = (key[..., i].to(torch.int64) & _MASK for i in range(2))
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1) by the mantissa trick the TPU
    kernel uses: ``float(0x3F800000 | bits >> 9) - 1``."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def decode_uniforms(seed: int, rows: torch.Tensor, step: int, q: int) -> torch.Tensor:
    """Uniforms ``[len(rows), q]`` for decode step ``step`` (``q % 4 == 0``):
    logit ``4*j + m`` of stream row ``r`` takes word ``m`` of
    ``philox4x32((j, step, 0, 0), (seed, r))``."""
    if q % 4:
        raise ValueError(f"q={q} must be a multiple of 4")
    device = rows.device
    j = torch.arange(q // 4, dtype=torch.int64, device=device)
    ctr = torch.stack(
        [j, torch.full_like(j, step), torch.zeros_like(j), torch.zeros_like(j)], dim=-1
    )  # [q/4, 4]
    r = rows.to(torch.int64)
    key = torch.stack([torch.full_like(r, seed & _MASK), r], dim=-1)  # [B, 2]
    bits = philox4x32(ctr[None], key[:, None])  # [B, q/4, 4]
    return bits_to_uniform(bits.reshape(r.shape[0], q))


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms, as the TPU kernel forms it."""
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)
