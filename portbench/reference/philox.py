"""Philox4x32-10 and the Gumbel noise of categorical decoding.

Written from Random123's description (Salmon et al. 2011, constants as
``ATen/core/PhiloxRNGEngine.h``), kept here so that the check recomputes
every draw of a categorical decode itself.  The draw of logit ``4*j + m``
of stream row ``r`` at decode step ``t`` is word ``m`` of
``philox4x32((j, t, 0, 0), (seed, r))``, mapped to [0, 1) by the mantissa
trick ``float(0x3F800000 | bits >> 9) - 1``; the noise is ``-log(-log(u +
1e-20) + 1e-20)``.

32-bit words are held in int64 tensors; the 32x32 -> 64-bit products are
split into 16-bit halves so that nothing overflows.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    p_lo = m * (a & 0xFFFF)
    p_hi = m * (a >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK
    return hi, lo


def philox4x32(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of counters ``[..., 4]`` under keys ``[..., 2]``."""
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


def gumbel(seed: int, rows: torch.Tensor, steps: torch.Tensor, q: int) -> torch.Tensor:
    """Noise ``[n, q]`` of ``n`` draws: draw ``i`` is of row ``rows[i]`` at
    decode step ``steps[i]``, all under ``seed``."""
    j = torch.arange(q // 4, dtype=torch.int64, device=rows.device)
    n = rows.shape[0]
    ctr = torch.stack([j[None].expand(n, -1), steps.to(torch.int64)[:, None].expand(-1, q // 4),
                       torch.zeros((n, q // 4), dtype=torch.int64, device=rows.device),
                       torch.zeros((n, q // 4), dtype=torch.int64, device=rows.device)], dim=-1)
    key = torch.stack([torch.full_like(rows, seed & _MASK, dtype=torch.int64),
                       rows.to(torch.int64)], dim=-1)
    bits = philox4x32(ctr, key[:, None]).reshape(n, q)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)
