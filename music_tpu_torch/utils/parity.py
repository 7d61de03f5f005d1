"""Tie-aware token parity between a decode and a plain teacher-forced model.

On random weights many steps have near-tied top logits.  A different
summation order (kernel vs plain loop, torch vs XLA) may flip such a tie,
and after one flip autoregression makes two token streams diverge, so
plain token equality would fail a correct decoder.  Instead the candidate
tokens are fed, teacher-forced, through the plain model, and every
candidate token must score within ``tol`` of the plain model's best score
at its step.
"""

from __future__ import annotations

import numpy as np
import torch

from music_tpu_torch.kernels import wavenet_ae_decode, wavenet_decode
from music_tpu_torch.models import wavenet_ae
from music_tpu_torch.models.wavenet import WaveNetConfig, forward
from music_tpu_torch.ops.conv import full_fp32
from music_tpu_torch.ops.philox import decode_uniforms, gumbel


def tie_aware_check(tokens, logits_fn, tol: float) -> dict:
    """Check ``tokens [B, n]`` against ``logits_fn(tokens) -> [B, n, Q]``,
    the plain model's scores for each token given the tokens before it.

    Returns ``{"ok", "n", "exact", "min_margin"}``: ``exact`` counts steps
    where the token is the plain argmax, ``min_margin`` is the smallest
    ``score[token] - max(score)`` (0 when every token is the argmax), and
    ``ok`` is ``min_margin >= -tol``."""
    if isinstance(tokens, torch.Tensor):
        toks = tokens.detach().cpu().numpy().astype(np.int64)
    else:
        toks = np.asarray(tokens, dtype=np.int64)
    scores = logits_fn(tokens)
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().float().cpu().numpy()
    scores = np.asarray(scores, dtype=np.float32)
    if scores.shape[:2] != toks.shape:
        raise ValueError(f"scores {scores.shape} do not match tokens {toks.shape}")
    picked = np.take_along_axis(scores, toks[..., None], axis=-1)[..., 0]
    margin = picked - scores.max(axis=-1)
    exact = int((scores.argmax(axis=-1) == toks).sum())
    min_margin = float(margin.min()) if margin.size else 0.0
    return {"ok": bool(min_margin >= -tol), "n": int(toks.size), "exact": exact,
            "min_margin": min_margin}


@torch.no_grad()
def teacher_forced_scores(
    params: dict, prime: torch.Tensor, tokens: torch.Tensor, cfg: WaveNetConfig, *,
    sample_mode: str = "argmax", temperature: float = 1.0, seed: int = 0,
) -> torch.Tensor:
    """Scores ``[B, n, Q]`` the plain model gives each of ``tokens [B, n]``
    after ``prime [B, P]`` and the tokens before it, by one parallel
    forward in full float32.  In categorical mode they carry the fused
    decode's Philox Gumbel noise (token ``k`` of row ``r``: counter ``k``,
    key ``(seed, r)``), so the scores' argmax is the token the decode
    should draw."""
    P = prime.shape[1]
    seq = torch.cat([prime.long(), tokens[:, :-1].long().to(prime.device)], dim=1)
    p32 = {k: v.float() for k, v in params.items()}
    with full_fp32():
        logits = forward(p32, seq[:, P - cfg.receptive_field:], cfg)  # [B, n, Q]
    return with_decode_noise(logits, 0, sample_mode, temperature, seed)


def reference_scores(
    inputs: tuple, tokens: torch.Tensor, cfg: WaveNetConfig, *, dtype: torch.dtype,
    sample_mode: str = "argmax", temperature: float = 1.0, seed: int = 0,
    kernel=wavenet_decode, **options,
) -> torch.Tensor:
    """Scores ``[B, n - 1, Q]`` the kernel's plain version
    (``kernel.decode_reference``: :mod:`~music_tpu_torch.kernels.wavenet_decode`'s
    by default, or :mod:`~music_tpu_torch.kernels.wavenet_decode_hbm`'s with
    its ``options`` such as ``int8_matmul``; with its ``dtype`` rounding
    points) gives ``tokens[:, 1:]``, teacher-forced from the kernel inputs
    ``inputs = (weights, ring, s0, prev0)``; with the same Philox noise as
    the decode in categorical mode."""
    logits = kernel.decode_reference(*inputs, cfg=cfg, n_steps=tokens.shape[1], dtype=dtype,
                                     forced=tokens, **options)
    return with_decode_noise(logits, 1, sample_mode, temperature, seed)


@torch.no_grad()
def ae_teacher_forced_scores(
    params: dict, encoding: torch.Tensor, prime: torch.Tensor, tokens: torch.Tensor,
    cfg: wavenet_ae.WaveNetAEConfig, *, pos_offset: int | torch.Tensor = 0,
) -> torch.Tensor:
    """Logits ``[B, n, Q]`` the plain autoencoder decoder gives each of
    ``tokens [B, n]`` after ``prime [B, P]`` and the tokens before it,
    conditioned by ``encoding [B, F, W]``: one parallel forward in full
    float32 on the fused decode's absolute-time clock (``pos_offset`` is
    the time of ``prime[:, 0]``; the token at time ``t`` is consumed under
    frame ``min(t // pool, F - 1)``), not the ratio-based upsample of
    :func:`~music_tpu_torch.models.wavenet_ae.forward`."""
    P, rf = prime.shape[1], cfg.receptive_field
    seq = torch.cat([prime.long(), tokens[:, :-1].long().to(prime.device)], dim=1)
    start = torch.as_tensor(pos_offset, device=prime.device).reshape(-1) + (P - rf)
    p32 = {k: v.float() for k, v in params.items()}
    with full_fp32():
        return wavenet_ae.decode(p32, seq[:, P - rf:], encoding.float(), cfg,
                                 tokens.shape[1], start=start)


def ae_reference_scores(inputs: tuple, tokens: torch.Tensor, cfg: wavenet_ae.WaveNetAEConfig,
                        *, dtype: torch.dtype, kernel=wavenet_ae_decode) -> torch.Tensor:
    """Logits ``[B, n - 1, Q]`` the AE kernel's plain version
    (``kernel.decode_reference``: :mod:`~music_tpu_torch.kernels.wavenet_ae_decode`'s
    or :mod:`~music_tpu_torch.kernels.wavenet_ae_decode_hbm`'s, with its
    ``dtype`` rounding points) gives ``tokens[:, 1:]``, teacher-forced from
    the kernel inputs ``inputs`` (as ``kernel.prepare`` returns them)."""
    return kernel.decode_reference(*inputs, cfg=cfg, n_steps=tokens.shape[1], dtype=dtype,
                                   forced=tokens)


def with_decode_noise(logits, first_step, sample_mode, temperature, seed):
    """``logits [B, n, Q]`` of tokens ``first_step ..`` (a torch tensor),
    plus the fused decode's Gumbel noise in categorical mode: their argmax
    is the token the decode draws."""
    if sample_mode == "argmax":
        return logits
    B, n, q = logits.shape
    rows = torch.arange(B, device=logits.device)
    noise = torch.stack(
        [gumbel(decode_uniforms(seed, rows, first_step + k, q)) for k in range(n)], dim=1
    )
    return logits / temperature + noise
