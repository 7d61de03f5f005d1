"""WaveNet-autoencoder reconstruction entry points.

Counterpart of :mod:`music_tpu.generate.wavenet_ae_generate` (``generate``
and the single-device ``generate_batch``): µ-law encode the source clips,
encode them through the bottleneck, prime with the first
``receptive_field + max(d)`` codes of each source, decode the
reconstruction in one call (one kernel launch on a CUDA device, the
kernel's plain version on the CPU), µ-law decode and write 16-bit PCM wavs.

Which kernel decodes is
:func:`~music_tpu_torch.generate.wavenet_generate.streams_weights`'s rule:
:mod:`music_tpu_torch.kernels.wavenet_ae_decode` while its carve holds the
tile the clips need with its helper warp, else the weight-streaming
:mod:`music_tpu_torch.kernels.wavenet_ae_decode_hbm` when its carve holds
more.  The shipped decoder stays resident at any count; a scaled decoder
(Cr = Cd = 64, Cs = 1024) goes to the weight-streaming kernel in float32.
music_tpu's ``plan_ae_serving`` routes by VMEM instead.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from music_tpu_torch.core import checkpoint as ckpt_lib
from music_tpu_torch.data import wavio
from music_tpu_torch.generate.wavenet_generate import (
    resolve_device, stream_tiling, streams_weights,
)
from music_tpu_torch.kernels import wavenet_ae_decode, wavenet_ae_decode_hbm
from music_tpu_torch.models import wavenet_ae as ae
from music_tpu_torch.ops.conv import full_fp32
from music_tpu_torch.ops.mulaw import mu_law_decode, mu_law_encode

BACKENDS = ("fused", "scan")


def load_params(
    cfg: ae.WaveNetAEConfig, params: dict | None, checkpoint_dir: str | Path | None,
    device: torch.device,
) -> dict[str, torch.Tensor]:
    """``params`` moved to ``device``, or the ``.params`` of the latest
    checkpoint in ``checkpoint_dir`` (shapes checked against ``cfg``)."""
    if params is None:
        if checkpoint_dir is None:
            raise ValueError("need params or checkpoint_dir")
        arrays = ckpt_lib.restore_subtree(checkpoint_dir, prefix=".params")
        return ae.params_from_numpy(arrays, device=device, cfg=cfg)
    return {k: v.to(device=device, dtype=torch.float32) for k, v in params.items()}


def frame_window_width(prime_len: int, steps: int, pool: int) -> int:
    """Encoding frames that cover a prime and one decode call of ``steps``,
    plus slack for the clamp at the end."""
    return -(-(prime_len + steps) // pool) + 2


def frame_window(clock: int, n_frames: int, width: int, pool: int) -> tuple[int, int]:
    """``(f0, offset)``: the first frame of the ``width``-frame window of an
    ``n_frames``-frame encoding that conditions a decode whose prime starts
    at absolute time ``clock``, and that time on the window's clock."""
    f0 = max(0, min(clock // pool, n_frames - width))
    return f0, clock - f0 * pool


def _encode_sources(params, audio: np.ndarray, cfg, device):
    """µ-law codes ``[n, T]`` of float audio rows and their encoding ``[n,
    F, W]`` (full float32)."""
    codes = mu_law_encode(torch.from_numpy(np.asarray(audio, np.float32)),
                          cfg.quantization_channel).to(device)
    with torch.no_grad(), full_fp32():
        encoding = ae.encode(params, codes, cfg)
    return codes, encoding


def _decode(params, encoding, codes, cfg, n_steps, *, backend, sample_mode, seed, dtype,
            pos_offset=0):
    """Reconstruction codes ``[n, n_steps]`` of the sources ``codes``; on
    the fused path ``pos_offset`` (an int or ``[n]``) is the absolute time
    of ``codes[:, 0]``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "scan":
        prime = codes[:, : min(cfg.receptive_field, codes.shape[1])]
        with full_fp32():
            return ae.generate_tokens(
                params, encoding, prime, torch.Generator(codes.device).manual_seed(seed),
                cfg=cfg, n_steps=n_steps, sample_mode=sample_mode,
            )
    prime_len = cfg.receptive_field + max(cfg.dilations)
    if sample_mode != "argmax" or codes.shape[1] < prime_len:
        raise ValueError(
            f"the fused decode takes argmax sampling and sources of at least "
            f"receptive_field + max dilation = {prime_len} samples (got sample_mode="
            f"{sample_mode!r}, {codes.shape[1]} samples); use backend='scan'"
        )
    kw = dict(cfg=cfg, n_steps=n_steps, dtype=dtype, pos_offset=pos_offset)
    n, device, prime = codes.shape[0], codes.device, codes[:, :prime_len]
    if streams_weights(n, device, wavenet_ae_decode, wavenet_ae_decode_hbm, cfg, dtype):
        S, G = stream_tiling(n, device, wavenet_ae_decode_hbm.max_streams(cfg, dtype))
        return wavenet_ae_decode_hbm.generate_tokens_fused_hbm(
            params, encoding, prime, n_streams=S, n_stream_groups=G, **kw)
    S, G = stream_tiling(n, device, wavenet_ae_decode.max_streams(cfg, dtype))
    return wavenet_ae_decode.generate_tokens_fused(
        params, encoding, prime, n_streams=S, n_stream_groups=G, **kw)


def generate(
    *,
    cfg: ae.WaveNetAEConfig,
    params: dict | None = None,
    checkpoint_dir: str | Path | None = None,
    source_audio: np.ndarray | None = None,
    source_path: str | Path | None = None,
    out_path: str | Path,
    sr: int = 16000,
    duration: float | None = None,
    sample_mode: str = "argmax",
    seed: int = 0,
    backend: str = "fused",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Reconstruct one source clip through the bottleneck and write it to
    ``out_path``; returns the audio (float32).

    ``source_path`` is read and resampled to ``sr``; ``duration`` limits
    the output to ``min(duration * sr, len(source))`` samples.
    ``backend="fused"`` (the conditioned decode kernel) takes argmax
    sampling and a source of at least receptive_field + max dilation
    samples, and raises on anything else; ``backend="scan"`` runs the plain
    step loop (:func:`music_tpu_torch.models.wavenet_ae.generate_tokens`,
    torch's own random numbers for categorical) on ``device``."""
    device = resolve_device(device)
    params = load_params(cfg, params, checkpoint_dir, device)
    if source_audio is None:
        if source_path is None:
            raise ValueError("need source_audio or source_path")
        source_audio, src_sr = wavio.read_wav(source_path)
        source_audio = wavio.resample(source_audio, src_sr, sr)
    codes, encoding = _encode_sources(params, np.asarray(source_audio)[None], cfg, device)
    n = codes.shape[1]
    n_steps = n if duration is None else min(int(duration * sr), n)
    out = _decode(params, encoding, codes, cfg, n_steps, backend=backend,
                  sample_mode=sample_mode, seed=seed, dtype=torch.float32)
    audio = mu_law_decode(out[0], cfg.quantization_channel).cpu().numpy()
    wavio.write_wav(out_path, audio, sr)
    return audio


def generate_batch(
    *,
    cfg: ae.WaveNetAEConfig,
    params: dict | None = None,
    checkpoint_dir: str | Path | None = None,
    source_audios: np.ndarray,
    out_dir: str | Path | None = None,
    sr: int = 16000,
    duration: float | None = None,
    dtype: torch.dtype = torch.float32,
    backend: str = "fused",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Serve ``n`` reconstructions at once; returns ``[n, T]`` audio and,
    with ``out_dir``, writes ``recon_000.wav ...``.

    ``source_audios``: ``[n, T_src]`` float audio rows of equal length
    (their conditioning frames must align).  All rows are encoded in one
    batched pass and decoded (argmax) in one fused call, tiled into thread
    blocks as :func:`~music_tpu_torch.generate.wavenet_generate.stream_tiling`
    says; ``backend="scan"`` runs the plain step loop instead."""
    device = resolve_device(device)
    params = load_params(cfg, params, checkpoint_dir, device)
    src = np.asarray(source_audios)
    if src.ndim != 2:
        raise ValueError("source_audios must be [n, T] rows of equal length")
    codes, encoding = _encode_sources(params, src, cfg, device)
    n_steps = src.shape[1] if duration is None else min(int(duration * sr), src.shape[1])
    out = _decode(params, encoding, codes, cfg, n_steps, backend=backend,
                  sample_mode="argmax", seed=0, dtype=dtype)
    audio = mu_law_decode(out, cfg.quantization_channel).cpu().numpy()
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for i in range(audio.shape[0]):
            wavio.write_wav(out_dir / f"recon_{i:03d}.wav", audio[i], sr)
    return audio
