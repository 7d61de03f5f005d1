"""WaveNet audio generation entry points.

Counterpart of :mod:`music_tpu.generate.wavenet_generate` (``generate`` and
``generate_batch``, on one device): load the parameters, prime with a
receptive field (+ max dilation) of µ-law silence (code Q//2), decode
through :func:`music_tpu_torch.kernels.wavenet_decode.generate_tokens_fused`
in one call (one kernel launch on a CUDA device, its plain version on the
CPU), µ-law decode and write 16-bit PCM wavs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from music_tpu_torch.core import checkpoint as ckpt_lib
from music_tpu_torch.data import wavio
from music_tpu_torch.kernels import wavenet_decode
from music_tpu_torch.models import wavenet as wn
from music_tpu_torch.ops.mulaw import mu_law_decode


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must exist (there is
    no fallback to the CPU: the caller asks for it with ``"cpu"``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def load_params(
    cfg: wn.WaveNetConfig, params: dict | None, checkpoint_dir: str | Path | None,
    device: torch.device,
) -> dict[str, torch.Tensor]:
    """``params`` moved to ``device``, or the ``.params`` of the latest
    checkpoint in ``checkpoint_dir`` (shapes checked against ``cfg``)."""
    if params is None:
        if checkpoint_dir is None:
            raise ValueError("need params or checkpoint_dir")
        arrays = ckpt_lib.restore_subtree(checkpoint_dir, prefix=".params")
        return wn.params_from_numpy(arrays, device=device, cfg=cfg)
    return {k: v.to(device=device, dtype=torch.float32) for k, v in params.items()}


def stream_tiling(n: int, device: torch.device) -> tuple[int, int]:
    """``(n_streams, n_stream_groups)`` for ``n`` streams.  On a CUDA device
    one thread block per stream while the streams fit the SMs, else the
    fewest streams per block that do (a block's step time barely grows
    with its stream count, and more blocks read the weights in parallel);
    on the CPU one group holds every stream."""
    if device.type != "cuda":
        return n, 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for s in wavenet_decode.SUPPORTED_STREAMS:
        if -(-n // s) <= sms:
            return s, -(-n // s)
    s = wavenet_decode.SUPPORTED_STREAMS[-1]
    return s, -(-n // s)


def _silence(cfg: wn.WaveNetConfig, n: int) -> np.ndarray:
    prime_len = cfg.receptive_field + max(cfg.dilations)
    return np.full((n, prime_len), cfg.quantization_channels // 2, np.int32)


def generate(
    *,
    cfg: wn.WaveNetConfig,
    params: dict | None = None,
    checkpoint_dir: str | Path | None = None,
    out_path: str | Path,
    start_piece: np.ndarray | None = None,
    sr: int = 16000,
    duration: float = 10.0,
    sample_mode: str = "argmax",
    temperature: float = 1.0,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Generate ``duration`` seconds of one stream (float32) and write it to
    ``out_path``; returns the audio.  ``start_piece``: optional µ-law codes
    to prime with.  A prime shorter than receptive_field + max dilation
    cannot fill the fused decode's rings: on the CPU it is decoded by the
    plain step loop (:func:`music_tpu_torch.models.wavenet.generate_tokens`,
    torch's own random numbers for categorical), on a CUDA device it is
    refused."""
    device = resolve_device(device)
    params = load_params(cfg, params, checkpoint_dir, device)
    if start_piece is None:
        start_piece = _silence(cfg, 1)[0]
    prime = torch.as_tensor(np.asarray(start_piece, np.int32)[None, :], device=device)
    n_steps = int(duration * sr)
    prime_len = cfg.receptive_field + max(cfg.dilations)
    if prime.shape[1] >= prime_len:
        codes = wavenet_decode.generate_tokens_fused(
            params, prime, cfg=cfg, n_steps=n_steps, n_streams=1,
            n_stream_groups=1, dtype=torch.float32, sample_mode=sample_mode,
            temperature=temperature, seed=seed,
        )
    elif device.type == "cpu":
        codes = wn.generate_tokens(
            params, prime, torch.Generator().manual_seed(seed), cfg=cfg, n_steps=n_steps,
            prime_len=prime.shape[1], sample_mode=sample_mode, temperature=temperature,
        )
    else:
        raise ValueError(
            f"start_piece of {prime.shape[1]} codes is shorter than receptive_field + "
            f"max dilation = {prime_len}, which the decode kernel needs; pad it (e.g. "
            f"with silence, code {cfg.quantization_channels // 2}) or use device='cpu'"
        )
    audio = mu_law_decode(codes[0], cfg.quantization_channels).cpu().numpy()
    wavio.write_wav(out_path, audio, sr)
    return audio


def generate_batch(
    *,
    cfg: wn.WaveNetConfig,
    params: dict | None = None,
    checkpoint_dir: str | Path | None = None,
    n: int,
    out_dir: str | Path | None = None,
    start_pieces: np.ndarray | None = None,
    sr: int = 16000,
    duration: float = 10.0,
    sample_mode: str = "categorical",
    temperature: float = 1.0,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Serve ``n`` independent streams in one decode call; returns ``[n, T]``
    audio and, with ``out_dir``, writes ``gen_000.wav ...``.

    ``start_pieces``: optional ``[n, P]`` µ-law codes (P >= receptive_field
    + max dilation); defaults to silence.  Categorical sampling is the
    default (argmax streams from identical primes would be identical);
    stream ``i`` draws Philox stream ``(seed, i)``.  ``dtype`` defaults to
    bfloat16 (small numeric differences vs float32)."""
    device = resolve_device(device)
    params = load_params(cfg, params, checkpoint_dir, device)
    if start_pieces is None:
        start_pieces = _silence(cfg, n)
    prime = torch.as_tensor(np.asarray(start_pieces, np.int32), device=device)
    prime_len = cfg.receptive_field + max(cfg.dilations)
    if prime.ndim != 2 or prime.shape[0] != n or prime.shape[1] < prime_len:
        raise ValueError(f"start_pieces must be [n={n}, >={prime_len}]")
    n_streams, n_groups = stream_tiling(n, device)
    codes = wavenet_decode.generate_tokens_fused(
        params, prime, cfg=cfg, n_steps=int(duration * sr), n_streams=n_streams,
        n_stream_groups=n_groups, dtype=dtype, sample_mode=sample_mode,
        temperature=temperature, seed=seed,
    )
    audio = mu_law_decode(codes, cfg.quantization_channels).cpu().numpy()
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            wavio.write_wav(out_dir / f"gen_{i:03d}.wav", audio[i], sr)
    return audio
