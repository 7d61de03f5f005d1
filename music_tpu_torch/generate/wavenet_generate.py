"""WaveNet audio generation entry points.

Counterpart of :mod:`music_tpu.generate.wavenet_generate` (``generate`` and
``generate_batch``, on one device or a data mesh): load the parameters, prime with a
receptive field (+ max dilation) of µ-law silence (code Q//2), decode in
one call (one kernel launch on a CUDA device, the kernel's plain version on
the CPU), µ-law decode and write 16-bit PCM wavs.

Which kernel decodes is :func:`streams_weights`'s rule: the resident
kernel (:mod:`music_tpu_torch.kernels.wavenet_decode`) while its
shared-memory carve holds the tile the streams need with its helper warp,
else the weight-streaming kernel
(:mod:`music_tpu_torch.kernels.wavenet_decode_hbm`) when its own carve
holds more.  The shipped model (5.08 MB) stays resident at any stream
count; the 4.4x-scaled one (19.1 MB) goes to the weight-streaming kernel in
float32 (where the resident carve has no room for the helper warp's
stages) and stays resident in bf16.  music_tpu's ``_fused_decode`` routes
by a 12 MB weight size instead, a TPU VMEM budget; on the card both
kernels read their weights from L2 (PERF.md, section 6).

On a data mesh (``generate_batch(mesh=...)``, :mod:`music_tpu_torch.parallel`)
each rank decodes its block of the rows with the kernel the rule gives
them; the decode needs no communication.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from music_tpu_torch.core import checkpoint as ckpt_lib
from music_tpu_torch.data import wavio
from music_tpu_torch.kernels import wavenet_decode, wavenet_decode_hbm
from music_tpu_torch.models import wavenet as wn
from music_tpu_torch.ops.conv import full_fp32
from music_tpu_torch.ops.mulaw import mu_law_decode

BACKENDS = ("fused", "scan")


HELPER_STAGES = 3
"""Stages the resident kernel's carve needs for its helper warp (the tap
half of the next layer's product, off the chain)."""


def streams_weights(n: int, device: torch.device, resident, streaming, cfg,
                    dtype: torch.dtype) -> bool:
    """Whether ``n`` streams of a model go to the weight-streaming kernel
    (``streaming``: B2, or B4 for the autoencoder) rather than the resident
    one (``resident``: B1, B3), given as their modules.  The resident kernel
    takes them while its carve holds the tile :func:`stream_tiling` gives
    ``n`` streams on the card with :data:`HELPER_STAGES` stages; else the
    weight-streaming kernel does, if its carve holds more streams a block.
    On an H100 (PERF.md, section 6) the resident kernel without its helper
    warp (the 4.4x-scaled model in f32: 2 stages) runs its 40 layers on one
    warp at K = 128 and loses to the weight-streaming kernel, which splits
    them over two; with it (bf16) it wins, and past its carve in f32 the
    weight-streaming kernel's 4 streams a block beat two waves of 2.  Off
    the card (the plain versions) the tile is one stream."""
    tile = stream_tiling(n, device)[0] if device.type == "cuda" else 1
    helper_max = resident.max_streams(cfg, dtype, min_stages=HELPER_STAGES)
    return helper_max < tile and streaming.max_streams(cfg, dtype) > helper_max


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


def stream_tiling(n: int, device: torch.device,
                  max_streams: int = wavenet_decode.SUPPORTED_STREAMS[-1]) -> tuple[int, int]:
    """``(n_streams, n_stream_groups)`` for ``n`` streams.  On a CUDA device
    one thread block per stream while the streams fit the SMs, else the
    fewest streams per block that do (a block's step time barely grows
    with its stream count, and more blocks read the weights in parallel),
    never more than the kernel's ``max_streams``; on the CPU one group
    holds every stream."""
    if device.type != "cuda":
        return n, 1
    sizes = [s for s in wavenet_decode.SUPPORTED_STREAMS if s <= max_streams]
    if not sizes:
        raise ValueError("the decode kernel fits no stream tile for this config")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for s in sizes:
        if -(-n // s) <= sms:
            return s, -(-n // s)
    return sizes[-1], -(-n // sizes[-1])


def _fused_decode(params, prime, cfg, n_steps, dtype, sample_mode, temperature, seed, row0=0):
    """``prime``'s rows decoded in one call of the kernel
    :func:`streams_weights` picks, tiled as :func:`stream_tiling` says;
    ``row0`` is the global row of the first (its Philox stream)."""
    kw = dict(cfg=cfg, n_steps=n_steps, dtype=dtype, sample_mode=sample_mode,
              temperature=temperature, seed=seed, row0=row0)
    n, device = prime.shape[0], prime.device
    if streams_weights(n, device, wavenet_decode, wavenet_decode_hbm, cfg, dtype):
        S, G = stream_tiling(n, device, wavenet_decode_hbm.max_streams(cfg, dtype))
        return wavenet_decode_hbm.generate_tokens_fused_hbm(
            params, prime, n_streams=S, n_stream_groups=G, **kw)
    S, G = stream_tiling(n, device, wavenet_decode.max_streams(cfg, dtype))
    return wavenet_decode.generate_tokens_fused(params, prime, n_streams=S, n_stream_groups=G,
                                                **kw)


def _scan_decode(params, prime, cfg, n_steps, sample_mode, temperature, seed):
    """The plain step loop on ``prime``'s device (torch's own random
    numbers for categorical)."""
    with full_fp32():
        return wn.generate_tokens(
            params, prime, torch.Generator(prime.device).manual_seed(seed), cfg=cfg,
            n_steps=n_steps, prime_len=prime.shape[1], sample_mode=sample_mode,
            temperature=temperature,
        )


def check_serving_mesh(mesh) -> None:
    """A serving mesh splits rows over ``data`` only (JAX's
    ``sharded_rows_program``)."""
    if mesh.shape["seq"] * mesh.shape["model"] != 1:
        raise ValueError("serving mesh must be data-only (other axes = 1)")


def mesh_rows(mesh, n: int) -> slice:
    """This rank's rows of ``n``: contiguous blocks of ``ceil(n / data)``
    in data-coordinate order (the last ranks' may be shorter or empty)."""
    per = -(-n // mesh.shape["data"])
    lo = min(n, mesh.index("data") * per)
    return slice(lo, min(n, lo + per))


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
    backend: str = "fused",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Generate ``duration`` seconds of one stream (float32) and write it to
    ``out_path``; returns the audio.  ``start_piece``: optional µ-law codes
    to prime with.  ``backend="fused"`` decodes in one kernel call;
    ``backend="scan"`` runs the plain step loop
    (:func:`music_tpu_torch.models.wavenet.generate_tokens`, torch's own
    random numbers for categorical) on ``device``.  A prime shorter than
    receptive_field + max dilation cannot fill the fused decode's rings: on
    the CPU it goes to the step loop, on a CUDA device it is refused."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = resolve_device(device)
    params = load_params(cfg, params, checkpoint_dir, device)
    if start_piece is None:
        start_piece = _silence(cfg, 1)[0]
    prime = torch.as_tensor(np.asarray(start_piece, np.int32)[None, :], device=device)
    n_steps = int(duration * sr)
    prime_len = cfg.receptive_field + max(cfg.dilations)
    short = prime.shape[1] < prime_len
    if short and backend == "fused" and device.type != "cpu":
        raise ValueError(
            f"start_piece of {prime.shape[1]} codes is shorter than receptive_field + "
            f"max dilation = {prime_len}, which the decode kernel needs; pad it (e.g. "
            f"with silence, code {cfg.quantization_channels // 2}) or use backend='scan'"
        )
    if backend == "scan" or short:
        codes = _scan_decode(params, prime, cfg, n_steps, sample_mode, temperature, seed)
    else:
        codes = _fused_decode(params, prime, cfg, n_steps, torch.float32, sample_mode,
                              temperature, seed)
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
    backend: str = "fused",
    device: str | torch.device = "cuda",
    mesh=None,
) -> np.ndarray:
    """Serve ``n`` independent streams in one decode call; returns ``[n, T]``
    audio and, with ``out_dir``, writes ``gen_000.wav ...``.
    ``backend="scan"`` runs the plain step loop on ``device`` instead.

    ``start_pieces``: optional ``[n, P]`` µ-law codes (P >= receptive_field
    + max dilation); defaults to silence.  Categorical sampling is the
    default (argmax streams from identical primes would be identical);
    stream ``i`` draws Philox stream ``(seed, i)``.  ``dtype`` defaults to
    bfloat16 (small numeric differences vs float32).

    ``mesh``: a data-only mesh (:mod:`music_tpu_torch.parallel`; ``device``
    is then each rank's): every rank decodes its block of the rows
    (:func:`mesh_rows`) in one call on its device, stream ``i`` still
    drawing Philox stream ``(seed, i)``, so a mesh of any size gives
    ``mesh=None``'s codes on the fused path.  Each rank returns its own
    rows' audio and zero codes' elsewhere, and writes only its own rows'
    wavs, as the JAX package's multi-process branch does."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if mesh is not None:
        check_serving_mesh(mesh)
    device = mesh.device if mesh is not None else resolve_device(device)
    params = load_params(cfg, params, checkpoint_dir, device)
    if start_pieces is None:
        start_pieces = _silence(cfg, n)
    start_pieces = np.asarray(start_pieces, np.int32)
    prime_len = cfg.receptive_field + max(cfg.dilations) if backend == "fused" else 1
    if start_pieces.ndim != 2 or start_pieces.shape[0] != n or start_pieces.shape[1] < prime_len:
        raise ValueError(f"start_pieces must be [n={n}, >={prime_len}] (backend={backend!r})")
    rows = slice(0, n) if mesh is None else mesh_rows(mesh, n)
    prime = torch.as_tensor(start_pieces[rows], device=device)
    n_steps = int(duration * sr)
    codes = torch.zeros((n, n_steps), dtype=torch.int32, device=device)
    if rows.stop > rows.start and backend == "scan":
        codes[rows] = _scan_decode(params, prime, cfg, n_steps, sample_mode, temperature, seed)
    elif rows.stop > rows.start:
        codes[rows] = _fused_decode(params, prime, cfg, n_steps, dtype, sample_mode,
                                    temperature, seed, row0=rows.start)
    audio = mu_law_decode(codes, cfg.quantization_channels).cpu().numpy()
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for i in range(rows.start, rows.stop):
            wavio.write_wav(out_dir / f"gen_{i:03d}.wav", audio[i], sr)
    return audio
