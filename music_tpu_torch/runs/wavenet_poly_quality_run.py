"""Polyphonic WaveNet quality run (counterpart of the JAX package's
``benchmarks/wavenet_poly_quality_run.py``, same protocol and pass
criterion).

The 40-block WaveNet is trained on a chord corpus (A3 major: three
simultaneous tones, per-clip phase and amplitude), then primed on real
context and decoded by the port's routed fused decode in float32; the
generated spectrum's three largest peaks must lie within ``3 · df + 2``
Hz of the chord's tones (``df`` the FFT bin).  Host µ-law encode (the C++
data path), trainer step (tap-fused GEMMs, bf16 compute, Adam 1e-3),
fused decode, µ-law decode, FFT.

``--config scaled`` runs the same protocol at the 4.4x-scaled width (Cr =
Cd = 64, Cs = 1024), whose float32 decode the routing rule gives the
weight-streaming kernel; its pass flag is a falling loss and every
generated token within 1e-4 of the plain model's best score,
teacher-forced (``chord_reproduced`` is reported, not required).  The
other configs also report that check and require it.

    python -m music_tpu_torch.runs.wavenet_poly_quality_run [--steps N]
        [--config shipped|scaled|tiny] [--device cuda|cpu]

Prints one JSON line last: the JAX script's keys, the loss trace, the
decode's kernel, launches and seconds, the trainer step's breakdown, the
device, the card and ``wall_s``.  On the CPU use ``--config tiny`` with a
short corpus and decode (see ``tests/test_torch_runs.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

from music_tpu_torch import native
from music_tpu_torch.core import optim
from music_tpu_torch.data import wavio
from music_tpu_torch.data.audio import AudioWindows, mu_law_encode_np
from music_tpu_torch.generate import wavenet_generate
from music_tpu_torch.kernels import wavenet_decode, wavenet_decode_hbm
from music_tpu_torch.models import wavenet as wn
from music_tpu_torch.ops.mulaw import mu_law_decode
from music_tpu_torch.runs.common import RUNS_DIR, finish, sync
from music_tpu_torch.train.wavenet_train import TrainState, make_train_step
from music_tpu_torch.utils.parity import teacher_forced_scores, tie_aware_check
from music_tpu_torch.utils.profiling import phase_fractions

CHORD_HZ = (220.0, 277.18, 329.63)  # A3 major triad: A, C#, E
SR = 16000
TOL_F32 = 1e-4  # a float32 decode and the plain model differ in summation order only
CONFIGS = {
    "shipped": {},  # WaveNetConfig(): the shipped params
    "scaled": dict(residual_channels=64, dilation_channels=64, skip_channels=1024),
    "tiny": dict(dilations=(1, 2, 4, 8, 1, 2, 4, 8), dilation_channels=8, residual_channels=8,
                 skip_channels=16, quantization_channels=32),
}
GEMM_KERNEL = re.compile(r"gemm|xmma|cutlass|sm90_|nvjet", re.IGNORECASE)


def config(name: str) -> wn.WaveNetConfig:
    return dataclasses.replace(wn.WaveNetConfig(), **CONFIGS[name])


def make_chord_corpus(n_clips=6, secs=20.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * secs)) / SR
    clips = []
    for _ in range(n_clips):
        x = np.zeros_like(t)
        for f in CHORD_HZ:
            amp = rng.uniform(0.12, 0.22)
            phase = rng.uniform(0, 2 * np.pi)
            x += amp * np.sin(2 * np.pi * f * t + phase)
        clips.append(x.astype(np.float32))
    return clips


def spectrum_peaks(audio, n_peaks=3, fmin=50.0):
    """Frequencies of the n_peaks largest well-separated spectral peaks."""
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    freqs = np.fft.rfftfreq(len(audio), 1 / SR)
    spec[freqs < fmin] = 0.0
    peaks = []
    for _ in range(n_peaks):
        i = int(np.argmax(spec))
        peaks.append(float(freqs[i]))
        lo = np.searchsorted(freqs, freqs[i] - 15.0)
        hi = np.searchsorted(freqs, freqs[i] + 15.0)
        spec[lo:hi] = 0.0
    return sorted(peaks)


def train_chord(params: dict, cfg: wn.WaveNetConfig, windows: AudioWindows, *, steps: int,
                batch: int = 8, lr: float = 1e-3, compute_dtype: torch.dtype | None = None,
                log_every: int = 50) -> tuple[TrainState, list[float]]:
    """``steps`` Adam updates of the trainer's step on batches of windows
    drawn by ``default_rng(1).integers(0, len(windows), batch)``, as the
    JAX script; the loss of every ``log_every``-th step and the last."""
    device = params["fg"].device
    tx = optim.adam(lr)
    state = TrainState(params, tx.init(params), torch.zeros((), dtype=torch.int32,
                                                            device=device))
    step_fn = make_train_step(cfg, tx, compute_dtype)
    rng = np.random.default_rng(1)
    losses = []
    for i in range(steps):
        idx = rng.integers(0, len(windows), batch)
        state, loss = step_fn(state, torch.from_numpy(windows.gather(idx)).to(device))
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss))
    return state, losses


def judge_chord(audio: np.ndarray) -> dict:
    """The JAX script's criterion on generated audio: the three largest
    peaks after the first 2,000 samples (the transient), each chord tone's
    distance to the nearest, and ``chord_reproduced`` when the largest is
    under ``3 · df + 2`` Hz (``df`` the FFT bin)."""
    peaks = spectrum_peaks(audio[2000:])
    errs = [min(abs(g - f) for g in peaks) for f in CHORD_HZ]
    df = SR / len(audio[2000:])
    return {"peaks": peaks, "max_err": max(errs), "df": df,
            "reproduced": bool(max(errs) < 3 * df + 2.0)}


def launches() -> dict[str, int]:
    return {"wavenet_decode": wavenet_decode.LAUNCHES,
            "wavenet_decode_hbm": wavenet_decode_hbm.LAUNCHES}


def decode_chord(params: dict, cfg: wn.WaveNetConfig, prime: torch.Tensor,
                 n_steps: int) -> torch.Tensor:
    """``n_steps`` argmax codes ``[1, n_steps]`` after ``prime [1, P]`` by
    the fused decode in float32, on the kernel the routing rule picks."""
    p32 = {k: v.detach().float() for k, v in params.items()}
    return wavenet_generate._fused_decode(p32, prime, cfg, n_steps, torch.float32, "argmax",
                                          1.0, 0)


def check_tokens(params: dict, cfg: wn.WaveNetConfig, prime: torch.Tensor,
                 tokens: torch.Tensor) -> dict:
    """Every token tie-aware against the plain float32 model, teacher-forced."""
    p32 = {k: v.detach().float() for k, v in params.items()}
    return tie_aware_check(tokens, lambda t: teacher_forced_scores(p32, prime, t, cfg), TOL_F32)


def _device_kernels(step, device: torch.device) -> tuple[float, float] | None:
    """``step()``'s device time in GEMM kernels and in all kernels (s), from
    ``torch.profiler``'s raw CUDA events; ``None`` off the card or when the
    profiler saw none."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        sync(device)
    gemm = busy = 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy += e.duration_ns() * 1e-9
            if GEMM_KERNEL.search(e.name()):
                gemm += e.duration_ns() * 1e-9
    return (gemm, busy) if busy > 0 else None


def step_breakdown(state: TrainState, cfg: wn.WaveNetConfig, windows: AudioWindows, *,
                   batch: int, compute_dtype: torch.dtype | None, steps: int = 5) -> dict:
    """Where a trainer step's time goes, in ms: the host's window gather (the
    C++ gather, and numpy's fancy index for comparison), the copy to the
    device through pinned memory, the forward, the backward (forward and
    backward, as ``jax.grad``) and the optimizer (each phase synchronised,
    ``utils.profiling.phase_fractions``), and over ``steps`` whole steps
    the device's busy time and its share in GEMM kernels
    (``torch.profiler``).  Params and state are not changed."""
    device = state.params["fg"].device
    rng = np.random.default_rng(2)
    idx = [rng.integers(0, len(windows), batch) for _ in range(steps)]

    def host_ms(fn):
        t0 = time.perf_counter()
        for i in idx:
            fn(i)
        return (time.perf_counter() - t0) / steps * 1e3

    host = windows.gather(idx[0])
    span = np.arange(windows.window)
    gather_ms = host_ms(windows.gather)
    numpy_ms = host_ms(lambda i: windows.data[windows.starts[i][:, None] + span[None, :]])

    def h2d(_):
        tokens = torch.from_numpy(host)
        if device.type == "cuda":
            tokens = tokens.pin_memory().to(device, non_blocking=True)
        sync(device)
    copy_ms = host_ms(h2d)
    tokens = torch.from_numpy(host).to(device)
    tx = optim.adam(1e-3)
    fracs = phase_fractions(
        lambda p, t: wn.loss_fn(p, t, cfg, fuse_taps=True, compute_dtype=compute_dtype),
        state.params, tokens, tx, state.opt_state, n_iters=steps)
    step_ms = fracs["total_seconds"] * 1e3
    out = {"gather_ms": round(gather_ms, 4), "gather_numpy_ms": round(numpy_ms, 4),
           "h2d_ms": round(copy_ms, 4),
           **{f"{k}_ms": round(fracs[f"{k}_frac"] * step_ms, 3)
              for k in ("forward", "backward", "optimizer")}}
    step_fn = make_train_step(cfg, tx, compute_dtype)

    def run_steps():
        st = state
        for _ in range(steps):
            st, _ = step_fn(st, tokens)

    sync(device)
    t0 = time.perf_counter()
    run_steps()
    sync(device)
    wall = (time.perf_counter() - t0) / steps
    out["step_ms"] = round(wall * 1e3, 3)
    kernels = _device_kernels(run_steps, device)
    if kernels is None:
        out["device_busy_ms"] = out["gemm_share_of_busy"] = "not measured"
    else:
        gemm, busy = kernels
        out["device_busy_ms"] = round(busy / steps * 1e3, 3)
        out["gemm_share_of_busy"] = round(gemm / busy, 4)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="shipped")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--window", type=int, default=12_288)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--clip-secs", type=float, default=20.0)
    ap.add_argument("--decode-steps", type=int, default=SR)
    ap.add_argument("--out", help="directory of chord_gen.wav (default build/runs/...)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = wavenet_generate.resolve_device(args.device)
    out_dir = Path(args.out or RUNS_DIR / f"wavenet_poly_{args.config}")
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = config(args.config)
    q = cfg.quantization_channels
    compute_dtype = torch.bfloat16  # the JAX protocol's mixed precision

    clips = make_chord_corpus(secs=args.clip_secs)
    corpus_peaks = spectrum_peaks(clips[0])
    codes = [mu_law_encode_np(c, q) for c in clips]
    windows = AudioWindows(codes, receptive_field=cfg.receptive_field, window_length=args.window)
    windows.check_vocab(q)
    params = wn.init_params(cfg, torch.Generator().manual_seed(0), device=device)
    sync(device)
    t1 = time.perf_counter()
    state, losses = train_chord(params, cfg, windows, steps=args.steps, batch=args.batch,
                                compute_dtype=compute_dtype)
    sync(device)
    train_s = time.perf_counter() - t1
    print(f"# {args.steps} steps in {train_s:.1f} s, losses {[round(x, 4) for x in losses]}",
          file=sys.stderr, flush=True)
    breakdown = step_breakdown(state, cfg, windows, batch=args.batch,
                               compute_dtype=compute_dtype)

    # decode primed with real chord context, on the kernel the routing rule
    # picks (on the card built first, its seconds apart)
    routed = (wavenet_decode_hbm if wavenet_generate.streams_weights(
        1, device, wavenet_decode, wavenet_decode_hbm, cfg, torch.float32) else wavenet_decode)
    t1 = time.perf_counter()
    if device.type == "cuda":
        routed._library()
    build_s = time.perf_counter() - t1
    P = cfg.receptive_field + max(cfg.dilations)
    prime = torch.from_numpy(codes[0][:P][None]).to(device)
    before = launches()
    sync(device)
    t1 = time.perf_counter()
    toks = decode_chord(state.params, cfg, prime, args.decode_steps)
    sync(device)
    decode_s = time.perf_counter() - t1
    launched = {k: v - before[k] for k, v in launches().items()}
    audio = mu_law_decode(toks[0], q).cpu().numpy()
    wavio.write_wav(out_dir / "chord_gen.wav", audio, SR)
    tie = check_tokens(state.params, cfg, prime, toks)

    chord = judge_chord(audio)
    loss_falls = bool(losses[-1] < losses[0])
    out = {
        "metric": "wavenet_polyphonic_quality",
        "config": args.config,
        "chord_hz": list(CHORD_HZ),
        "corpus_peaks_hz": [round(p, 1) for p in corpus_peaks],
        "generated_peaks_hz": [round(p, 1) for p in chord["peaks"]],
        "max_peak_error_hz": round(chord["max_err"], 2),
        "fft_bin_hz": round(chord["df"], 2),
        "chord_reproduced": chord["reproduced"],
        "first_loss": round(losses[0], 4),
        "final_loss": round(losses[-1], 4),
        "losses": [round(x, 4) for x in losses],
        "train_steps": args.steps,
        "gen_rms": round(float(np.sqrt(np.mean(audio**2))), 3),
        "corpus_rms": round(float(np.sqrt(np.mean(clips[0] ** 2))), 3),
        "backend": device.type,
        "train_s": round(train_s, 2),
        "train_ms_per_step": round(train_s / max(args.steps, 1) * 1e3, 2),
        "step_breakdown": breakdown,
        "decode_kernel": routed.__name__.rsplit(".", 1)[-1],
        "kernel_build_s": round(build_s, 2),
        "decode_launches": launched,
        "decode_steps": args.decode_steps,
        "decode_s": round(decode_s, 3),
        "tokens_tie_aware": tie,
        "loss_falls": loss_falls,
        "native_data_path": native.available(),
    }
    passed = tie["ok"] and (loss_falls if args.config == "scaled" else chord["reproduced"])
    return finish(out, device, t0, passed)


if __name__ == "__main__":
    sys.exit(main())
