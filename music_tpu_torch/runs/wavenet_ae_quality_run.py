"""WaveNet-autoencoder quality run at full model scale (counterpart of the
JAX package's ``benchmarks/wavenet_ae_quality_run.py``, same protocol and
pass criterion).

The autoencoder's claim is that the 512x-pooled bottleneck *conditions*
the decoder: one trained model must reconstruct different sources
differently.  The full-size AE (40 blocks, bottleneck 512, pool 512) is
trained on two pure tones (220 and 330 Hz, amplitude 0.5, 6 s), then the
last receptive field + 8192 samples of each tone are reconstructed through
encode and the port's conditioned fused decode (on the card the kernel the
routing rule picks: the resident one at this width); each
reconstruction's dominant frequency must lie within 8 Hz of its own
source's.

    python -m music_tpu_torch.runs.wavenet_ae_quality_run [--steps N]
        [--config shipped|tiny] [--device cuda|cpu]

Prints one JSON line last: the JAX script's keys, the decode's kernel and
launches, the device, the card and ``wall_s``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from music_tpu_torch.core import optim
from music_tpu_torch.data.audio import mu_law_encode_np
from music_tpu_torch.generate import wavenet_ae_generate
from music_tpu_torch.generate.wavenet_generate import resolve_device, streams_weights
from music_tpu_torch.kernels import wavenet_ae_decode, wavenet_ae_decode_hbm
from music_tpu_torch.models import wavenet_ae as ae
from music_tpu_torch.runs.common import RUNS_DIR, finish, sync
from music_tpu_torch.train import wavenet_ae_train
from music_tpu_torch.train.wavenet_train import TrainState

TONES = (220.0, 330.0)
CONFIGS = {
    "shipped": {},  # WaveNetAEConfig(): the shipped model params
    "tiny": dict(dilations=(1, 2, 4, 8, 1, 2, 4, 8), en_residual_channel=8,
                 en_dilation_channel=8, de_residual_channel=8, de_dilation_channel=8,
                 de_skip_channel=16, en_bottleneck_width=12, en_pool_kernel_size=16,
                 quantization_channel=32),
}


def dominant_freq(audio: np.ndarray, sr: int = 16000) -> float:
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    spec[0] = 0.0
    return float(np.fft.rfftfreq(len(audio), 1.0 / sr)[int(np.argmax(spec))])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="shipped")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--secs", type=float, default=6.0)
    ap.add_argument("--decode-samples", type=int, default=8192)
    ap.add_argument("--out", help="directory of the reconstructions (default build/runs/...)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    out_dir = Path(args.out or RUNS_DIR / f"wavenet_ae_{args.config}")
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = ae.WaveNetAEConfig(**CONFIGS[args.config])
    sr = 16000
    t = np.arange(int(sr * args.secs)) / sr
    clips = [0.5 * np.sin(2 * np.pi * f * t) for f in TONES]
    codes = [mu_law_encode_np(c, cfg.quantization_channel) for c in clips]

    W = cfg.receptive_field + args.window
    rng = np.random.default_rng(0)

    def batch():
        rows = []
        for _ in range(args.batch):
            c = codes[rng.integers(len(codes))]
            s = rng.integers(0, len(c) - W)
            rows.append(c[s : s + W])
        return torch.from_numpy(np.stack(rows).astype(np.int32)).to(device)

    params = ae.init_params(cfg, torch.Generator().manual_seed(0), device=device)
    tx = optim.adam(args.lr)
    state = TrainState(params, tx.init(params), torch.zeros((), dtype=torch.int32,
                                                            device=device))
    step_fn = wavenet_ae_train.make_train_step(cfg, tx)
    sync(device)
    t1 = time.perf_counter()
    first = last = None
    for i in range(args.steps):
        state, loss = step_fn(state, batch())
        if i == 0:
            first = float(loss)
    last = float(loss)
    sync(device)
    train_s = time.perf_counter() - t1

    # the kernel the routing rule picks, on the card built first, its seconds apart
    routed = (wavenet_ae_decode_hbm if streams_weights(
        1, device, wavenet_ae_decode, wavenet_ae_decode_hbm, cfg, torch.float32)
        else wavenet_ae_decode)
    t1 = time.perf_counter()
    if device.type == "cuda":
        routed._library()
    build_s = time.perf_counter() - t1
    before = (wavenet_ae_decode.LAUNCHES, wavenet_ae_decode_hbm.LAUNCHES)
    results, decode_s = [], 0.0
    for f, clip in zip(TONES, clips):
        # the held-out tail of each tone: the bottleneck must carry its pitch
        src = clip[-(cfg.receptive_field + args.decode_samples):]
        t1 = time.perf_counter()
        audio = wavenet_ae_generate.generate(
            cfg=cfg, params=state.params, source_audio=src,
            out_path=out_dir / f"recon_{int(f)}hz.wav", sr=sr, device=device,
        )
        decode_s += time.perf_counter() - t1
        seg = np.asarray(audio[-args.decode_samples:], np.float64)
        results.append({
            "source_hz": f,
            "reconstructed_hz": round(dominant_freq(seg, sr), 1),
            "rms": round(float(np.sqrt(np.mean(seg**2))), 4),
        })
    launched = {"wavenet_ae_decode": wavenet_ae_decode.LAUNCHES - before[0],
                "wavenet_ae_decode_hbm": wavenet_ae_decode_hbm.LAUNCHES - before[1]}

    ok = all(abs(r["reconstructed_hz"] - r["source_hz"]) < 8.0 for r in results)
    out = {
        "metric": "wavenet_ae_e2e_quality",
        "config": args.config,
        "steps": args.steps,
        "loss_first": round(first, 4),
        "loss_last": round(last, 4),
        "reconstructions": results,
        "bottleneck_conditions_decoder": ok,
        "train_s": round(train_s, 2),
        "train_ms_per_step": round(train_s / max(args.steps, 1) * 1e3, 2),
        "decode_kernel": routed.__name__.rsplit(".", 1)[-1],
        "kernel_build_s": round(build_s, 2),
        "decode_launches": launched,
        "decode_s": round(decode_s, 3),
    }
    return finish(out, device, t0, ok)


if __name__ == "__main__":
    sys.exit(main())
