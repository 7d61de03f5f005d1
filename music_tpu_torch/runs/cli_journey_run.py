"""The user's whole CLI workflow (counterpart of the JAX package's
``benchmarks/cli_journey_run.py``, same hops and checks).

Every hop is a subprocess of ``python -m music_tpu_torch``, the user's
surface, with the run's ``--device`` where the command takes one:

  0. a directory of source .wav files (synthesized tones: the "recordings"),
  1. ``dataset build-audio`` -> pieces + ``np_audio.pkl``,
  2. ``wavenet train`` with the shipped ``wavenet_params.json`` (window
     40000, batch 4, Adam 2e-4, 40 epochs, ``max_check_points`` 3) ->
     at most 3 rotating checkpoints and a ``loss_log.log`` whose "Average
     loss is" lines fall,
  3. ``wavenet generate --num 4`` -> 4 .wav files (bf16 categorical
     streams through the fused decode),
  4. ``vis loss`` -> ``loss.png``.

    python -m music_tpu_torch.runs.cli_journey_run [--workdir DIR]
        [--epochs N] [--device cuda|cpu]

Prints one JSON line last (also written to ``<workdir>/cli_journey.json``):
the JAX script's keys, each hop's seconds, the device, the card and
``wall_s``.  A hop that fails raises with its error output.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
import wave
from pathlib import Path

import numpy as np

from music_tpu_torch.cli import PARAMS_ROOT
from music_tpu_torch.generate.wavenet_generate import resolve_device
from music_tpu_torch.runs.common import RUNS_DIR, finish

REPO = Path(__file__).resolve().parents[2]
TONES_HZ = (220.0, 277.2, 330.0, 440.0)


def sh(args_list: list[str], cwd: Path, t0: float) -> float:
    """Run one CLI hop as a subprocess; echo its tail; its seconds.  Raises
    when it fails."""
    print(f"# [{time.perf_counter() - t0:7.1f}s] $ {' '.join(args_list)}", file=sys.stderr,
          flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "music_tpu_torch", *args_list], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=3000)
    sys.stderr.write("".join(f"#   {line}\n" for line in r.stdout.splitlines()[-4:]))
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-3000:])
        raise RuntimeError(f"CLI hop failed: {args_list[:2]}")
    return round(time.perf_counter() - t1, 2)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", help="default build/runs/cli_journey")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--num", type=int, default=4)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--wavenet-params", default=str(PARAMS_ROOT / "wavenet" /
                                                    "wavenet_params.json"))
    ap.add_argument("--piece-secs", type=int, default=20, help="dataset build-audio --duration")
    ap.add_argument("--window", type=int, default=40000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--print-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    work = Path(args.workdir or RUNS_DIR / "cli_journey")
    for name in ("recordings", "data", "params", "logs", "ckpts", "generated"):
        shutil.rmtree(work / name, ignore_errors=True)  # a run starts afresh, not resumed
    (work / "loss.png").unlink(missing_ok=True)
    work.mkdir(parents=True, exist_ok=True)
    out = {"metric": "cli_journey", "workdir": str(work)}
    hop_s = {}

    # hop 0: the user's recordings, one second longer than a piece
    sr = 16000
    src_dir = work / "recordings"
    src_dir.mkdir(exist_ok=True)
    t = np.arange(sr * (args.piece_secs + 1)) / sr
    for i, f in enumerate(TONES_HZ):
        audio = (0.5 * np.sin(2 * np.pi * f * t) * 32767).astype(np.int16)
        with wave.open(str(src_dir / f"tone{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(audio.tobytes())

    # hop 1: dataset build-audio
    data_dir = work / "data"
    hop_s["build-audio"] = sh(["dataset", "build-audio", "--audio-dir", str(src_dir),
                               "--out-dir", str(data_dir), "--duration",
                               str(args.piece_secs)], work, t0)
    if not (data_dir / "np_audio.pkl").exists():
        raise RuntimeError("np_audio.pkl missing")
    out["dataset_pieces"] = len(list(data_dir.glob("*.wav")))

    # hop 2: wavenet train (the shipped model params, the journey's paths)
    pdir = work / "params"
    pdir.mkdir(exist_ok=True)
    (pdir / "wavenet_params.json").write_text(Path(args.wavenet_params).read_text())
    (pdir / "dataset_params.json").write_text(json.dumps({
        "audio_path": str(data_dir / "np_audio.pkl"),
        "window_length": args.window,
        "batch_size": args.batch,
    }))
    (pdir / "train_params.json").write_text(json.dumps({
        "optimizer": "adam", "learning_rate": 2e-4,
        "num_epochs": args.epochs, "print_every": args.print_every, "seed": 0,
        "log_dir": str(work / "logs"), "restore_dir": str(work / "ckpts"),
        "max_check_points": 3,
    }))
    hop_s["train"] = sh(["wavenet", "train", "--params-dir", str(pdir), "--device",
                         device.type], work, t0)
    log = (work / "logs" / "loss_log.log").read_text().splitlines()
    losses = [float(m.group(1)) for line in log
              if (m := re.search(r"Average loss is ([0-9.eE+-]+)", line))]
    if not losses:
        raise RuntimeError(f"no loss lines parsed from {log[:3]}")
    ckpts = sorted((work / "ckpts").glob("step_*"))
    out.update({
        "train_steps_logged": len(losses),
        "loss_first": round(losses[0], 4),
        "loss_last": round(losses[-1], 4),
        "loss_min": round(min(losses), 4),
        "checkpoints": [p.name for p in ckpts],
    })

    # hop 3: wavenet generate --num N
    gen_dir = work / "generated"
    hop_s["generate"] = sh(["wavenet", "generate", "--checkpoint", str(work / "ckpts"),
                            "--params-dir", str(pdir), "--num", str(args.num), "--duration",
                            str(args.duration), "--out", str(gen_dir), "--device",
                            device.type], work, t0)
    wavs = sorted(gen_dir.glob("*.wav"))
    doms, uniqs, frames = [], [], []
    for p in wavs:
        with wave.open(str(p)) as w:
            n = w.getnframes()
            audio = np.frombuffer(w.readframes(n), np.int16) / 32767.0
        frames.append(n)
        uniqs.append(int(len(np.unique(np.round(audio * 127)))))
        spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
        spec[0] = 0.0
        doms.append(round(float(np.fft.rfftfreq(len(audio), 1.0 / sr)[int(np.argmax(spec))]),
                          1))
    out.update({
        "generated_wavs": len(wavs),
        "generated_frames": int(args.duration * sr),
        "unique_codes_per_wav": uniqs,
        "dominant_hz_per_wav": doms,  # informational: a workflow proof, not a quality run
    })

    # hop 4: vis loss
    hop_s["vis"] = sh(["vis", "loss", "--log", str(work / "logs" / "loss_log.log"),
                       "--out", str(work / "loss.png")], work, t0)
    png = work / "loss.png"
    out["loss_png_bytes"] = png.stat().st_size if png.exists() else 0
    out["hop_s"] = hop_s

    out["ok"] = bool(
        losses[-1] < losses[0] and 0 < len(ckpts) <= 3 and len(wavs) == args.num
        and all(n >= int(args.duration * sr) - 1 for n in frames) and min(uniqs, default=0) > 1
        and out["loss_png_bytes"] > 0)
    code = finish(out, device, t0, out["ok"])
    (work / "cli_journey.json").write_text(json.dumps(out, indent=1))
    return code


if __name__ == "__main__":
    sys.exit(main())
