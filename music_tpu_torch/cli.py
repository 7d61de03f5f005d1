"""Command-line interface of the PyTorch port.

    python -m music_tpu_torch wavenet train [--params-dir DIR] [--device cuda|cpu]
    python -m music_tpu_torch wavenet generate --checkpoint DIR --out out.wav
        [--duration S] [--sample-mode argmax|categorical] [--num N]
        [--device cuda|cpu] [--params-dir DIR]
    python -m music_tpu_torch wavenet-ae generate --checkpoint DIR
        --source FILE|DIR --out out.wav [--duration S] [--device cuda|cpu]
        [--params-dir DIR]
    python -m music_tpu_torch wavenet-ae train [--params-dir DIR] [--device cuda|cpu]
    python -m music_tpu_torch dataset build-audio --audio-dir D --out-dir D2
        [--duration S] [--sample-rate HZ]

Same arguments and defaults as the ``python -m music_tpu`` commands of the
same names, plus ``--device`` (default ``cuda``; without a CUDA device the
command fails unless ``--device cpu`` is given).  The configs are read from
``--params-dir`` (default: the port's own ``music_tpu_torch/params/<family>``):
``train`` takes the model, dataset and train params from there, and
``dataset build-audio`` writes the pieces and their ``np_audio.pkl`` under
``--out-dir``.  The multi-process flags of ``wavenet train`` are accepted
and refused: multi-process training is not ported yet.
"""

from __future__ import annotations

import argparse
from pathlib import Path

PARAMS_ROOT = Path(__file__).parent / "params"


def _out_dir(out: str) -> Path:
    """The directory a multi-stream run writes to: ``--out``'s stem."""
    out = Path(out)
    return out.parent / out.stem if out.suffix == ".wav" else out


def cmd_wavenet(args):
    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.generate.wavenet_generate import generate, generate_batch
    from music_tpu_torch.models.wavenet import WaveNetConfig

    p = load_params_dir(Path(args.params_dir or PARAMS_ROOT / "wavenet"))
    if args.action == "train":
        from music_tpu_torch.train.wavenet_train import train

        tp = dict(p["train_params"])
        if args.coordinator:
            tp.update(coordinator=args.coordinator, num_processes=args.num_processes,
                      process_id=args.process_id)
        train(wavenet_params=p["wavenet_params"], dataset_params=p["dataset_params"],
              train_params=tp, device=args.device)
        return
    cfg = WaveNetConfig.from_json(p["wavenet_params"])
    if args.num > 1:
        out_dir = _out_dir(args.out)
        generate_batch(
            cfg=cfg, checkpoint_dir=args.checkpoint, n=args.num, out_dir=out_dir,
            duration=args.duration, sample_mode=args.sample_mode, device=args.device,
        )
        print(f"wrote {args.num} wavs to {out_dir}/")
    else:
        generate(
            cfg=cfg, checkpoint_dir=args.checkpoint, out_path=args.out,
            duration=args.duration, sample_mode=args.sample_mode, device=args.device,
        )
        print(f"wrote {args.out}")


def cmd_wavenet_ae(args):
    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.generate.wavenet_ae_generate import generate, generate_batch
    from music_tpu_torch.models.wavenet_ae import WaveNetAEConfig

    p = load_params_dir(Path(args.params_dir or PARAMS_ROOT / "wavenet_autoencoder"))
    if args.action == "train":
        from music_tpu_torch.train.wavenet_ae_train import train

        train(model_params=p["model_params"], dataset_params=p["dataset_params"],
              train_params=p["train_params"], device=args.device)
        return
    if not args.source:
        raise SystemExit("wavenet-ae generate requires --source")
    cfg = WaveNetAEConfig.from_json(p["model_params"])
    src = Path(args.source)
    if src.is_dir():
        # serving path: every wav of the directory, resampled to 16 kHz and
        # trimmed to the shortest clip so the conditioning frames align
        import numpy as np

        from music_tpu_torch.data import wavio

        paths = sorted(src.glob("*.wav"))
        if not paths:
            raise SystemExit(f"no .wav files in {src}")
        rows = []
        for wav in paths:
            audio, src_sr = wavio.read_wav(wav)
            rows.append(wavio.resample(audio, src_sr, 16000))
        t_min = min(len(r) for r in rows)
        out_dir = _out_dir(args.out)
        generate_batch(
            cfg=cfg, checkpoint_dir=args.checkpoint,
            source_audios=np.stack([r[:t_min] for r in rows]),
            out_dir=out_dir, duration=args.duration, device=args.device,
        )
        print(f"wrote {len(paths)} wavs to {out_dir}/")
    else:
        generate(
            cfg=cfg, checkpoint_dir=args.checkpoint, source_path=src, out_path=args.out,
            duration=args.duration, device=args.device,
        )
        print(f"wrote {args.out}")


def cmd_dataset(args):
    from music_tpu_torch.data.audio import build_dataset, wavs_to_pickle

    pieces = build_dataset(args.audio_dir, args.out_dir, duration=args.duration,
                           sample_rate=args.sample_rate)
    pkl = wavs_to_pickle(args.out_dir, Path(args.out_dir) / "np_audio.pkl")
    print(f"{len(pieces)} pieces -> {pkl}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="music_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    device_help = "cuda (default) or cpu"

    p = sub.add_parser("wavenet")
    p.add_argument("action", choices=["train", "generate"])
    p.add_argument("--params-dir")
    p.add_argument("--checkpoint")
    p.add_argument("--out", default="generated.wav")
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--sample-mode", default="argmax", choices=["argmax", "categorical"])
    p.add_argument(
        "--num", type=int, default=1,
        help="serve N independent streams (writes N wavs under --out's stem)",
    )
    p.add_argument("--coordinator", help="multi-process training (not ported: refused)")
    p.add_argument("--num-processes", type=int, help="multi-process training (not ported)")
    p.add_argument("--process-id", type=int, help="multi-process training (not ported)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    p.set_defaults(fn=cmd_wavenet)

    p = sub.add_parser("wavenet-ae")
    p.add_argument("action", choices=["train", "generate"])
    p.add_argument("--params-dir")
    p.add_argument("--checkpoint")
    p.add_argument(
        "--source",
        help="generate: source wav to reconstruct, or a directory of wavs to serve "
        "concurrently (writes one reconstruction per clip under --out's stem)",
    )
    p.add_argument("--out", default="reconstructed.wav")
    p.add_argument("--duration", type=float, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    p.set_defaults(fn=cmd_wavenet_ae)

    p = sub.add_parser("dataset")
    p.add_argument("action", choices=["build-audio"])
    p.add_argument("--audio-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--duration", type=int, default=20)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.set_defaults(fn=cmd_dataset)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
