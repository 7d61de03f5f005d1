"""Command-line interface of the PyTorch port.

    python -m music_tpu_torch wavenet generate --checkpoint DIR --out out.wav
        [--duration S] [--sample-mode argmax|categorical] [--num N]
        [--device cuda|cpu] [--params-dir DIR]

Same arguments and defaults as ``python -m music_tpu wavenet generate``,
plus ``--device`` (default: ``cuda`` when a card is present, else
``cpu``).  The model config is read from ``--params-dir`` (default: the
JAX package's ``music_tpu/params/wavenet``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import music_tpu

PARAMS_ROOT = Path(music_tpu.__file__).parent / "params"


def cmd_wavenet(args):
    import torch

    from music_tpu.core.config import load_params_dir
    from music_tpu_torch.generate.wavenet_generate import generate, generate_batch
    from music_tpu_torch.models.wavenet import WaveNetConfig

    p = load_params_dir(Path(args.params_dir or PARAMS_ROOT / "wavenet"))
    cfg = WaveNetConfig.from_json(p["wavenet_params"])
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    if args.num > 1:
        out = Path(args.out)
        out_dir = out.parent / out.stem if out.suffix == ".wav" else out
        generate_batch(
            cfg=cfg, checkpoint_dir=args.checkpoint, n=args.num, out_dir=out_dir,
            duration=args.duration, sample_mode=args.sample_mode, device=device,
        )
        print(f"wrote {args.num} wavs to {out_dir}/")
    else:
        generate(
            cfg=cfg, checkpoint_dir=args.checkpoint, out_path=args.out,
            duration=args.duration, sample_mode=args.sample_mode, device=device,
        )
        print(f"wrote {args.out}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="music_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("wavenet")
    p.add_argument("action", choices=["generate"])
    p.add_argument("--params-dir")
    p.add_argument("--checkpoint")
    p.add_argument("--out", default="generated.wav")
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--sample-mode", default="argmax", choices=["argmax", "categorical"])
    p.add_argument(
        "--num", type=int, default=1,
        help="serve N independent streams (writes N wavs under --out's stem)",
    )
    p.add_argument("--device", help="cuda or cpu (default: cuda when available)")
    p.set_defaults(fn=cmd_wavenet)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
