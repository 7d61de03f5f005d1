"""Command-line interface of the PyTorch port.

    python -m music_tpu_torch wavenet train [--params-dir DIR] [--device cuda|cpu]
        [--coordinator HOST:PORT --num-processes N --process-id I]
        [--dist-backend nccl|gloo]
    python -m music_tpu_torch wavenet generate --checkpoint DIR --out out.wav
        [--duration S] [--sample-mode argmax|categorical] [--num N]
        [--device cuda|cpu] [--params-dir DIR]
    python -m music_tpu_torch wavenet-ae generate --checkpoint DIR
        --source FILE|DIR --out out.wav [--duration S] [--device cuda|cpu]
        [--params-dir DIR]
    python -m music_tpu_torch wavenet-ae train [--params-dir DIR] [--device cuda|cpu]
    python -m music_tpu_torch seqgan train [--params-dir DIR] [--device cuda|cpu]
    python -m music_tpu_torch leakgan train [--params-dir DIR] [--corpus NPY]
        [--data-dir DIR] [--checkpoint DIR] [--pretrain-g-epochs N]
        [--pretrain-d-epochs N] [--adversarial-epochs N] [--device cuda|cpu]
    python -m music_tpu_torch crnngan train [--params-dir DIR] [--midi-dir DIR]
        [--checkpoint DIR] [--device cuda|cpu]
    python -m music_tpu_torch crnngan generate --checkpoint DIR [--out out.mid]
        [--params-dir DIR] [--device cuda|cpu]
    python -m music_tpu_torch dataset build-audio --audio-dir D --out-dir D2
        [--duration S] [--sample-rate HZ]
    python -m music_tpu_torch dataset scrape-midi --out-dir D [--sources JSON]
        [--max-per-source N]
    python -m music_tpu_torch vis loss --log FILE [--out loss.png]

Same arguments and defaults as the ``python -m music_tpu`` commands of the
same names, plus ``--device`` (default ``cuda``; without a CUDA device the
command fails unless ``--device cpu`` is given).  The configs are read from
``--params-dir`` (default: the port's own ``music_tpu_torch/params/<family>``):
``train`` takes the model, dataset and train params from there, and
``dataset build-audio`` writes the pieces and their ``np_audio.pkl`` under
``--out-dir``.  ``seqgan train`` writes its oracle's and its generator's
samples to ``data/seqgan/{positive,generated}.txt`` under the working
directory; ``leakgan train`` trains on ``--corpus`` (a ``.npy`` of token
ids) or ``--data-dir``'s ``corpus.npy``, resuming from and saving to
``--checkpoint``.  ``crnngan train`` reads ``--midi-dir`` (default the
dataset params' ``root_dir``), laid out ``genre/composer/*.mid``,
conditions on the genre and composer one-hots and saves to
``--checkpoint``; ``crnngan generate`` reads the conditioning width from
the checkpoint and writes ``--out``: normalized events clamped to the
physical ranges, as the JAX command writes them (the feature scaler is not
in the checkpoint).  ``dataset scrape-midi`` crawls the sources table
(default the shipped ``params/c_rnn_gan/midi_sources.json``) into
``--out-dir`` and writes its split lists; ``vis loss`` plots a
``loss_log.log`` or ``metrics.jsonl`` with matplotlib, or on a host
without it draws the curve alone with numpy (``utils/loss_png.py``).

``wavenet train`` on several devices: start one process per device, each
with the same ``--coordinator`` (``host:port`` of process 0's TCP store),
``--num-processes`` and its own ``--process-id``; they train one model
data-parallel, each on its rows of every batch, and process 0 writes the
logs and checkpoints.  ``--dist-backend`` is ``nccl`` (the default with
``--device cuda``) or ``gloo`` (the default with ``--device cpu``).
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
                      process_id=args.process_id, dist_backend=args.dist_backend)
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


def cmd_seqgan(args):
    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.models.seqgan import DiscriminatorConfig, GeneratorConfig
    from music_tpu_torch.train.seqgan_train import SeqGanConfig, SeqGanTrainer, write_samples

    p = load_params_dir(Path(args.params_dir or PARAMS_ROOT / "seqgan"))["params"]
    g = GeneratorConfig(vocab_size=p["vocab_size"], emb_dim=p["emb_dim"],
                        hidden_dim=p["hidden_dim"], seq_len=p["seq_len"],
                        start_token=p["start_token"])
    cfg = SeqGanConfig(
        g=g, d=DiscriminatorConfig(vocab_size=p["vocab_size"], seq_len=p["seq_len"]),
        batch_size=p["batch_size"], generated_num=p["generated_num"],
        rollout_num=p["rollout_num"], g_lr=p["g_lr"], d_lr=p["d_lr"],
    )
    tr = SeqGanTrainer(cfg, device=args.device)
    positive = tr.oracle_samples(cfg.generated_num)
    write_samples("data/seqgan/positive.txt", positive)
    print("pretrain G:", tr.pretrain_generator(positive, epochs=p["pretrain_g_epochs"]))
    print("pretrain D:", tr.train_discriminator(positive, 1, 1))
    for r in range(p["adversarial_rounds"]):
        g_loss, d_loss = tr.adversarial_epoch(positive)
        print(f"round {r}: g_loss={g_loss:.4f} d_loss={d_loss:.4f} "
              f"oracle_nll={tr.oracle_nll():.4f}")
    write_samples("data/seqgan/generated.txt", tr.generator_samples(cfg.generated_num))


def cmd_leakgan(args):
    import dataclasses

    import numpy as np

    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.models.leakgan import LeakGanConfig
    from music_tpu_torch.train.leakgan_train import LeakGanTrainConfig, LeakGanTrainer

    p = load_params_dir(Path(args.params_dir or PARAMS_ROOT / "leak_gan"))
    cfg = LeakGanConfig.from_json(p["leak_gan_params"])
    tp = p["train_params"]
    if args.corpus:
        real = np.load(args.corpus)
    else:
        from music_tpu_torch.data.tokens import load_corpus

        real, _ = load_corpus(args.data_dir)
    if int(real.max()) >= cfg.vocab_size:
        # the reference's corpus holds 1-based ids up to its vocab_size, one
        # past its last embedding row: grow the vocabulary to cover the
        # corpus (id 0 stays the start token; docs/DIVERGENCES.md #18)
        cfg = dataclasses.replace(cfg, vocab_size=int(real.max()) + 1)
        print(f"corpus max id {int(real.max())} >= configured vocab; "
              f"using vocab_size={cfg.vocab_size}")
    tc = LeakGanTrainConfig(
        cfg=cfg, batch_size=tp["batch_size"], m_lr=tp["m_lr"], w_lr=tp["w_lr"],
        d_lr=tp["d_lr"], decay_step_size=tp["decay_step_size"],
        decay_rate=tp["decay_rate"], rollout_num=tp["rollout_num"],
        generated_num=tp["generated_num"],
    )
    tr = LeakGanTrainer(tc, seed=tp.get("seed", 0), device=args.device)
    if args.checkpoint:
        print(f"resumed from step {tr.restore(args.checkpoint)}")
    print("pretrain D:", tr.pretrain_discriminator(real, epochs=args.pretrain_d_epochs))
    print("pretrain G:", tr.pretrain_generator(real, epochs=args.pretrain_g_epochs))
    for epoch in range(args.adversarial_epochs):
        ml, wl, dl = tr.adversarial_epoch(real)
        print(f"epoch {epoch}: manager={ml:.4f} worker={wl:.4f} d={dl:.4f}")
    if args.checkpoint:
        tr.save(args.checkpoint, args.adversarial_epochs)


def cmd_crnngan(args):
    import dataclasses

    import numpy as np

    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.generate.wavenet_generate import resolve_device
    from music_tpu_torch.models import crnngan as cg

    device = resolve_device(args.device)
    p = load_params_dir(Path(args.params_dir or PARAMS_ROOT / "c_rnn_gan"))
    cfg = cg.CRnnGanConfig.from_json(p["crnngan_params"])
    if args.action == "train":
        from music_tpu_torch.data.midi import build_meta_onehots, load_midi_dataset
        from music_tpu_torch.train.crnngan_train import (
            CRnnGanTrainConfig, CRnnGanTrainer, FeatureScaler,
        )

        data, metas = load_midi_dataset(args.midi_dir or p["dataset_params"]["root_dir"],
                                        song_length=cfg.song_length)
        if len(data) == 0:
            raise SystemExit("no MIDI files found")
        # per-song genre/composer one-hot conditioning (c-rnn-gan/data.py:151-157)
        meta, genres, composers = build_meta_onehots(metas)
        cfg = dataclasses.replace(cfg, meta_dim=meta.shape[1])
        print(f"conditioning on {len(genres)} genres + {len(composers)} composers")
        normed = FeatureScaler(data).transform(data).astype(np.float32)
        tr = CRnnGanTrainer(CRnnGanTrainConfig(
            cfg=cfg, batch_size=p["dataset_params"]["batch_size"]), device=device)
        tp = p["train_params"]
        print("pretrain:", tr.pretrain(normed, epochs=tp["pretrain_epochs"], meta=meta))
        for epoch in range(tp["num_epochs"]):
            gl, dl, acc = tr.gan_epoch(normed, meta=meta)
            print(f"epoch {epoch}: g={gl:.4f} d={dl:.4f} d_acc={acc:.2f}")
        if args.checkpoint:
            tr.save(args.checkpoint, tp["num_epochs"])
        return
    import torch

    from music_tpu_torch.core import checkpoint as ckpt_lib
    from music_tpu_torch.generate.crnngan_generate import generate

    if not args.checkpoint:
        raise SystemExit("crnngan generate requires --checkpoint")
    # the conditioning width from the trained fc1's input width
    in_dim = ckpt_lib.leaf_shapes(args.checkpoint, prefix="['g_params']")["['fc1']['w']"][0]
    cfg = dataclasses.replace(
        cfg, meta_dim=max(int(in_dim - cfg.noise_dim - cfg.num_song_features), 0))
    example = cg.init_generator(torch.Generator().manual_seed(0), cfg, device)
    params = ckpt_lib.restore(args.checkpoint, {"g_params": example})["g_params"]
    generate(params, cfg, args.out, device=device)
    print(f"wrote {args.out}")


def cmd_dataset(args):
    if args.action == "scrape-midi":
        import json

        from music_tpu_torch.data.midi_scraper import (
            DEFAULT_SOURCES, download, write_split_lists,
        )

        cfg = json.loads(Path(args.sources or DEFAULT_SOURCES).read_text())
        written = download(args.out_dir, cfg.get("sources", cfg),
                           max_files_per_source=args.max_per_source)
        sp = cfg.get("splits", {})
        splits = write_split_lists(
            args.out_dir, validation_fraction=sp.get("validation_fraction", 0.2),
            test_fraction=sp.get("test_fraction", 0.1), seed=sp.get("seed", 0))
        print(f"{len(written)} new files; splits: "
              + ", ".join(f"{k}={len(v)}" for k, v in splits.items()))
        return
    from music_tpu_torch.data.audio import build_dataset, wavs_to_pickle

    if not args.audio_dir:
        raise SystemExit("build-audio requires --audio-dir")
    pieces = build_dataset(args.audio_dir, args.out_dir, duration=args.duration,
                           sample_rate=args.sample_rate)
    pkl = wavs_to_pickle(args.out_dir, Path(args.out_dir) / "np_audio.pkl")
    print(f"{len(pieces)} pieces -> {pkl}")


def cmd_vis(args):
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        from music_tpu_torch.utils.loss_png import plot_loss_png

        print(f"wrote {plot_loss_png(args.log, args.out)} (matplotlib is not installed: the "
              "curve alone, drawn by utils/loss_png.py)")
        return
    from music_tpu_torch.utils.visualize import plot_loss

    print(f"wrote {plot_loss(args.log, args.out)}")


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
    p.add_argument("--coordinator", help="multi-process: process 0's host:port")
    p.add_argument("--num-processes", type=int, help="multi-process: world size")
    p.add_argument("--process-id", type=int, help="multi-process: this process's rank")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"],
                   help="multi-process: nccl (default on cuda) or gloo (default on cpu)")
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

    p = sub.add_parser("seqgan")
    p.add_argument("action", choices=["train"])
    p.add_argument("--params-dir")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    p.set_defaults(fn=cmd_seqgan)

    p = sub.add_parser("leakgan")
    p.add_argument("action", choices=["train"])
    p.add_argument("--params-dir")
    p.add_argument("--corpus", help="path to corpus.npy")
    p.add_argument("--data-dir", default="data/leak_gan")
    p.add_argument("--checkpoint")
    p.add_argument("--pretrain-g-epochs", type=int, default=1)
    p.add_argument("--pretrain-d-epochs", type=int, default=1)
    p.add_argument("--adversarial-epochs", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    p.set_defaults(fn=cmd_leakgan)

    p = sub.add_parser("crnngan")
    p.add_argument("action", choices=["train", "generate"])
    p.add_argument("--params-dir")
    p.add_argument("--midi-dir")
    p.add_argument("--checkpoint")
    p.add_argument("--out", default="generated.mid")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    p.set_defaults(fn=cmd_crnngan)

    p = sub.add_parser("dataset")
    p.add_argument("action", choices=["build-audio", "scrape-midi"])
    p.add_argument("--audio-dir")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--duration", type=int, default=20)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--sources", help="scrape-midi: sources JSON (default: shipped table)")
    p.add_argument("--max-per-source", type=int, help="scrape-midi: cap per composer")
    p.set_defaults(fn=cmd_dataset)

    p = sub.add_parser("vis")
    p.add_argument("action", choices=["loss"])
    p.add_argument("--log", required=True)
    p.add_argument("--out", default="loss.png")
    p.set_defaults(fn=cmd_vis)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
