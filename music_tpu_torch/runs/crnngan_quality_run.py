"""C-RNN-GAN end-to-end quality run (counterpart of the JAX package's
``benchmarks/crnngan_quality_run.py``, same protocol and pass criterion).

The pipeline, at the shipped width (hidden 350, noise 100, song_length
100) with the meta-conditioned G and D:

1. a multi-genre/composer MIDI corpus synthesized from musical patterns
   (scales and arpeggios with per-composer register, tempo and velocity)
   through the port's ``data/midi.events_to_midi``: no download;
2. parsed back through ``load_midi_dataset`` and turned into the
   genre + composer one-hot rows (``build_meta_onehots``);
3. MSE pretraining, then GAN epochs with an evaluation every
   ``--eval-every``, keeping the G of the best evaluation;
4. per-condition moment distances: 8 songs generated for each (genre,
   composer), scored against that composer's rows ("within") and the
   others' ("contrast");
5. one conditioned song per composer written as a ``.mid`` file by
   ``generate/crnngan_generate.generate`` and re-parsed.

Pass flag: the best checkpoint's within < contrast
(``conditioning_steers_generation``) and every re-parsed file has events.

    python -m music_tpu_torch.runs.crnngan_quality_run [--songs N]
        [--epochs N] [--config shipped|tiny] [--device cuda|cpu]

Prints one JSON line last: the JAX script's keys, each phase's seconds
and ms a step, the steps' profiles, the device, the card and ``wall_s``.
``--config tiny`` (narrow G and D, songs of 32 events) is for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from music_tpu_torch.core import optim
from music_tpu_torch.data.midi import (
    build_meta_onehots, events_to_midi, load_midi_dataset, midi_to_song_data,
)
from music_tpu_torch.generate import crnngan_generate
from music_tpu_torch.generate.wavenet_generate import resolve_device
from music_tpu_torch.models import crnngan as cg
from music_tpu_torch.runs.common import RUNS_DIR, finish, phase_timer, step_profiles
from music_tpu_torch.train.crnngan_train import (
    CRnnGanTrainConfig, CRnnGanTrainer, FeatureScaler,
)

# MIDI note numbers per (genre, composer): distinct registers + figures so
# conditioning has something to learn
PATTERNS = {
    ("classical", "bach"): dict(notes=[60, 62, 64, 65, 67, 69, 71, 72], step=96, dur=90, vel=70),
    ("classical", "mozart"): dict(notes=[72, 76, 79, 84, 79, 76], step=48, dur=45, vel=85),
    ("jazz", "evans"): dict(notes=[48, 51, 55, 58, 60, 58, 55, 51], step=64, dur=120, vel=60),
    ("jazz", "monk"): dict(notes=[36, 42, 46, 49, 46, 42], step=128, dur=60, vel=100),
}
CONFIGS = {
    "shipped": {},  # CRnnGanConfig(): hidden 350, noise 100, song_length 100
    "tiny": dict(noise_dim=4, hidden_dim=8, song_length=32),
}
EVAL_SONGS = 8  # songs generated per condition in an evaluation


def tone_freq(note: int) -> float:
    return 440.0 * 2.0 ** ((note - 69) / 12.0)


def synthesize_corpus(root: Path, songs_per_composer: int, rng: np.random.Generator):
    """Write ``root/genre/composer/song_i.mid`` pattern corpora."""
    for (genre, composer), pat in PATTERNS.items():
        for s in range(songs_per_composer):
            events = []
            phase = rng.integers(0, len(pat["notes"]))
            for i in range(160):
                note = pat["notes"][(i + phase) % len(pat["notes"])]
                note += int(rng.integers(-1, 2))  # slight variation
                events.append([
                    pat["step"] * (1 + (i % 4 == 3)),      # delta ticks
                    pat["dur"] + float(rng.integers(-5, 6)),
                    tone_freq(note),
                    pat["vel"] + float(rng.integers(-5, 6)),
                ])
            out = root / genre / composer / f"song_{s}.mid"
            events_to_midi(np.asarray(events, np.float64), out)


def moment_distance(gen: np.ndarray, real: np.ndarray) -> float:
    """Mean over features of |mean diff|/std_real + |std ratio - 1|."""
    g = gen.reshape(-1, gen.shape[-1]).astype(np.float64)
    r = real.reshape(-1, real.shape[-1]).astype(np.float64)
    rs = r.std(axis=0) + 1e-9
    return float(np.mean(
        np.abs(g.mean(axis=0) - r.mean(axis=0)) / rs
        + np.abs(g.std(axis=0) / rs - 1.0)
    ))


def condition_rows(meta_dim: int, genres: list[str], composers: list[str]) -> list[np.ndarray]:
    """The one-hot row of each (genre, composer) of :data:`PATTERNS`."""
    rows = []
    for genre, composer in PATTERNS:
        row = np.zeros((meta_dim,), np.float32)
        row[genres.index(genre)] = 1.0
        row[len(genres) + composers.index(composer)] = 1.0
        rows.append(row)
    return rows


def cond_distances(g_params: dict, cfg: cg.CRnnGanConfig, scaler: FeatureScaler,
                   cond_rows: list[np.ndarray], cond_data: list[np.ndarray], seed: int,
                   noise=None) -> tuple[float, float]:
    """Mean within and contrast moment distances of :data:`EVAL_SONGS`
    songs generated on each condition row, unrounded: G's uniforms from a
    generator seeded ``seed * 31 + ci`` for condition ``ci`` (JAX's
    ``PRNGKey(seed * 31 + ci)``), or ``noise(ci)`` ``[T, 8, noise_dim]``."""
    device = g_params["fc1"]["w"].device
    within, contrast = [], []
    for ci, row in enumerate(cond_rows):
        meta = torch.from_numpy(np.tile(row, (EVAL_SONGS, 1))).to(device)
        gen = torch.Generator(device).manual_seed(seed * 31 + ci) if noise is None else None
        with torch.no_grad():
            ev = cg.generate(g_params, cfg, EVAL_SONGS, meta=meta, generator=gen,
                             noise=None if noise is None else noise(ci))
        ev = scaler.inverse(ev.cpu().numpy())
        within.append(moment_distance(ev, cond_data[ci]))
        contrast.append(np.mean([
            moment_distance(ev, cond_data[cj])
            for cj in range(len(cond_rows)) if cj != ci
        ]))
    return float(np.mean(within)), float(np.mean(contrast))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--songs", type=int, default=16, help="songs per composer")
    ap.add_argument("--epochs", type=int, default=100, help="GAN epochs (reference: 100)")
    ap.add_argument("--pretrain", type=int, default=6)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--g-objective", default="fm", choices=["auto", "adv", "fm"])
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--out", help="directory of the corpus and the generated .mid files "
                                  "(default build/runs/...)")
    ap.add_argument("--config", choices=sorted(CONFIGS), default="shipped")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    out_dir = Path(args.out or RUNS_DIR / f"crnngan_{args.config}")
    corpus_dir = out_dir / "corpus"
    shutil.rmtree(corpus_dir, ignore_errors=True)
    synthesize_corpus(corpus_dir, args.songs, np.random.default_rng(0))

    base = cg.CRnnGanConfig(**CONFIGS[args.config])
    data, metas = load_midi_dataset(corpus_dir, song_length=base.song_length)
    meta, genres, composers = build_meta_onehots(metas)
    if len(data) != args.songs * len(PATTERNS):
        raise RuntimeError(f"{len(data)} songs parsed back, {args.songs * len(PATTERNS)} written")
    scaler = FeatureScaler(data)
    norm = scaler.transform(data).astype(np.float32)

    cfg = dataclasses.replace(base, meta_dim=meta.shape[1])
    tc = CRnnGanTrainConfig(cfg=cfg, batch_size=args.batch, g_lr=args.lr, d_lr=args.lr,
                            g_objective=args.g_objective)
    tr = CRnnGanTrainer(tc, seed=0, device=device)
    cond_rows = condition_rows(meta.shape[1], genres, composers)
    cond_data = [data[[i for i, m in enumerate(metas)
                       if (m["genre"], m["composer"]) == pair]] for pair in PATTERNS]
    phase_s, timed = phase_timer(device, ("pretrain", "gan", "eval", "generate"))

    def distances(seed):
        w, c = timed("eval", cond_distances, tr.g_params, cfg, scaler, cond_rows, cond_data,
                     seed)
        return round(w, 4), round(c, 4)

    d0 = distances(1)
    pre_loss = timed("pretrain", tr.pretrain, norm, epochs=args.pretrain, meta=meta)
    d_pre = distances(2)

    # adversarial training with periodic evaluation and best-checkpoint
    # selection (adversarial losses don't monotonically improve sample
    # statistics, so generation uses the best evaluation's G)
    gl = dl = acc = float("nan")
    best = (d_pre[0], 0, optim.tree_map(torch.clone, tr.g_params))
    trajectory = [(0,) + d_pre]
    for ep in range(args.epochs):
        gl, dl, acc = timed("gan", tr.gan_epoch, norm, meta=meta)
        if (ep + 1) % args.eval_every == 0 or ep + 1 == args.epochs:
            w, c = distances(100 + ep)
            trajectory.append((ep + 1, w, c))
            if w < best[0]:
                best = (w, ep + 1, optim.tree_map(torch.clone, tr.g_params))
    d_gan = distances(3)
    tr.g_params = best[2]
    d_best = distances(4)

    # conditioned generation -> .mid -> re-parse round trip
    n_events = []
    for i, (genre, composer) in enumerate(PATTERNS):
        mid = out_dir / f"gen_{genre}_{composer}.mid"
        timed("generate", crnngan_generate.generate, tr.g_params, cfg, mid, scaler=scaler,
              seed=10 + i, meta=cond_rows[i], device=device)
        n_events.append(len(midi_to_song_data(mid)))

    steps_per_epoch = len(norm) // args.batch
    real = torch.from_numpy(norm[:args.batch]).to(device)
    meta_b = torch.from_numpy(meta[:args.batch]).to(device)
    profiles = step_profiles(device, {
        "pretrain_step": lambda: tr.pre_step(real, meta_b),
        "gan_step": lambda: tr.gan_step(real, meta_b),
        "evaluation": lambda: cond_distances(tr.g_params, cfg, scaler, cond_rows, cond_data, 5),
    })
    steers = bool(d_best[0] < d_best[1])
    out = {
        "metric": "crnngan_e2e_quality",
        "songs": int(len(data)),
        "pretrain_loss": round(float(pre_loss), 4),
        "gan_g_loss": round(float(gl), 4),
        "gan_d_loss": round(float(dl), 4),
        "d_real_acc": round(float(acc), 4),
        "moment_distance_init": {"within": d0[0], "contrast": d0[1]},
        "moment_distance_after_pretrain": {"within": d_pre[0], "contrast": d_pre[1]},
        "moment_distance_final_epoch": {"within": d_gan[0], "contrast": d_gan[1]},
        "moment_distance_best_ckpt": {"within": d_best[0], "contrast": d_best[1]},
        "best_ckpt_epoch": best[1],
        "eval_trajectory": [list(x) for x in trajectory],
        "conditioning_steers_generation": steers,
        "generated_events_reparsed": n_events,
        "config": args.config,
        "schedule": f"{args.pretrain}/{args.epochs}",
        "phase_s": {k: round(v, 2) for k, v in phase_s.items()},
        "ms_per_step": {
            "pretrain": round(phase_s["pretrain"] / max(args.pretrain * steps_per_epoch, 1)
                              * 1e3, 2),
            "gan": round(phase_s["gan"] / max(args.epochs * steps_per_epoch, 1) * 1e3, 2)},
        "steps": profiles,
    }
    return finish(out, device, t0, steers and min(n_events) > 0)


if __name__ == "__main__":
    sys.exit(main())
