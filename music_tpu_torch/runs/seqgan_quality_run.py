"""SeqGAN oracle-NLL quality run (counterpart of the JAX package's
``benchmarks/seqgan_quality_run.py``, same protocol and pass criterion).

The SeqGAN protocol's claim (the SeqGAN paper's synthetic experiment) is
that adversarial training beats the MLE-only generator on oracle NLL:

- oracle: an N(0, 1)-initialised LSTM (divergence #17), vocab 5000, seq
  20, batch 64, rollout 16, a 9,984-sequence oracle corpus;
- MLE pretraining in chunks of 10 epochs, the oracle NLL (8 batches)
  after each;
- D pretraining (5 x 3 epochs on fresh negatives);
- adversarial rounds (a PG step on Monte-Carlo rollout rewards, then 5 x
  3 epochs of D retraining), the oracle NLL every ``--eval-every`` rounds
  and at round 1.

Pass flag: ``adv_beats_mle``, the best adversarial oracle NLL below the
best MLE one.  Writes ``adv_samples.txt`` and ``trajectory.json`` into
``--out``.

    python -m music_tpu_torch.runs.seqgan_quality_run [--mle-epochs N]
        [--adv-rounds N] [--config shipped|tiny] [--device cuda|cpu]

Prints one JSON line last: the JAX script's keys (``backend`` the device
type), each phase's seconds and ms a step, the steps'
profiles, the device, the card and ``wall_s``.  ``--config tiny`` (vocab
50, a 3-filter D, seq 10, batch 8) is for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from music_tpu_torch.generate.wavenet_generate import resolve_device
from music_tpu_torch.models import seqgan as sg
from music_tpu_torch.runs.common import RUNS_DIR, finish, phase_timer, step_profiles
from music_tpu_torch.train.seqgan_train import SeqGanConfig, SeqGanTrainer, write_samples

CONFIGS = {
    "shipped": {},  # SeqGanConfig(): vocab 5000, seq 20, batch 64, rollout 16
    "tiny": dict(g=sg.GeneratorConfig(vocab_size=50, emb_dim=8, hidden_dim=8, seq_len=10),
                 d=sg.DiscriminatorConfig(vocab_size=50, emb_dim=8, filter_sizes=(1, 2, 3),
                                          num_filters=(8, 8, 16), seq_len=10),
                 batch_size=8, rollout_num=2),
}
D_STEPS, D_EPOCHS = 5, 3


def oracle_nll_avg(tr: SeqGanTrainer, n_batches: int = 8) -> float:
    """The oracle NLL averaged over several sample batches (one 64-row
    batch is noisy: +-0.02 nats)."""
    return float(np.mean([tr.oracle_nll() for _ in range(n_batches)]))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory of the samples and the trajectory "
                                  "(default build/runs/...)")
    ap.add_argument("--mle-epochs", type=int, default=120)
    ap.add_argument("--adv-rounds", type=int, default=100)
    ap.add_argument("--corpus", type=int, default=9984)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="shipped")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    out_dir = Path(args.out or RUNS_DIR / f"seqgan_{args.config}")
    out_dir.mkdir(parents=True, exist_ok=True)

    cfg = SeqGanConfig(**CONFIGS[args.config])
    tr = SeqGanTrainer(cfg, seed=233, device=device)
    positive = tr.oracle_samples(args.corpus)
    phase_s, timed = phase_timer(device, ("mle", "d_pretrain", "adversarial", "eval"))

    traj = {"mle": [], "adv": []}
    nll0 = timed("eval", oracle_nll_avg, tr)
    print(f"# init oracle NLL {nll0:.4f} (ln V = {np.log(cfg.g.vocab_size):.4f})",
          file=sys.stderr)

    # ---- MLE pretraining, trajectory every 10 epochs -------------------
    chunk, done = 10, 0
    while done < args.mle_epochs:
        e = min(chunk, args.mle_epochs - done)
        mle_loss = timed("mle", tr.pretrain_generator, positive, epochs=e)
        done += e
        nll = timed("eval", oracle_nll_avg, tr)
        traj["mle"].append({"epoch": done, "mle_loss": round(mle_loss, 4),
                            "oracle_nll": round(nll, 4)})
        print(f"# MLE epoch {done}: loss {mle_loss:.4f}, oracle NLL {nll:.4f}",
              file=sys.stderr)
    mle_only_nll = traj["mle"][-1]["oracle_nll"]
    mle_best_nll = min(r["oracle_nll"] for r in traj["mle"])

    # ---- D pretraining ----------------------------------------------------
    d_loss = timed("d_pretrain", tr.train_discriminator, positive, d_steps=D_STEPS,
                   epochs=D_EPOCHS)
    print(f"# D pretrain loss {d_loss:.4f}", file=sys.stderr)

    # ---- adversarial rounds -----------------------------------------------
    best_adv = float("inf")
    for r in range(1, args.adv_rounds + 1):
        g_loss, d_loss = timed("adversarial", tr.adversarial_epoch, positive, g_steps=1,
                               d_steps=D_STEPS, d_epochs=D_EPOCHS)
        if r % args.eval_every == 0 or r == 1:
            nll = timed("eval", oracle_nll_avg, tr)
            best_adv = min(best_adv, nll)
            traj["adv"].append({"round": r, "g_loss": round(g_loss, 4),
                                "d_loss": round(d_loss, 4), "oracle_nll": round(nll, 4)})
            print(f"# adv round {r}: g {g_loss:.4f}, d {d_loss:.4f}, oracle NLL {nll:.4f}",
                  file=sys.stderr)

    write_samples(out_dir / "adv_samples.txt", tr.generator_samples(64))
    (out_dir / "trajectory.json").write_text(json.dumps(traj, indent=1))

    B = cfg.batch_size
    n_pos = (args.corpus // B) * B
    d_batches = D_STEPS * D_EPOCHS * ((2 * args.corpus) // B)
    tokens = torch.from_numpy(positive[:B].astype(np.int64)).to(device)
    labels = (torch.arange(B, device=device) % 2).long()
    dropout = torch.Generator(device).manual_seed(0)
    profiles = step_profiles(device, {
        "mle_step": lambda: tr.mle_step(tokens),
        "d_step": lambda: tr.d_step(tokens, labels, dropout_generator=dropout),
        "pg_step": lambda: tr.pg_step(),
        "evaluation": lambda: oracle_nll_avg(tr),
    })
    out = {
        "metric": "seqgan_oracle_nll",
        "init_oracle_nll": round(nll0, 4),
        "mle_only_oracle_nll": mle_only_nll,
        "mle_best_oracle_nll": mle_best_nll,
        "adv_best_oracle_nll": round(best_adv, 4),
        "adv_final_oracle_nll": traj["adv"][-1]["oracle_nll"] if traj["adv"] else None,
        "adv_beats_mle": bool(best_adv < mle_best_nll),
        "ln_vocab": round(float(np.log(cfg.g.vocab_size)), 4),
        "mle_epochs": args.mle_epochs,
        "adv_rounds": args.adv_rounds,
        "corpus_size": args.corpus,
        "backend": device.type,
        "config": args.config,
        "phase_s": {k: round(v, 2) for k, v in phase_s.items()},
        "ms_per_step": {
            "mle": round(phase_s["mle"] / max(args.mle_epochs * (n_pos // B), 1) * 1e3, 2),
            "d_pretrain": round(phase_s["d_pretrain"] / d_batches * 1e3, 2),
            "adversarial_round": round(phase_s["adversarial"] / max(args.adv_rounds, 1) * 1e3,
                                       1)},
        "steps": profiles,
    }
    return finish(out, device, t0, out["adv_beats_mle"])


if __name__ == "__main__":
    sys.exit(main())
