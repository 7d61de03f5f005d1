"""LeakGAN oracle-NLL run at the reference schedule (counterpart of the JAX
package's ``benchmarks/leakgan_oracle_run.py``, same protocol).

With every oracle parameter N(0, 1) (``oracle_init="normal"``, the
trainer's default) the oracle's distribution is peaked: G starts far above
the oracle's self-NLL and closes the gap as it learns the oracle corpus.
Full scale: vocab 5258, 1720 leaked features, batch 64, rollout 4, a
1,024-sequence oracle corpus, 80 G-pretrain / 50 D-pretrain / 800
adversarial epochs (leak_gan/params/train_params.json).

The JAX script prints no pass flag; this run adds ``adv_beats_pretrain``,
the best adversarial oracle NLL below the pretrained G's (the expectation
``docs/BENCHMARKS.md`` states), and exits 1 when it is false.  Writes
``trajectory.json`` into ``--out``.

    python -m music_tpu_torch.runs.leakgan_oracle_run [--pre-g N] [--pre-d N]
        [--adv N] [--config shipped|tiny] [--device cuda|cpu]

Prints one JSON line last: the JAX script's keys (``backend`` the device
type), ``adv_beats_pretrain``, each phase's seconds and ms a step, the
steps' profiles, the device, the card and ``wall_s``.  ``--config tiny``
(vocab 40, seq 10, a 3-filter D, batch 4) is for the CPU.
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
from music_tpu_torch.models import leakgan as lg
from music_tpu_torch.models import seqgan as sg
from music_tpu_torch.runs.common import RUNS_DIR, finish, phase_timer, step_profiles
from music_tpu_torch.train.leakgan_train import LeakGanTrainConfig, LeakGanTrainer

CONFIGS = {
    "shipped": {},  # LeakGanConfig(): vocab 5258, seq 20, 1720 filters; batch 64
    "tiny": dict(cfg=lg.LeakGanConfig(vocab_size=40, seq_len=10, step_size=5, goal_size=4,
                                      worker_emb_dim=8, worker_hidden=8, manager_hidden=8,
                                      dis_emb_dim=8, filter_sizes=(1, 2, 3),
                                      num_filters=(8, 8, 16)),
                 batch_size=4),
}
D_STEPS, D_EPOCHS = 5, 3


def oracle_self_nll(oracle_params: dict, oracle_cfg: sg.GeneratorConfig, batch: int,
                    n_batches: int = 8, noise: list[torch.Tensor] | None = None) -> float:
    """The oracle's own samples under itself, the target NLL: the mean over
    ``n_batches`` batches, batch ``i`` sampled with a generator seeded ``i``
    (JAX's ``PRNGKey(i)``) or with the Gumbel slabs ``noise[i]``."""
    device = oracle_params["embed"].device
    vals = []
    for i in range(n_batches):
        gen = torch.Generator(device).manual_seed(i) if noise is None else None
        samples = sg.generate(oracle_params, oracle_cfg, batch, generator=gen,
                              noise=None if noise is None else noise[i])
        vals.append(float(sg.generator_nll(oracle_params, samples, oracle_cfg)))
    return float(np.mean(vals))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory of the trajectory (default build/runs/...)")
    ap.add_argument("--pre-g", type=int, default=80)
    ap.add_argument("--pre-d", type=int, default=50)
    ap.add_argument("--adv", type=int, default=800)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--corpus", type=int, default=1024)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="shipped")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    out_dir = Path(args.out or RUNS_DIR / f"leakgan_oracle_{args.config}")
    out_dir.mkdir(parents=True, exist_ok=True)

    tc = LeakGanTrainConfig(**CONFIGS[args.config])  # oracle_init normal
    tr = LeakGanTrainer(tc, seed=233, device=device)
    corpus = tr.oracle_samples(args.corpus)
    phase_s, timed = phase_timer(device, ("pretrain_g", "pretrain_d", "adversarial", "eval"))

    def nll_avg(n=8):
        return float(np.mean([tr.oracle_nll() for _ in range(n)]))

    self_nll = timed("eval", oracle_self_nll, tr.oracle_params, tr.oracle_cfg, tc.batch_size)
    traj = {"pretrain": [], "adv": []}
    nll0 = timed("eval", nll_avg)
    print(f"# init oracle NLL {nll0:.4f}; oracle self-NLL {self_nll:.4f}; "
          f"ln V {np.log(tc.cfg.vocab_size):.4f}", file=sys.stderr)

    done = 0
    while done < args.pre_g:
        e = min(10, args.pre_g - done)
        ml, wl = timed("pretrain_g", tr.pretrain_generator, corpus, epochs=e)
        done += e
        nll = timed("eval", nll_avg)
        traj["pretrain"].append({"epoch": done, "m_loss": round(ml, 4),
                                 "w_loss": round(wl, 4), "oracle_nll": round(nll, 4)})
        print(f"# pre_g {done}: w_loss {wl:.4f}, oracle NLL {nll:.4f}", file=sys.stderr)
    pre_nll = traj["pretrain"][-1]["oracle_nll"]

    dl = timed("pretrain_d", tr.pretrain_discriminator, corpus, epochs=args.pre_d)
    print(f"# pre_d {args.pre_d} epochs: d_loss {dl:.4f}", file=sys.stderr)

    best = float("inf")
    for ep in range(1, args.adv + 1):
        ml, wl, dlo = timed("adversarial", tr.adversarial_epoch, corpus, d_steps=D_STEPS,
                            d_epochs=D_EPOCHS)
        if ep % args.eval_every == 0 or ep == 1:
            nll = timed("eval", nll_avg)
            best = min(best, nll)
            traj["adv"].append({"epoch": ep, "m_loss": round(ml, 4),
                                "w_loss": round(wl, 4), "d_loss": round(dlo, 4),
                                "oracle_nll": round(nll, 4)})
            print(f"# adv {ep}: oracle NLL {nll:.4f}", file=sys.stderr)
    (out_dir / "trajectory.json").write_text(json.dumps(traj))

    B = tc.batch_size
    batches = args.corpus // B
    tokens = torch.from_numpy(corpus[:B].astype(np.int64)).to(device)
    labels = (torch.arange(B, device=device) % 2).long()
    gen = torch.Generator(device).manual_seed(0)
    profiles = step_profiles(device, {
        "pre_step": lambda: tr.pre_step(tokens, generator=gen, dropout_generator=gen),
        "d_step": lambda: tr.d_step(tokens, labels, dropout_generator=gen),
        "adv_step": lambda: tr.adv_step(generator=gen),
        "evaluation": nll_avg,
    })
    out = {
        "metric": "leakgan_oracle_nll_normal_init",
        "oracle_self_nll": round(self_nll, 4),
        "ln_vocab": round(float(np.log(tc.cfg.vocab_size)), 4),
        "init_oracle_nll": round(nll0, 4),
        "pretrain_oracle_nll": pre_nll,
        "best_adv_oracle_nll": round(best, 4),
        "final_adv_oracle_nll": traj["adv"][-1]["oracle_nll"] if traj["adv"] else None,
        "metric_range_nats": round(nll0 - best, 4),
        "schedule": f"{args.pre_g}/{args.pre_d}/{args.adv}",
        "backend": device.type,
        "adv_beats_pretrain": bool(best < pre_nll),
        "config": args.config,
        "phase_s": {k: round(v, 2) for k, v in phase_s.items()},
        "ms_per_step": {
            "pretrain_g": round(phase_s["pretrain_g"] / max(args.pre_g * batches, 1) * 1e3, 2),
            "pretrain_d": round(phase_s["pretrain_d"] / max(args.pre_d * 2 * batches, 1)
                                * 1e3, 2),
            "adversarial_epoch": round(phase_s["adversarial"] / max(args.adv, 1) * 1e3, 1)},
        "steps": profiles,
    }
    return finish(out, device, t0, out["adv_beats_pretrain"])


if __name__ == "__main__":
    sys.exit(main())
