"""SeqGAN training on one device (counterpart of
:mod:`music_tpu.train.seqgan_train`).

The oracle protocol: a randomly initialised generator (N(0, 1) everywhere
by default, divergence #17) writes the positive data; G is pretrained by
MLE, D on positives against G's samples, then rounds alternate policy-
gradient steps on Monte-Carlo rollout rewards with D retraining on fresh
negatives.  The oracle NLL of G's samples is the quality metric.  Both
optimizers are ``clip_by_global_norm(5) + adam(lr)`` with optax's rules
and state layout (:mod:`music_tpu_torch.core.optim`).

The JAX trainer fuses each phase into one nested-scan program; here each
phase is a Python loop over batches, one update per batch (the steps are
public: :meth:`SeqGanTrainer.mle_step`, :meth:`~SeqGanTrainer.d_step`,
:meth:`~SeqGanTrainer.pg_step`).  Shuffles draw from ``torch.Generator``s,
so batch orders differ from JAX's; a step given the same batch, noise and
state computes what JAX's does.  Not here: the mesh (data and model
parallelism; ROADMAP.md, A11).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from music_tpu_torch.core import optim
from music_tpu_torch.core.prng import KeySeq
from music_tpu_torch.generate.wavenet_generate import resolve_device
from music_tpu_torch.models import seqgan as sg
from music_tpu_torch.ops.rnn import check_token_ids


@dataclasses.dataclass
class SeqGanConfig:
    """The JAX package's ``SeqGanConfig`` (same fields and defaults)."""

    g: sg.GeneratorConfig = dataclasses.field(default_factory=sg.GeneratorConfig)
    d: sg.DiscriminatorConfig = dataclasses.field(default_factory=sg.DiscriminatorConfig)
    batch_size: int = 64
    generated_num: int = 1024
    rollout_num: int = 16
    g_lr: float = 1e-2
    d_lr: float = 1e-2
    grad_clip: float = 5.0
    oracle_init: str = "normal"


def write_samples(path: str | Path, samples: np.ndarray):
    """Whitespace-separated token lines, one sequence a line."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        for row in np.asarray(samples):
            f.write(" ".join(str(int(v)) for v in row) + "\n")


def read_samples(path: str | Path) -> np.ndarray:
    rows = []
    for line in Path(path).read_text().splitlines():
        if line.strip():
            rows.append([int(v) for v in line.split()])
    return np.asarray(rows, np.int32)


def refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh (data/model-parallel) training is not ported yet (ROADMAP.md, A11); "
            "train on one device with mesh=None")


class SeqGanTrainer:
    """G, D and oracle parameters with their optimizer states on one
    ``device`` (default CUDA, which must exist; ``"cpu"`` on request)."""

    def __init__(self, cfg: SeqGanConfig, seed: int = 0, mesh=None,
                 device: str | torch.device = "cuda"):
        refuse_mesh(mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.keys = KeySeq(seed)
        self.oracle_params = sg.init_generator(self.keys.next(), cfg.g, init=cfg.oracle_init,
                                               device=self.device)
        self.g_params = sg.init_generator(self.keys.next(), cfg.g, device=self.device)
        self.d_params = sg.init_discriminator(self.keys.next(), cfg.d, device=self.device)
        self.g_tx = optim.chain(optim.clip_by_global_norm(cfg.grad_clip), optim.adam(cfg.g_lr))
        self.d_tx = optim.chain(optim.clip_by_global_norm(cfg.grad_clip), optim.adam(cfg.d_lr))
        self.g_opt = self.g_tx.init(self.g_params)
        self.d_opt = self.d_tx.init(self.d_params)

    def _generator(self) -> torch.Generator:
        """A fresh generator on the trainer's device, from the seed's stream."""
        return self.keys.next(self.device)

    def _tokens(self, data: np.ndarray) -> torch.Tensor:
        """Host token ids, checked against the vocabulary, on the device."""
        check_token_ids(data, self.cfg.g.vocab_size)
        return torch.from_numpy(np.asarray(data, np.int64)).to(self.device)

    # ----- steps: one update each, on the given batch and draws ----------

    def mle_step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One MLE update of G on ``tokens [B, T]``; returns the loss."""
        self.g_params, self.g_opt, loss = optim.grad_update(
            self.g_tx, self.g_params, self.g_opt,
            lambda p: sg.generator_nll(p, tokens, self.cfg.g))
        return loss

    def d_step(self, tokens: torch.Tensor, labels: torch.Tensor, *,
               dropout_generator: torch.Generator | None = None,
               dropout_mask: torch.Tensor | None = None) -> torch.Tensor:
        """One cross-entropy update of D (dropout from the generator, or the
        given keep mask); returns the loss."""
        self.d_params, self.d_opt, loss = optim.grad_update(
            self.d_tx, self.d_params, self.d_opt,
            lambda p: sg.discriminator_loss(p, tokens, labels, self.cfg.d,
                                            dropout_generator=dropout_generator,
                                            dropout_mask=dropout_mask))
        return loss

    def pg_step(self, *, generator: torch.Generator | None = None,
                sample_noise: torch.Tensor | None = None,
                rollout_noise: torch.Tensor | None = None):
        """One policy-gradient update of G: a batch of G's samples, their
        rollout rewards from D, the surrogate loss.  Draws come from
        ``generator`` (default: a fresh one) unless noise is given
        (:func:`~music_tpu_torch.models.seqgan.generate`'s and
        :func:`~music_tpu_torch.models.seqgan.rollout_rewards`').
        Returns ``(loss, rewards [B, T])``."""
        cfg = self.cfg
        if generator is None and (sample_noise is None or rollout_noise is None):
            generator = self._generator()
        samples = sg.generate(self.g_params, cfg.g, cfg.batch_size, generator=generator,
                              noise=sample_noise)
        rewards = sg.rollout_rewards(self.g_params, self.d_params, samples, g_cfg=cfg.g,
                                     d_cfg=cfg.d, rollout_num=cfg.rollout_num,
                                     generator=generator, noise=rollout_noise)
        self.g_params, self.g_opt, loss = optim.grad_update(
            self.g_tx, self.g_params, self.g_opt,
            lambda p: sg.pg_loss(p, samples, rewards, cfg.g))
        return loss, rewards

    # ----- phases ---------------------------------------------------------

    def _samples(self, params: dict, n: int) -> np.ndarray:
        gen = self._generator()
        out = [sg.generate(params, self.cfg.g, self.cfg.batch_size, generator=gen)
               for _ in range(-(-n // self.cfg.batch_size))]
        return torch.cat(out).cpu().numpy().astype(np.int32)[:n]

    def oracle_samples(self, n: int) -> np.ndarray:
        """Positive data: ``n`` sequences from the oracle."""
        return self._samples(self.oracle_params, n)

    def generator_samples(self, n: int) -> np.ndarray:
        return self._samples(self.g_params, n)

    def _shuffled(self, n: int) -> torch.Tensor:
        """A permutation of ``n`` rows cut to whole batches, on the device."""
        perm = torch.randperm(n, generator=self.keys.next())
        return perm[: (n // self.cfg.batch_size) * self.cfg.batch_size].to(self.device)

    def pretrain_generator(self, positive: np.ndarray, epochs: int = 1) -> float:
        """MLE epochs over shuffled batches; the last batch's loss."""
        B = self.cfg.batch_size
        n = (len(positive) // B) * B
        if n == 0:
            raise ValueError("positive data smaller than one batch")
        data = self._tokens(positive[:n])
        loss = None
        for _ in range(epochs):
            for rows in self._shuffled(n).split(B):
                loss = self.mle_step(data[rows])
        return float(loss)

    def train_discriminator(self, positive: np.ndarray, d_steps: int = 1,
                            epochs: int = 1) -> float:
        """``d_steps`` x (regenerate as many negatives as positives, then
        ``epochs`` shuffled cross-entropy epochs over the 2N rows); the
        last batch's loss."""
        B, N = self.cfg.batch_size, len(positive)
        if 2 * N < B:
            raise ValueError("positive data smaller than half a batch")
        pos = self._tokens(positive)
        labels = torch.cat([torch.ones(N, dtype=torch.long), torch.zeros(N, dtype=torch.long)])
        labels = labels.to(self.device)
        gen = self._generator()
        loss = None
        for _ in range(d_steps):
            negative = sg.generate(self.g_params, self.cfg.g, N, generator=gen)
            tokens = torch.cat([pos, negative])
            for _ in range(epochs):
                for rows in self._shuffled(2 * N).split(B):
                    loss = self.d_step(tokens[rows], labels[rows], dropout_generator=gen)
        return float(loss)

    def adversarial_epoch(self, positive: np.ndarray, g_steps: int = 1, d_steps: int = 5,
                          d_epochs: int = 3):
        """One adversarial round: ``g_steps`` policy-gradient updates with
        fresh rewards, then D retraining; ``(g_loss, d_loss)``."""
        g_loss = 0.0
        for _ in range(g_steps):
            g_loss = float(self.pg_step()[0])
        d_loss = self.train_discriminator(positive, d_steps, d_epochs)
        return g_loss, d_loss

    @torch.no_grad()
    def oracle_nll(self, noise: torch.Tensor | None = None) -> float:
        """NLL of a batch of G's samples under the oracle."""
        samples = sg.generate(self.g_params, self.cfg.g, self.cfg.batch_size,
                              generator=None if noise is not None else self._generator(),
                              noise=noise)
        return float(sg.generator_nll(self.oracle_params, samples, self.cfg.g))
