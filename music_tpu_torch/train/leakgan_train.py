"""LeakGAN training on one device (counterpart of
:mod:`music_tpu.train.leakgan_train`).

Per-module Adam (Manager, Worker, D), each ``clip_by_global_norm(5) +
adam(step_lr(lr, decay_step_size, decay_rate))`` with optax's rules and
state layout; interleaved Manager/Worker pretraining, D pretraining on
fresh negatives, adversarial rounds on rank-rescaled rollout rewards, the
target-LSTM oracle and ``eval_nll``; checkpoints of :meth:`state` under
the JAX ``state()``'s key paths (``['g_params']['manager']...``,
``['m_opt'][1][0].mu...``), so either package resumes the other's.

The JAX trainer fuses each phase into one program; here each phase is a
Python loop over batches with public steps (:meth:`LeakGanTrainer.pre_step`,
:meth:`~LeakGanTrainer.d_step`, :meth:`~LeakGanTrainer.adv_step`) that take
their batch and, for tests, their Gumbel noise and dropout masks.  Batch
orders come from ``torch.Generator``s and differ from JAX's.

``mesh=`` runs it on a ``(data, seq, model)`` mesh of ranks
(:class:`~music_tpu_torch.parallel.gan_tp.TrainerMesh`): each data rank
its rows and its own randomness, the losses averaged and the gradients
summed over ``data``, the rollout rewards ranked over the global batch; D
split over ``model``, every engine pass reading its split forward.
:meth:`LeakGanTrainer.state` gathers the split leaves, so checkpoints are
those of one device.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Any

import numpy as np
import torch

from music_tpu_torch.core import checkpoint as ckpt_lib
from music_tpu_torch.core import optim
from music_tpu_torch.core.prng import KeySeq
from music_tpu_torch.generate.wavenet_generate import resolve_device
from music_tpu_torch.models import leakgan as lg
from music_tpu_torch.models import seqgan as sg
from music_tpu_torch.ops.rnn import check_token_ids
from music_tpu_torch.parallel import gan_tp
from music_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class LeakGanTrainConfig:
    """The JAX package's ``LeakGanTrainConfig`` (same fields and defaults),
    with its opt-in stabilizers: ``adv_lr_scale`` scales the Manager/Worker
    learning rate of adversarial updates only, ``reward_delta`` is the rank
    rescale's sharpness, ``oracle_init`` the oracle's init."""

    cfg: lg.LeakGanConfig = dataclasses.field(default_factory=lg.LeakGanConfig)
    batch_size: int = 64
    m_lr: float = 1.5e-3
    w_lr: float = 1.5e-3
    d_lr: float = 5e-5
    decay_step_size: int = 200
    decay_rate: float = 0.99
    grad_clip: float = 5.0
    rollout_num: int = 4
    generated_num: int = 1024
    adv_lr_scale: float = 1.0
    reward_delta: float = 16.0
    oracle_init: str = "normal"


class LeakGanTrainer:
    """G, D and oracle parameters with the three optimizer states on one
    ``device`` (default CUDA, which must exist; ``"cpu"`` on request), or on
    each rank of ``mesh`` (its device): ``data`` splits the corpus and the
    generated batches (the global batch is ``batch_size`` times the data
    size), ``model`` splits D by
    :func:`~music_tpu_torch.parallel.gan_tp.discriminator_specs` (every
    ``num_filters`` entry must divide by it)."""

    def __init__(self, tc: LeakGanTrainConfig, seed: int = 0, mesh: Mesh | None = None,
                 device: str | torch.device = "cuda"):
        self.tc = tc
        cfg = tc.cfg
        self.mesh = mesh
        self.par = gan_tp.TrainerMesh(mesh)
        if self.par.tp:
            gan_tp.check_filters(cfg, self.par.m)
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.keys = KeySeq(seed)
        self.g_params = lg.init_generator(self.keys.next(), cfg, tc.batch_size, self.device)
        self.d_specs = gan_tp.discriminator_specs(cfg)
        self.d_params = self.par.shard(lg.init_discriminator(self.keys.next(), cfg, self.device),
                                       self.d_specs)
        # the oracle of the NLL metric: an LSTM language model over the same
        # vocabulary, N(0, 1) everywhere by default
        self.oracle_cfg = sg.GeneratorConfig(
            vocab_size=cfg.vocab_size, emb_dim=cfg.worker_emb_dim,
            hidden_dim=cfg.worker_hidden, seq_len=cfg.seq_len, start_token=cfg.start_token)
        self.oracle_params = sg.init_generator(self.keys.next(), self.oracle_cfg,
                                               init=tc.oracle_init, device=self.device)

        def tx(lr, global_norm=None):
            return optim.chain(optim.clip_by_global_norm(tc.grad_clip, global_norm),
                               optim.adam(optim.step_lr(lr, tc.decay_step_size, tc.decay_rate)))

        self.m_tx, self.w_tx = tx(tc.m_lr), tx(tc.w_lr)
        self.d_tx = tx(tc.d_lr, self.par.global_norm(self.d_specs))
        # the adversarial learning rates: the same chain, so the Adam state
        # is shared with the supervised updates
        self.m_tx_adv = tx(tc.m_lr * tc.adv_lr_scale)
        self.w_tx_adv = tx(tc.w_lr * tc.adv_lr_scale)
        self.m_opt = self.m_tx.init(self.g_params["manager"])
        self.w_opt = self.w_tx.init(self.g_params["worker"])
        self.d_opt = self.d_tx.init(self.d_params)
        self._frozen_d, self._freeze_age = None, 0
        if self.par.tp:
            group = self.par.model_group
            self._d_forward = functools.partial(gan_tp.leakgan_forward_tp, group=group)
            self._dis_loss = functools.partial(gan_tp.leakgan_dis_loss_tp, group=group)
        else:
            self._d_forward, self._dis_loss = None, lg.dis_loss

    def _generator(self, local: bool = True) -> torch.Generator:
        """A fresh generator on the trainer's device, from the seed's stream:
        on a mesh this rank's (its data index folded in), or with
        ``local=False`` the one every rank draws alike."""
        return self.keys.next(self.device, self.par.data_index if local else 0)

    def _tokens(self, data: np.ndarray) -> torch.Tensor:
        """Host token ids, checked against the vocabulary, on the device."""
        check_token_ids(data, self.tc.cfg.vocab_size)
        return torch.from_numpy(np.asarray(data, np.int64)).to(self.device)

    def _whole_batches(self, data: np.ndarray, what: str) -> torch.Tensor:
        n = (len(data) // self.tc.batch_size) * self.tc.batch_size
        if n == 0:
            raise ValueError(f"{what} smaller than one batch")
        return self._tokens(data[:n])

    def _update_g(self, m_grads, w_grads, m_tx, w_tx) -> None:
        """Both modules' updates, on the gradients summed over ``data``."""
        grads = self.par.reduce_grads({"manager": m_grads, "worker": w_grads})
        m_grads, w_grads = grads["manager"], grads["worker"]
        with torch.no_grad():
            m_up, self.m_opt = m_tx.update(m_grads, self.m_opt, self.g_params["manager"])
            w_up, self.w_opt = w_tx.update(w_grads, self.w_opt, self.g_params["worker"])
            self.g_params = {
                "manager": optim.apply_updates(self.g_params["manager"], m_up),
                "worker": optim.apply_updates(self.g_params["worker"], w_up),
            }

    # ----- steps: one update each, on the given batch and draws ----------

    def pre_step(self, real_data: torch.Tensor, *, generator=None, noise=None,
                 dropout_generator=None, dropout_mask=None):
        """One pretraining update: the Manager on the cosine loss to the
        feature deltas, the Worker on its NLL, from one 'pre' engine pass.
        Returns ``(manager_loss, worker_loss)``."""
        cfg = self.tc.cfg
        g = optim.live(self.g_params)
        rets = lg.pre_engine(g, self.d_params, real_data, cfg=cfg, generator=generator,
                             noise=noise, dropout_generator=dropout_generator,
                             dropout_mask=dropout_mask, d_forward=self._d_forward)
        ml = self.par.loss(lg.pre_manager_loss(rets["real_goal"], rets["delta_feature"]))
        wl = self.par.loss(lg.pre_worker_loss(real_data, rets["prediction"], cfg.vocab_size))
        m_grads = optim.tree_grads(ml, g["manager"], retain_graph=True)
        w_grads = optim.tree_grads(wl, g["worker"])
        self._update_g(m_grads, w_grads, self.m_tx, self.w_tx)
        return ml.detach(), wl.detach()

    def d_step(self, tokens: torch.Tensor, labels: torch.Tensor, *, dropout_generator=None,
               dropout_mask=None) -> torch.Tensor:
        """One update of D on cross-entropy plus the output layer's L2."""
        self.d_params, self.d_opt, loss = optim.grad_update(
            self.d_tx, self.d_params, self.d_opt,
            lambda p: self.par.loss(self._dis_loss(p, tokens, labels, self.tc.cfg,
                                                   dropout_generator=dropout_generator,
                                                   dropout_mask=dropout_mask)),
            self.par.reduce_grads)
        return loss

    def adv_step(self, d_params: dict | None = None, *, generator=None, adv_noise=None,
                 rollout_noise=None, dropout_generator=None, dropout_mask=None):
        """One adversarial update of G against ``d_params`` (default the live
        D): an 'adv' engine pass (with dropout in D), rollout rewards of its
        tokens, and the Manager and Worker policy losses, whose sum is
        differentiated for both modules.  Returns ``(manager_loss,
        worker_loss)``."""
        tc, cfg = self.tc, self.tc.cfg
        d = self.d_params if d_params is None else d_params
        if generator is None and (adv_noise is None or rollout_noise is None):
            generator = self._generator()
        if dropout_generator is None and dropout_mask is None:
            dropout_generator = generator
        g = optim.live(self.g_params)
        rets = lg.adv_engine(g, d, tc.batch_size, cfg=cfg, temperature=cfg.temperature,
                             generator=generator, noise=adv_noise,
                             dropout_generator=dropout_generator, dropout_mask=dropout_mask,
                             d_forward=self._d_forward)
        rewards = lg.get_rewards(self.g_params, d, rets["gen_token"], cfg=cfg,
                                 rollout_num=tc.rollout_num, temperature=cfg.temperature,
                                 delta=tc.reward_delta, generator=generator,
                                 noise=rollout_noise, d_forward=self._d_forward,
                                 group=self.par.data_group)
        ml = self.par.loss(lg.adv_manager_loss(rewards, rets["real_goal"], rets["delta_feature"]))
        wl = self.par.loss(lg.adv_worker_loss(rets["all_goal"], rets["delta_feature_for_worker"],
                                              rets["gen_token"], rets["prediction"],
                                              cfg.vocab_size))
        grads = optim.tree_grads(ml + wl, g)
        self._update_g(grads["manager"], grads["worker"], self.m_tx_adv, self.w_tx_adv)
        return ml.detach(), wl.detach()

    # ----- phases ---------------------------------------------------------

    def _shuffled(self, n: int) -> torch.Tensor:
        """A permutation of ``n`` rows cut to whole batches, on the device."""
        perm = torch.randperm(n, generator=self.keys.next(index=self.par.data_index))
        return perm[: (n // self.tc.batch_size) * self.tc.batch_size].to(self.device)

    def _gen_batches(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """``n`` of G's samples from whole batches of ``batch_size`` (one
        ``goal_init`` row per batch row), all in one engine pass."""
        cfg = self.tc.cfg
        n_batches = -(-n // self.tc.batch_size)
        rows = self.g_params["manager"]["goal_init"].repeat(n_batches, 1)
        return lg.gen_samples(self.g_params, self.d_params, len(rows), cfg=cfg,
                              temperature=cfg.temperature, generator=generator,
                              goal_init_rows=rows, d_forward=self._d_forward)[:n]

    def generate_samples(self, n: int, out_path: str | Path | None = None) -> np.ndarray:
        """``n`` negative samples (on a mesh, the same on every rank);
        written as ``.npy`` to ``out_path`` if given (by the mesh's first
        rank)."""
        samples = self._gen_batches(n, self._generator(local=False))
        samples = samples.cpu().numpy().astype(np.int32)
        if out_path is not None and (self.mesh is None or self.mesh.is_main):
            Path(out_path).parent.mkdir(parents=True, exist_ok=True)
            np.save(out_path, samples)
        return samples

    def _my_rows(self, data: np.ndarray, what: str) -> torch.Tensor:
        """This rank's rows of the whole batches of ``data``."""
        data = self._whole_batches(data, what)
        return data[self.par.rows(len(data))]

    def pretrain_generator(self, real_data: np.ndarray, epochs: int = 1):
        """Interleaved Manager/Worker pretraining epochs over shuffled
        batches (on a mesh, of this rank's rows); the last batch's
        ``(manager_loss, worker_loss)``."""
        data = self._my_rows(real_data, "real_data")
        gen = self._generator()
        ml = wl = None
        for _ in range(epochs):
            for rows in self._shuffled(len(data)).split(self.tc.batch_size):
                ml, wl = self.pre_step(data[rows], generator=gen, dropout_generator=gen)
        return float(ml), float(wl)

    def pretrain_discriminator(self, real_data: np.ndarray, epochs: int = 1) -> float:
        """Regenerate as many negatives as positives, then ``epochs``
        shuffled cross-entropy epochs over the 2N rows (on a mesh, N this
        rank's rows); the last loss."""
        real = self._my_rows(real_data, "real_data")
        N = len(real)
        gen = self._generator()
        tokens = torch.cat([real, self._gen_batches(N, gen)])
        labels = torch.cat([torch.ones(N, dtype=torch.long),
                            torch.zeros(N, dtype=torch.long)]).to(self.device)
        loss = None
        for _ in range(epochs):
            for rows in self._shuffled(2 * N).split(self.tc.batch_size):
                loss = self.d_step(tokens[rows], labels[rows], dropout_generator=gen)
        return float(loss)

    def adversarial_epoch(self, real_data: np.ndarray, d_steps: int = 5, d_epochs: int = 3,
                          interleave_supervision: int = 0, d_freeze_refresh: int = 0):
        """One adversarial round: a G update on rollout rewards, then D
        retraining on fresh negatives; ``(manager_loss, worker_loss,
        d_loss)``.

        ``interleave_supervision``: that many pretraining epochs right after
        the G update (D then retrains against the supervised G).
        ``d_freeze_refresh=K``: G reads its leaked features and rewards from
        a snapshot of D refreshed every K rounds, while the live D trains on.
        The snapshot is not part of :meth:`state`, so a resumed run takes a
        new one on its first round."""
        if d_freeze_refresh > 0:
            if self._frozen_d is None or self._freeze_age >= d_freeze_refresh:
                self._frozen_d = optim.tree_map(torch.clone, self.d_params)
                self._freeze_age = 0
            self._freeze_age += 1
            d_for_g = self._frozen_d
        else:
            self._frozen_d = None
            d_for_g = self.d_params
        ml, wl = self.adv_step(d_for_g)
        if interleave_supervision:
            self.pretrain_generator(real_data, epochs=interleave_supervision)
        d_loss = 0.0
        for _ in range(d_steps):
            d_loss = self.pretrain_discriminator(real_data, epochs=d_epochs)
        return float(ml), float(wl), d_loss

    @torch.no_grad()
    def oracle_nll(self, noise: torch.Tensor | None = None) -> float:
        """NLL under the oracle of one batch of G's samples."""
        cfg = self.tc.cfg
        gen = None if noise is not None else self._generator(local=False)
        samples = lg.gen_samples(self.g_params, self.d_params, self.tc.batch_size, cfg=cfg,
                                 temperature=cfg.temperature, generator=gen, noise=noise,
                                 d_forward=self._d_forward)
        return float(sg.generator_nll(self.oracle_params, samples, self.oracle_cfg))

    def oracle_samples(self, n: int) -> np.ndarray:
        """Synthetic real data: ``n`` sequences from the oracle (the same on
        every rank of a mesh)."""
        gen = self._generator(local=False)
        out = [sg.generate(self.oracle_params, self.oracle_cfg, self.tc.batch_size,
                           generator=gen) for _ in range(-(-n // self.tc.batch_size))]
        return torch.cat(out).cpu().numpy().astype(np.int32)[:n]

    @torch.no_grad()
    def eval_nll(self, data: np.ndarray, noise: torch.Tensor | None = None) -> float:
        """Mean teacher-forced per-token NLL (nats) of G over held-out
        sequences, in whole batches (``goal_init`` has one row per batch
        row).  ``noise``: one ``[seq_len + 1, batch, V]`` slab per batch for
        the Worker's free-running draws."""
        data = self._whole_batches(data, "data")
        gen = None if noise is not None else self._generator(local=False)
        vals = []
        for i, batch in enumerate(data.split(self.tc.batch_size)):
            rets = lg.pre_engine(self.g_params, self.d_params, batch, cfg=self.tc.cfg,
                                 generator=gen, noise=None if noise is None else noise[i],
                                 d_forward=self._d_forward)
            logp = torch.log(torch.clamp(rets["prediction"], 1e-20, 1.0))
            vals.append(-torch.gather(logp, -1, batch[..., None]).mean())
        return float(np.mean([float(v) for v in vals]))

    # ------------------------------------------------------------------

    def state(self) -> dict[str, Any]:
        """The full training state, under the JAX ``state()``'s keys; on a
        ``model`` mesh D and its Adam moments gathered whole (every rank
        must call it)."""
        gather = functools.partial(self.par.gather, specs=self.d_specs)
        return {"g_params": self.g_params, "d_params": gather(self.d_params),
                "m_opt": self.m_opt, "w_opt": self.w_opt,
                "d_opt": gan_tp.map_param_trees(self.d_opt, gather)}

    def save(self, ckpt_dir: str | Path, step: int, max_checkpoints: int = 10):
        """Write :meth:`state` (on a mesh, every rank calls it and the first
        writes)."""
        ckpt_lib.save(ckpt_dir, step, self.state(), max_checkpoints=max_checkpoints,
                      mesh=self.mesh)

    def restore(self, ckpt_dir: str | Path) -> int:
        """Resume from the latest checkpoint in ``ckpt_dir`` (either
        package's, from any mesh); the step, 0 when there is none."""
        state, step = ckpt_lib.restore_or_init(ckpt_dir, self.state())
        shard = functools.partial(self.par.shard, specs=self.d_specs)
        self.g_params, self.d_params = state["g_params"], shard(state["d_params"])
        self.m_opt, self.w_opt = state["m_opt"], state["w_opt"]
        self.d_opt = gan_tp.map_param_trees(state["d_opt"], shard)
        return step
