"""C-RNN-GAN training on one device (counterpart of
:mod:`music_tpu.train.crnngan_train`).

Flow: feature-normalize the MIDI event tensors (:class:`FeatureScaler`),
pretrain G on the MSE of its teacher-forced outputs, then alternate GAN
steps with the paper's freezing rule (D trains only while its accuracy is
below ``d_too_strong``) and feature matching for G when D saturates.  G
may be conditioned on the per-song genre/composer one-hot rows
(``CRnnGanConfig.meta_dim``).  Both optimizers are
``clip_by_global_norm(5) + adam(lr)`` with optax's rules and state layout
(:mod:`music_tpu_torch.core.optim`); checkpoints of :meth:`state` carry
the JAX ``state()``'s key paths (``['g_params']['fc1']['w']``,
``['d_opt'][1][0].mu...``), so either package resumes the other's.

The JAX trainer's single-program GAN step is :meth:`CRnnGanTrainer.gan_step`
here: its two ``lax.cond`` gates are read on the host (D's accuracy, and in
``"auto"`` mode D's mean decision on the fakes), and only the chosen
branch's arithmetic runs.  The steps take their noise (``[T, B,
noise_dim]`` uniforms; a test feeds JAX's) or draw it from the seed's
stream of ``torch.Generator``s.  Batch orders are JAX's
(``np.random.default_rng(epoch)`` while pretraining, ``default_rng(0)`` for
every GAN epoch).

``mesh=`` runs it on a ``(data, seq, model)`` mesh of ranks
(:class:`~music_tpu_torch.parallel.gan_tp.TrainerMesh`): each data rank
takes its rows of every batch and its own noise, the losses are averaged
and the gradients summed over ``data``, feature matching averages the
feature means over the batch, and both gates read D's statistics averaged
over ``data``, so that every rank takes the same branch (a rank that took
the other alone would wait on a collective the rest never call).  With
``model``, D is stored gate-repacked and split over the hidden units
(:mod:`music_tpu_torch.parallel.rnn_tp`); :meth:`CRnnGanTrainer.state`
gathers and unpacks it, so checkpoints hold torch's gate order whatever
the mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from music_tpu_torch.core import checkpoint as ckpt_lib
from music_tpu_torch.core import optim
from music_tpu_torch.core.prng import KeySeq
from music_tpu_torch.generate.wavenet_generate import resolve_device
from music_tpu_torch.models import crnngan as cg
from music_tpu_torch.parallel import gan_tp
from music_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class CRnnGanTrainConfig:
    """The JAX package's ``CRnnGanTrainConfig`` (same fields and defaults).

    ``g_objective``: ``"auto"`` = adversarial, switching to feature matching
    while D's mean decision on the fakes is below ``feature_matching_below``;
    ``"fm"`` = always feature matching; ``"adv"`` = always adversarial."""

    cfg: cg.CRnnGanConfig = dataclasses.field(default_factory=cg.CRnnGanConfig)
    batch_size: int = 4
    g_lr: float = 1e-3
    d_lr: float = 1e-3
    grad_clip: float = 5.0
    d_too_strong: float = 0.9
    feature_matching_below: float = 0.1
    g_objective: str = "auto"


class FeatureScaler:
    """Per-feature affine normalization of event tensors (tick/length/freq/
    velocity live on very different scales); invertible for generation."""

    def __init__(self, data: np.ndarray):
        flat = data.reshape(-1, data.shape[-1])
        self.mean = flat.mean(axis=0)
        self.std = flat.std(axis=0) + 1e-6

    def transform(self, x):
        return (x - self.mean) / self.std

    def inverse(self, x):
        return x * self.std + self.mean


class GanStep(NamedTuple):
    """What one GAN step did: its losses and D's accuracy (tensors), whether
    D was trained (else frozen) and whether G took feature matching."""

    g_loss: torch.Tensor
    d_loss: torch.Tensor
    d_acc: torch.Tensor
    d_trained: bool
    feature_matching: bool


class CRnnGanTrainer:
    """G and D parameters with their optimizer states on one ``device``
    (default CUDA, which must exist; ``"cpu"`` on request), or on each rank
    of ``mesh`` (its device; the ``model`` size must divide the hidden
    width)."""

    def __init__(self, tc: CRnnGanTrainConfig, seed: int = 0, mesh: Mesh | None = None,
                 device: str | torch.device = "cuda"):
        if tc.g_objective not in ("auto", "fm", "adv"):
            raise ValueError(f"unknown g_objective {tc.g_objective!r}")
        self.tc = tc
        self.mesh = mesh
        self.par = gan_tp.TrainerMesh(mesh)
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.keys = KeySeq(seed)
        self.g_params = cg.init_generator(self.keys.next(), tc.cfg, self.device)
        self.d_specs = gan_tp.crnngan_d_specs()
        self.d_params = self._d_layout(cg.init_discriminator(self.keys.next(), tc.cfg,
                                                             self.device))
        self.g_tx = optim.chain(optim.clip_by_global_norm(tc.grad_clip), optim.adam(tc.g_lr))
        self.d_tx = optim.chain(
            optim.clip_by_global_norm(tc.grad_clip, self.par.global_norm(self.d_specs)),
            optim.adam(tc.d_lr))
        self.g_opt = self.g_tx.init(self.g_params)
        self.d_opt = self.d_tx.init(self.d_params)
        self._d_forward = (functools.partial(gan_tp.crnngan_forward_tp,
                                             group=self.par.model_group)
                           if self.par.tp else cg.discriminator_forward)

    def _d_layout(self, d_params: dict) -> dict:
        """Whole D in torch's gate order -> the layout the trainer keeps it
        in: on a ``model`` mesh repacked and this rank's blocks."""
        if not self.par.tp:
            return d_params
        return self.par.shard(gan_tp.repack_crnngan_d(d_params, self.par.m), self.d_specs)

    def _torch_layout(self, d_params: dict) -> dict:
        """The inverse of :meth:`_d_layout`: whole, in torch's gate order."""
        if not self.par.tp:
            return d_params
        return gan_tp.unpack_crnngan_d(self.par.gather(d_params, self.d_specs), self.par.m)

    def _noise(self, n: int, length: int, batch: int, generator, noise) -> torch.Tensor:
        """``n`` noise slabs ``[length, batch, noise_dim]``: ``noise`` or a
        draw from ``generator`` (default a fresh one of the seed's stream)."""
        shape = (n, length, batch, self.tc.cfg.noise_dim)
        if noise is not None:
            noise = torch.as_tensor(noise)
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise {tuple(noise.shape)} != expected {shape}")
            return noise.to(self.device, torch.float32)
        generator = generator or self.keys.next(self.device, self.par.data_index)
        return torch.rand(shape, generator=generator, device=self.device)

    def _meta(self, meta) -> torch.Tensor | None:
        if self.tc.cfg.meta_dim == 0 or meta is None:
            return None
        return torch.as_tensor(meta, dtype=torch.float32).to(self.device)

    # ----- steps: one update each, on the given batch and noise -----------

    def pre_step(self, real: torch.Tensor, meta: torch.Tensor | None = None, *,
                 generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
        """One MSE pretraining update of G on ``real [B, T, 4]`` (on a mesh,
        this rank's rows); ``noise`` ``[1, T, B, noise_dim]``.  Returns the
        loss."""
        cfg = self.tc.cfg
        noise = self._noise(1, real.shape[1], real.shape[0], generator, noise)[0]
        meta = self._meta(meta)
        self.g_params, self.g_opt, loss = optim.grad_update(
            self.g_tx, self.g_params, self.g_opt,
            lambda p: self.par.loss(cg.g_pretrain_loss(p, real, cfg, meta, noise=noise)),
            self.par.reduce_grads)
        return loss

    def gan_step(self, real: torch.Tensor, meta: torch.Tensor | None = None, *,
                 generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None) -> GanStep:
        """One GAN step, the JAX trainer's single program: G's fakes from
        ``noise[0]``; D's decisions on real and fake give its accuracy, its
        mean decision on the fakes and its BCE loss (one forward each); D
        takes an update while its accuracy is below ``d_too_strong`` (else
        neither D nor its Adam state moves); then G takes one against the
        updated D, by feature matching (fakes from ``noise[1]``) or
        adversarially (``noise[2]``) as ``g_objective`` says.  ``noise``:
        ``[3, song_length, B, noise_dim]``.

        On a mesh ``real``, ``meta`` and ``noise`` are this rank's rows; the
        losses, D's accuracy and its mean decision on the fakes are the
        global batch's (averaged over ``data`` before the gates read them)."""
        tc, cfg, par = self.tc, self.tc.cfg, self.par
        B = real.shape[0]
        noise = self._noise(3, cfg.song_length, B, generator, noise)
        meta = self._meta(meta)
        with torch.no_grad():
            fake = cg.generate(self.g_params, cfg, B, meta=meta, noise=noise[0])
        d_live = optim.live(self.d_params)
        (p_real, _), (p_fake, _) = cg.discriminator_pair(d_live, real, fake, cfg, meta,
                                                         self._d_forward)
        d_loss = par.loss(cg.d_loss_from(p_real, p_fake))
        d_acc = 0.5 * ((p_real > 0.5).float().mean() + (p_fake < 0.5).float().mean())
        d_acc, mean_p_fake = par.mean(torch.stack([d_acc, p_fake.detach().float().mean()]))
        # both gates compare in float32, as lax.cond's predicates do
        d_trained = bool(d_acc < tc.d_too_strong)
        if d_trained:
            grads = par.reduce_grads(optim.tree_grads(d_loss, d_live))
            with torch.no_grad():
                updates, self.d_opt = self.d_tx.update(grads, self.d_opt, self.d_params)
                self.d_params = optim.apply_updates(self.d_params, updates)
        fm = tc.g_objective == "fm" or (
            tc.g_objective == "auto" and bool(mean_p_fake < tc.feature_matching_below))
        del d_live, p_real, p_fake

        def g_loss(g):
            if fm:  # global already: the feature means are averaged over (data, seq)
                return cg.g_feature_matching_loss(g, self.d_params, real, cfg, meta,
                                                  noise=noise[1], d_forward=self._d_forward,
                                                  group=par.loss_group)
            return par.loss(cg.g_adv_loss(g, self.d_params, B, cfg, meta, noise=noise[2],
                                            d_forward=self._d_forward))

        self.g_params, self.g_opt, gl = optim.grad_update(self.g_tx, self.g_params,
                                                          self.g_opt, g_loss, par.reduce_grads)
        return GanStep(gl, d_loss.detach(), d_acc, d_trained, fm)

    # ----- phases -----------------------------------------------------------

    def _batches(self, data: np.ndarray, meta: np.ndarray | None, order: np.ndarray):
        """``(real, meta)`` batches of ``batch_size`` rows in ``order`` (the
        last partial batch dropped), on the device; on a mesh this rank's
        rows of each."""
        B = self.tc.batch_size
        data_t = torch.from_numpy(np.asarray(data, np.float32)).to(self.device)
        meta_t = self._meta(meta)
        order_t = torch.from_numpy(np.asarray(order, np.int64)).to(self.device)
        for i in range(0, len(data) - B + 1, B):
            idx = order_t[i : i + B][self.par.rows(B)]
            yield data_t[idx], (None if meta_t is None else meta_t[idx])

    def pretrain(self, data: np.ndarray, epochs: int = 1,
                 meta: np.ndarray | None = None) -> float:
        """``epochs`` of MSE pretraining over ``data [N, T, 4]``; the last
        step's loss."""
        last = torch.zeros(())
        for epoch in range(epochs):
            order = np.random.default_rng(epoch).permutation(len(data))
            for real, meta_b in self._batches(data, meta, order):
                last = self.pre_step(real, meta_b)
        return float(last)

    def gan_epoch(self, data: np.ndarray, meta: np.ndarray | None = None):
        """One epoch of GAN steps (the JAX batch order: ``default_rng(0)``
        every epoch); the last step's ``(g_loss, d_loss, d_acc)``."""
        step = None
        order = np.random.default_rng(0).permutation(len(data))
        for real, meta_b in self._batches(data, meta, order):
            step = self.gan_step(real, meta_b)
        if step is None:
            return 0.0, 0.0, 0.0
        return float(step.g_loss), float(step.d_loss), float(step.d_acc)

    # ----- checkpoints ------------------------------------------------------

    def state(self) -> dict:
        """The training state under the JAX ``state()``'s keys, D and its
        Adam moments whole and in torch's gate order whatever the mesh
        (every rank of a mesh must call it)."""
        return {"g_params": self.g_params, "d_params": self._torch_layout(self.d_params),
                "g_opt": self.g_opt,
                "d_opt": gan_tp.map_param_trees(self.d_opt, self._torch_layout)}

    def save(self, ckpt_dir: str | Path, step: int):
        """Write :meth:`state` (on a mesh, every rank calls it and the first
        writes)."""
        ckpt_lib.save(ckpt_dir, step, self.state(), mesh=self.mesh)

    def restore(self, ckpt_dir: str | Path) -> int:
        """Resume from the latest checkpoint in ``ckpt_dir`` (either
        package's, from any mesh); the step, 0 when there is none."""
        state, step = ckpt_lib.restore_or_init(ckpt_dir, self.state())
        self.g_params, self.d_params = state["g_params"], self._d_layout(state["d_params"])
        self.g_opt = state["g_opt"]
        self.d_opt = gan_tp.map_param_trees(state["d_opt"], self._d_layout)
        return step
