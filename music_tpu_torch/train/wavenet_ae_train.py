"""WaveNet-autoencoder training on one device (counterpart of
:mod:`music_tpu.train.wavenet_ae_train`): the WaveNet trainer's loop over
the autoencoder's reconstruction loss,
:func:`~music_tpu_torch.models.wavenet_ae.loss_fn`.  Not here: the mesh
(sequence-parallel encoder and decoder, tensor-parallel skip path).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from music_tpu_torch.core import checkpoint as ckpt_lib
from music_tpu_torch.core import optim
from music_tpu_torch.core.metrics import MetricsLogger
from music_tpu_torch.core.prng import KeySeq
from music_tpu_torch.data.audio import AudioWindows
from music_tpu_torch.generate.wavenet_generate import resolve_device
from music_tpu_torch.models import wavenet_ae as ae
from music_tpu_torch.train import wavenet_train
from music_tpu_torch.train.wavenet_train import TrainState


def make_train_step(cfg: ae.WaveNetAEConfig, tx: optim.GradientTransformation):
    """``train_step(state, tokens) -> (state, loss)`` on the reconstruction
    loss."""
    return wavenet_train.step_fn(lambda p, t: ae.loss_fn(p, t, cfg), tx)


def train(
    *,
    model_params: Mapping[str, Any],
    dataset_params: Mapping[str, Any],
    train_params: Mapping[str, Any],
    device: str | torch.device = "cuda",
) -> TrainState:
    """Train the autoencoder from JSON param dicts (the JAX package's
    ``train()`` on one device); ``device`` as in
    :func:`music_tpu_torch.train.wavenet_train.train`."""
    wavenet_train.check_single_device(train_params)
    device = resolve_device(device)
    cfg = ae.WaveNetAEConfig.from_json(dict(model_params))
    tx = optim.from_config(train_params)
    keys = KeySeq(train_params.get("seed", 0))
    windows = AudioWindows.from_pickle(
        dataset_params["audio_path"], receptive_field=cfg.receptive_field,
        window_length=dataset_params["window_length"],
    )
    windows.check_vocab(cfg.quantization_channel)
    logger = MetricsLogger(train_params.get("log_dir", "logs/wavenet_ae"))
    ckpt_dir = train_params.get("restore_dir", "checkpoints/wavenet_ae")

    params = ae.init_params(cfg, keys.next(), device=device)
    state = TrainState(params, tx.init(params), torch.zeros((), dtype=torch.int32,
                                                            device=device))
    state, start_step = ckpt_lib.restore_or_init(ckpt_dir, state)
    return wavenet_train.run_epochs(
        state, make_train_step(cfg, tx), windows, dataset_params=dataset_params,
        train_params=train_params, logger=logger, ckpt_dir=ckpt_dir, start_step=start_step,
        device=device)
