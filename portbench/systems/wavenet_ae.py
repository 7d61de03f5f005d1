"""The WaveNet autoencoder on the program: training through
``train.wavenet_ae_train.make_train_step``; the check against
:mod:`portbench.reference.wavenet_ae`."""

from __future__ import annotations

import torch

from portbench import weights
from portbench.reference import wavenet_ae as ref
from portbench.systems.wavenet import Trainer as _WaveNetTrainer


def make_weights(config: dict, seed: int, device) -> dict:
    m = config["model"]
    return weights.make(ref.param_shapes(m), ref.fan_in(m), seed, device)


def reference_loss(config: dict):
    m = config["model"]
    return lambda params, tokens, prec="f32": ref.loss(params, tokens, m, prec)


def vocab(config: dict) -> int:
    return config["model"]["quantization_channel"]


class Trainer(_WaveNetTrainer):
    """One ``TrainState`` and the step of ``wavenet_ae_train.make_train_step``."""

    def __init__(self, config: dict, traffic: dict, seeds: list[int], device):
        from music_tpu_torch.core import optim
        from music_tpu_torch.models.wavenet_ae import WaveNetAEConfig
        from music_tpu_torch.train import wavenet_ae_train, wavenet_train

        cfg = WaveNetAEConfig.from_json(config["model"])
        params = make_weights(config, seeds[0], device)
        self.params0 = {k: v.clone() for k, v in params.items()}
        tx = optim.from_config(traffic["optimizer"])
        self.state = wavenet_train.TrainState(
            params, tx.init(params), torch.zeros((), dtype=torch.int32, device=device))
        self._step = wavenet_ae_train.make_train_step(cfg, tx)
