"""The WaveNet family on the program: serving through
``generate.serving.DecodeSession`` and training through
``train.wavenet_train.make_train_step``; the check against
:mod:`portbench.reference.wavenet`."""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights
from portbench.reference import wavenet as ref
from portbench.reference.common import receptive_field
from portbench.reference.philox import gumbel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SEED_STRIDE = 7919
"""How far a session's seed moves a call (mod 2**31), as ``DecodeSession``
documents."""
ADAM_B1 = 0.9
"""optax's first-moment decay, the program's default: after one step the
first moment is ``(1 - b1)`` times the gradient."""


def make_weights(config: dict, seed: int, device) -> dict:
    m = config["model"]
    return weights.make(ref.param_shapes(m), ref.fan_in(m), seed, device)


def reference_loss(config: dict):
    m = config["model"]
    return lambda params, tokens, prec="f32": ref.loss(params, tokens, m, prec)


def vocab(config: dict) -> int:
    return config["model"]["quantization_channels"]


def prime_len(m: dict) -> int:
    """Codes a session primes each call from: the receptive field and the
    largest dilation."""
    return receptive_field(m) + max(m["dilations"])


class Server:
    """The card's tile of WaveNet streams in one ``DecodeSession``; each
    clip is a stream admitted with the session's default prompt (µ-law
    silence) and finished after its length.  The mix's ``clients`` is a
    number, or ``"tile"``: the card's SMs times the decode kernel's most
    streams a block, every block of the card full."""

    def __init__(self, config: dict, traffic: dict, seeds: list[int], device):
        from music_tpu_torch.generate import wavenet_generate
        from music_tpu_torch.generate.serving import DecodeSession
        from music_tpu_torch.kernels import wavenet_decode
        from music_tpu_torch.models.wavenet import WaveNetConfig

        self.m, self.t = config["model"], traffic
        cfg = WaveNetConfig.from_json(self.m)
        dtype = DTYPES[traffic["dtype"]]
        device = torch.device(device)
        per_block = wavenet_decode.max_streams(cfg, dtype)
        self.clients = traffic["clients"]
        if self.clients == "tile":
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            self.clients = sms * per_block
        params = make_weights(config, seeds[0], device)
        self.ref_params = {k: v.clone() for k, v in params.items()}
        self.seed0 = seeds[1] % 2**31
        self.sess = DecodeSession(cfg, params, capacity=self.clients, dtype=dtype,
                                  sample_mode=traffic["sample_mode"],
                                  temperature=traffic["temperature"], seed=self.seed0,
                                  steps_per_call=traffic["steps_per_call"], device=device)
        S, G = wavenet_generate.stream_tiling(self.clients, device, per_block)
        self.rows_launched = S * G

    def join(self, clip) -> int:
        return self.sess.add()

    def rows(self) -> dict[int, int]:
        """The row of every active stream in the next call (the order the
        session packs them in)."""
        return {sid: i for i, sid in enumerate(self.sess.active)}

    def step(self) -> dict[int, np.ndarray]:
        return self.sess.step()

    def finish(self, sid: int) -> None:
        self.sess.finish(sid)

    def close(self) -> None:
        del self.sess

    def _noise(self, clip, device) -> torch.Tensor | None:
        """The Gumbel noise of each of the clip's draws, from the call and
        row that drew it."""
        if self.t["sample_mode"] != "categorical":
            return None
        parts = []
        for call, row, n in clip.draws:
            seed = (self.seed0 + call * SEED_STRIDE) % 2**31
            rows = torch.full((n,), row, dtype=torch.int64, device=device)
            parts.append(gumbel(seed, rows, torch.arange(n, device=device), self.m[
                "quantization_channels"]))
        return torch.cat(parts)

    @torch.no_grad()
    def gap(self, clip, prec: str = "f32") -> float:
        """The widest gap by which a clip's served code (``prec="f32"``), or
        the code the reference in ``prec`` ranks first, scores below the
        reference's best: scores are logits over the temperature plus the
        draw's noise (categorical), or the logits (argmax)."""
        device = self.ref_params["causal"].device
        P, RF = prime_len(self.m), receptive_field(self.m)
        served = torch.as_tensor(np.concatenate(clip.tokens)[: clip.length], device=device)
        prompt = torch.full((P,), self.m["quantization_channels"] // 2, dtype=torch.int32,
                            device=device)
        x = torch.cat([prompt, served.to(torch.int32)])[P - RF : P + clip.length - 1][None]
        noise = self._noise(clip, device)
        temp = self.t["temperature"] if noise is not None else 1.0

        def scores(p):
            s = ref.logits(self.ref_params, x, self.m, p)[0] / temp
            return s if noise is None else s + noise

        best = scores("f32")
        chosen = served.long() if prec == "f32" else torch.argmax(scores(prec), dim=-1)
        return float((best.max(dim=-1).values - best.gather(1, chosen[:, None])[:, 0]).max())


class Trainer:
    """One ``TrainState`` and the step of ``make_train_step`` (float32,
    one skip product a layer: the trainer's defaults)."""

    def __init__(self, config: dict, traffic: dict, seeds: list[int], device):
        from music_tpu_torch.core import optim
        from music_tpu_torch.models.wavenet import WaveNetConfig
        from music_tpu_torch.train import wavenet_train

        cfg = WaveNetConfig.from_json(config["model"])
        params = make_weights(config, seeds[0], device)
        self.params0 = {k: v.clone() for k, v in params.items()}
        tx = optim.from_config(traffic["optimizer"])
        self.state = wavenet_train.TrainState(
            params, tx.init(params), torch.zeros((), dtype=torch.int32, device=device))
        self._step = wavenet_train.make_train_step(cfg, tx)

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        self.state, loss = self._step(self.state, tokens)
        return loss

    def params(self) -> dict:
        return self.state.params

    def first_grads(self) -> dict:
        """The first step's gradient as the optimizer took it, from its
        state after that step."""
        return {k: v / (1 - ADAM_B1) for k, v in self.state.opt_state[0].mu.items()}

    def close(self) -> None:
        del self.state, self._step
