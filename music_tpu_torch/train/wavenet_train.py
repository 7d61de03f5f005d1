"""WaveNet training on one device (counterpart of
:mod:`music_tpu.train.wavenet_train`).

``train()`` reads the same JSON param dicts as the JAX package's: it
resumes from the latest checkpoint in ``restore_dir`` (or starts from a
seeded init), takes one pass of shuffled windows an epoch through a
prefetch thread, logs the mean loss every ``print_every`` steps in the
JAX package's text format and saves a rotating checkpoint at each epoch's
end.  The checkpoints hold the JAX ``TrainState``'s leaves under its key
paths (``.params[...]``, ``.opt_state[...]``, ``.step``), so either package
resumes from the other's.

The loss is the model's :func:`~music_tpu_torch.models.wavenet.loss_fn`
with fused taps, the JAX trainer's ``_sharded_loss`` on one device.
``compute_dtype: "bfloat16"`` casts the parameters to bf16 inside the loss
and keeps the log-softmax in float32, as the JAX trainer does (its
rounding points, not ``torch.autocast``'s).  Not here: the mesh (data,
sequence and tensor parallelism, multi-process) and the opt-in stacked or
blocked skip GEMMs (ROADMAP.md, queue A).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch

from music_tpu_torch.core import checkpoint as ckpt_lib
from music_tpu_torch.core import optim
from music_tpu_torch.core.metrics import Meter, MetricsLogger, Throughput
from music_tpu_torch.core.prng import KeySeq
from music_tpu_torch.data.audio import AudioWindows
from music_tpu_torch.data.prefetch import PrefetchBatches
from music_tpu_torch.generate.wavenet_generate import resolve_device
from music_tpu_torch.models import wavenet as wn

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """Parameters, optimizer state and the update count (an int32 scalar
    tensor), laid out as the JAX package's ``TrainState``."""

    params: dict
    opt_state: Any
    step: torch.Tensor


def init_state(generator: torch.Generator, cfg: wn.WaveNetConfig,
               tx: optim.GradientTransformation,
               device: str | torch.device = "cpu") -> TrainState:
    params = wn.init_params(cfg, generator, device=device)
    return TrainState(params, tx.init(params),
                      torch.zeros((), dtype=torch.int32, device=params["fg"].device))


def step_fn(loss_fn: Callable, tx: optim.GradientTransformation):
    """``train_step(state, tokens) -> (state, loss)``: the gradients of
    ``loss_fn(params, tokens)`` and one optimizer update."""

    def train_step(state: TrainState, tokens: torch.Tensor):
        params, opt_state, loss = optim.grad_update(
            tx, state.params, state.opt_state, lambda p: loss_fn(p, tokens))
        return TrainState(params, opt_state, state.step + 1), loss

    return train_step


def make_train_step(cfg: wn.WaveNetConfig, tx: optim.GradientTransformation,
                    compute_dtype: torch.dtype | None = None):
    """One update on :func:`~music_tpu_torch.models.wavenet.loss_fn` with
    fused taps, in ``compute_dtype`` when given (see :func:`step_fn`)."""
    return step_fn(lambda params, tokens: wn.loss_fn(
        params, tokens, cfg, fuse_taps=True, compute_dtype=compute_dtype), tx)


def _staged(batches: Iterator[np.ndarray], device: torch.device) -> Iterator[torch.Tensor]:
    """Each batch as a tensor on ``device``; on CUDA through pinned memory
    and a copy that does not block the host."""
    for batch in batches:
        tokens = torch.from_numpy(batch)
        if device.type == "cuda":
            tokens = tokens.pin_memory().to(device, non_blocking=True)
        yield tokens


def check_single_device(train_params: Mapping[str, Any]) -> None:
    if train_params.get("coordinator") or train_params.get("num_processes"):
        raise NotImplementedError(
            "multi-process training is not ported yet (ROADMAP.md, A11); drop "
            "coordinator/num_processes from train_params")


def run_epochs(state: TrainState, train_step: Callable, windows: AudioWindows, *,
               dataset_params: Mapping[str, Any], train_params: Mapping[str, Any],
               logger: MetricsLogger, ckpt_dir: str | Path, start_step: int,
               device: torch.device) -> TrainState:
    """The epoch loop both trainers share: per epoch one pass of
    ``windows.batches(batch_size, seed=seed + epoch)`` through a prefetch
    thread, the mean loss logged every ``print_every`` steps, a rotating
    checkpoint at the epoch's end."""
    meter, thru = Meter(), Throughput()
    print_every = train_params.get("print_every", 100)
    seed = train_params.get("seed", 0)
    step = start_step
    for epoch in range(train_params.get("num_epochs", 1)):
        batches = windows.batches(dataset_params["batch_size"], seed=seed + epoch)
        for tokens in PrefetchBatches(_staged(batches, device)):
            state, loss = train_step(state, tokens)
            step += 1
            meter.update(float(loss))
            thru.update(tokens.shape[0])
            if step % print_every == 0:
                logger.log_loss(epoch, step, meter.mean, pieces_per_sec=round(thru.rate, 2))
                meter.reset()
        ckpt_lib.save(ckpt_dir, step, state,
                      max_checkpoints=train_params.get("max_check_points", 10))
        logger.log_event(f"saved checkpoint at step {step}")
    return state


def train(
    *,
    wavenet_params: Mapping[str, Any],
    dataset_params: Mapping[str, Any],
    train_params: Mapping[str, Any],
    device: str | torch.device = "cuda",
) -> TrainState:
    """Train WaveNet from JSON param dicts (the JAX package's ``train()``
    on one device).  ``device`` defaults to CUDA and raises without a card;
    ask for ``"cpu"`` to train on the CPU."""
    check_single_device(train_params)
    device = resolve_device(device)
    cfg = wn.WaveNetConfig.from_json(dict(wavenet_params))
    tx = optim.from_config(train_params)
    keys = KeySeq(train_params.get("seed", 0))
    windows = AudioWindows.from_pickle(
        dataset_params["audio_path"], receptive_field=cfg.receptive_field,
        window_length=dataset_params["window_length"],
    )
    windows.check_vocab(cfg.quantization_channels)
    logger = MetricsLogger(train_params.get("log_dir", "logs/wavenet"))
    ckpt_dir = train_params.get("restore_dir", "checkpoints/wavenet")

    state = init_state(keys.next(), cfg, tx, device)
    state, start_step = ckpt_lib.restore_or_init(ckpt_dir, state)
    compute_dtype = COMPUTE_DTYPES[train_params.get("compute_dtype", "float32")]
    train_step = make_train_step(cfg, tx, compute_dtype)
    return run_epochs(state, train_step, windows, dataset_params=dataset_params,
                      train_params=train_params, logger=logger, ckpt_dir=ckpt_dir,
                      start_step=start_step, device=device)
