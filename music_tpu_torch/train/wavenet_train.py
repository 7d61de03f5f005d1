"""WaveNet training (counterpart of :mod:`music_tpu.train.wavenet_train`).

``train()`` reads the same JSON param dicts as the JAX package's: it
resumes from the latest checkpoint in ``restore_dir`` (or starts from a
seeded init), takes one pass of shuffled windows an epoch through a
prefetch thread, logs the mean loss every ``print_every`` steps in the
JAX package's text format and saves a rotating checkpoint at each epoch's
end.  The checkpoints hold the JAX ``TrainState``'s leaves under its key
paths (``.params[...]``, ``.opt_state[...]``, ``.step``), so either package
resumes from the other's.

The loss is the model's :func:`~music_tpu_torch.models.wavenet.loss_fn`
with fused taps.  ``compute_dtype: "bfloat16"`` casts the parameters to
bf16 inside the loss and keeps the log-softmax in float32, as the JAX
trainer does (its rounding points, not ``torch.autocast``'s).
:func:`make_train_step` also takes the JAX trainer's opt-in stacked or
blocked skip GEMMs (``stack_skips``, ``skip_block``), which ``train()``
does not expose, as JAX's does not.

Parallelism is a ``(data, seq, model)`` mesh of ranks
(:mod:`music_tpu_torch.parallel`), one process per device, computing what
the JAX trainer's ``shard_map`` program computes:

- ``data``: each rank takes the rows of its data coordinate;
- ``seq``: each rank slices its ``RF + WL/seq`` sub-window of the
  (replicated) token window and runs a valid causal forward over it;
- ``model``: the 512-channel skip path split Megatron-style, the skip
  products column-parallel (entered through ``copy_to``: their input is
  replicated and its gradient must sum over ``model``), ``post1``
  row-parallel with one sum (``reduce_from``).

The loss is the mean over ``(data, seq)`` (:func:`~music_tpu_torch.parallel.collectives.pmean`);
each rank's gradients are its share, summed over ``(data, seq)`` before the
update, which gives ``jax.grad`` of the global loss.  With
``coordinator``/``num_processes``/``process_id`` in ``train_params`` each
process joins the process group first
(:func:`music_tpu_torch.parallel.multihost.initialize`); rank 0 writes the
logs and checkpoints.
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
from music_tpu_torch.models import wavenet as wn
from music_tpu_torch.parallel import multihost
from music_tpu_torch.parallel.collectives import (
    ModelSplit, pmean, sharded_global_norm, sum_grads,
)
from music_tpu_torch.parallel.mesh import Mesh, MeshSpec, P, make_mesh, shard_params

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """Parameters, optimizer state and the update count (an int32 scalar
    tensor), laid out as the JAX package's ``TrainState``."""

    params: dict
    opt_state: Any
    step: torch.Tensor


def param_specs(cfg: wn.WaveNetConfig, tp: bool) -> dict:
    """Partition specs per parameter.  With ``tp``, the skip-channel axis is
    split over ``model``: skip ``[L, Cd, Cs@model]``, post1 ``[Cs@model,
    Cs]`` (row-parallel: one sum in forward), post2 replicated."""
    specs = {
        "causal": P(),
        "fg": P(),
        "dense": P(),
        "skip": P(None, None, "model") if tp else P(),
        "post1": P("model", None) if tp else P(),
        "post2": P(),
    }
    if cfg.use_bias:
        specs.update(
            causal_b=P(), fg_b=P(), dense_b=P(),
            skip_b=P(None, "model") if tp else P(),
            post1_b=P(), post2_b=P(),
        )
    return specs


def init_state(generator: torch.Generator, cfg: wn.WaveNetConfig,
               tx: optim.GradientTransformation,
               device: str | torch.device = "cpu", mesh: Mesh | None = None) -> TrainState:
    """A seeded init; with ``mesh``, this rank's blocks by :func:`param_specs`
    on its device (every rank draws the same whole parameters)."""
    params = wn.init_params(cfg, generator, device=device if mesh is None else mesh.device)
    if mesh is not None:
        params = shard_params(mesh, params, param_specs(cfg, mesh.shape["model"] > 1))
    return TrainState(params, tx.init(params),
                      torch.zeros((), dtype=torch.int32, device=params["fg"].device))


def step_fn(loss_fn: Callable, tx: optim.GradientTransformation, mesh: Mesh | None = None):
    """``train_step(state, tokens) -> (state, loss)``: the gradients of
    ``loss_fn(params, tokens)`` and one optimizer update; on ``mesh`` the
    ranks' gradient shares are summed over ``(data, seq)`` first."""
    reduce_grads = None if mesh is None else (lambda grads: sum_grads(grads, mesh))

    def train_step(state: TrainState, tokens: torch.Tensor):
        params, opt_state, loss = optim.grad_update(
            tx, state.params, state.opt_state, lambda p: loss_fn(p, tokens), reduce_grads)
        return TrainState(params, opt_state, state.step + 1), loss

    return train_step


def _sharded_loss(params: dict, tokens: torch.Tensor, cfg: wn.WaveNetConfig, mesh: Mesh,
                  window_length: int, compute_dtype: torch.dtype | None, skip_block: int,
                  split: ModelSplit) -> torch.Tensor:
    """The global loss from this rank: ``tokens`` ``[B_local, RF + WL]``
    (its data rows, the whole window); it slices its seq coordinate's
    ``RF + WL/seq`` sub-window, runs the model with the skip path split by
    ``split``, and the loss is the mean over ``(data, seq)``."""
    rf = cfg.receptive_field
    if tokens.shape[1] != rf + window_length:
        raise ValueError(f"tokens of {tokens.shape[1]} codes, want receptive field {rf} + "
                         f"window {window_length}")
    wl_local = window_length // mesh.shape["seq"]
    s = mesh.index("seq") * wl_local
    nll = wn.loss_fn(params, tokens[:, s : s + rf + wl_local], cfg, fuse_taps=True,
                     compute_dtype=compute_dtype, skip_block=skip_block, split=split)
    return pmean(nll, mesh)


def make_loss_fn(cfg: wn.WaveNetConfig, mesh: Mesh, window_length: int,
                 compute_dtype: torch.dtype | None = None, stack_skips: bool = False,
                 skip_block: int = 0):
    """``(loss_fn, specs)``: ``loss_fn(params, tokens)`` the global loss from
    this rank's parameter blocks (by ``specs``) and data rows; its backward
    leaves this rank's share of the gradients (:func:`step_fn` sums them).
    ``compute_dtype``, ``stack_skips``, ``skip_block``: see
    :func:`make_train_step`."""
    sp = mesh.shape["seq"]
    if window_length % sp != 0:
        raise ValueError(f"window_length {window_length} % seq axis {sp} != 0")
    specs = param_specs(cfg, mesh.shape["model"] > 1)
    K = cfg.n_blocks if stack_skips else max(skip_block, 0)
    split = ModelSplit(mesh)

    def loss_fn(params, tokens):
        return _sharded_loss(params, tokens, cfg, mesh, window_length, compute_dtype, K, split)

    return loss_fn, specs


def make_train_step(cfg: wn.WaveNetConfig, tx: optim.GradientTransformation,
                    compute_dtype: torch.dtype | None = None, stack_skips: bool = False,
                    skip_block: int = 0, *, mesh: Mesh | None = None,
                    window_length: int | None = None):
    """One update on :func:`~music_tpu_torch.models.wavenet.loss_fn` with
    fused taps, in ``compute_dtype`` when given (see :func:`step_fn`).
    ``stack_skips`` computes the skip path as one ``[B·T, L·Cd] x
    [L·Cd, Cs]`` product, ``skip_block=K`` as one such product a block of
    K layers; the defaults keep one product a layer.

    With ``mesh`` (and the tokens' ``window_length``) the step runs on this
    rank's blocks and rows (:func:`make_loss_fn`).  A ``grad_clip_norm`` of
    ``tx`` must then take the norm of the whole arrays: build it with
    ``optim.from_config(train_params,
    global_norm=sharded_global_norm(mesh, specs))``."""
    if mesh is not None:
        if window_length is None:
            raise ValueError("a mesh step needs the window_length of its tokens")
        loss_fn, _ = make_loss_fn(cfg, mesh, window_length, compute_dtype, stack_skips,
                                  skip_block)
        return step_fn(loss_fn, tx, mesh)
    K = cfg.n_blocks if stack_skips else max(skip_block, 0)
    return step_fn(lambda params, tokens: wn.loss_fn(
        params, tokens, cfg, fuse_taps=True, compute_dtype=compute_dtype, skip_block=K), tx)


def _staged(batches: Iterator[np.ndarray], device: torch.device) -> Iterator[torch.Tensor]:
    """Each batch as a tensor on ``device``; on CUDA through pinned memory
    and a copy that does not block the host."""
    for batch in batches:
        tokens = torch.from_numpy(batch)
        if device.type == "cuda":
            tokens = tokens.pin_memory().to(device, non_blocking=True)
        yield tokens


def tx_for(train_params: Mapping[str, Any], mesh: Mesh, specs: dict):
    """The optimizer of ``train_params``, its clip norm over the whole
    arrays when the state is split over ``model``."""
    split = mesh.shape["model"] > 1
    return optim.from_config(train_params,
                             global_norm=sharded_global_norm(mesh, specs) if split else None)


def run_epochs(state: TrainState, train_step: Callable, windows: AudioWindows, *,
               dataset_params: Mapping[str, Any], train_params: Mapping[str, Any],
               logger: MetricsLogger | None, ckpt_dir: str | Path, start_step: int,
               mesh: Mesh, specs: dict) -> TrainState:
    """The epoch loop both trainers share: per epoch one pass of
    ``windows.batches(batch_size, seed=seed + epoch)`` (the same on every
    rank, each taking its data rows) through a prefetch thread, the mean
    loss logged every ``print_every`` steps, a rotating checkpoint at the
    epoch's end; the mesh's first rank logs (``logger``) and writes."""
    meter, thru = Meter(), Throughput()
    print_every = train_params.get("print_every", 100)
    seed = train_params.get("seed", 0)
    batch_size = dataset_params["batch_size"]
    rows = multihost.host_shard(batch_size, mesh)
    step = start_step
    for epoch in range(train_params.get("num_epochs", 1)):
        batches = (b[rows] for b in windows.batches(batch_size, seed=seed + epoch))
        for tokens in PrefetchBatches(_staged(batches, mesh.device)):
            state, loss = train_step(state, tokens)
            step += 1
            meter.update(multihost.fetch_scalar(loss))
            thru.update(batch_size)
            if step % print_every == 0 and mesh.is_main:
                logger.log_loss(epoch, step, meter.mean, pieces_per_sec=round(thru.rate, 2))
                meter.reset()
        ckpt_lib.save(ckpt_dir, step, state, mesh=mesh, specs=specs,
                      max_checkpoints=train_params.get("max_check_points", 10))
        if mesh.is_main:
            logger.log_event(f"saved checkpoint at step {step}")
    return state


def train(
    *,
    wavenet_params: Mapping[str, Any],
    dataset_params: Mapping[str, Any],
    train_params: Mapping[str, Any],
    mesh: Mesh | None = None,
    device: str | torch.device = "cuda",
) -> TrainState:
    """Train WaveNet from JSON param dicts (the JAX package's ``train()``).
    ``device`` defaults to CUDA and raises without a card; ask for
    ``"cpu"`` to train on the CPU.  ``mesh`` defaults to every rank on
    ``data`` (one device without a process group); each rank runs on its
    device.  Multi-process: set ``train_params["coordinator"]`` (and
    ``num_processes``, ``process_id``, optionally ``dist_backend``, e.g.
    from the CLI flags) in every process."""
    if train_params.get("coordinator") or train_params.get("num_processes"):
        multihost.initialize(
            train_params.get("coordinator"), train_params.get("num_processes"),
            train_params.get("process_id"), backend=train_params.get("dist_backend"),
            device=device)
    cfg = wn.WaveNetConfig.from_json(dict(wavenet_params))
    mesh = mesh or make_mesh(MeshSpec(data=-1), device=device)
    specs = param_specs(cfg, mesh.shape["model"] > 1)
    tx = tx_for(train_params, mesh, specs)
    keys = KeySeq(train_params.get("seed", 0))
    windows = AudioWindows.from_pickle(
        dataset_params["audio_path"], receptive_field=cfg.receptive_field,
        window_length=dataset_params["window_length"],
    )
    windows.check_vocab(cfg.quantization_channels)
    logger = MetricsLogger(train_params.get("log_dir", "logs/wavenet")) if mesh.is_main else None
    ckpt_dir = train_params.get("restore_dir", "checkpoints/wavenet")

    state = init_state(keys.next(), cfg, tx, mesh=mesh)
    state, start_step = ckpt_lib.restore_or_init(ckpt_dir, state, mesh=mesh, specs=specs)
    compute_dtype = COMPUTE_DTYPES[train_params.get("compute_dtype", "float32")]
    train_step = make_train_step(cfg, tx, compute_dtype, mesh=mesh,
                                 window_length=dataset_params["window_length"])
    return run_epochs(state, train_step, windows, dataset_params=dataset_params,
                      train_params=train_params, logger=logger, ckpt_dir=ckpt_dir,
                      start_step=start_step, mesh=mesh, specs=specs)
