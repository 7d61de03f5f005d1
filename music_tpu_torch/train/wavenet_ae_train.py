"""WaveNet-autoencoder training (counterpart of
:mod:`music_tpu.train.wavenet_ae_train`): the WaveNet trainer's loop over
the autoencoder's reconstruction loss,
:func:`~music_tpu_torch.models.wavenet_ae.loss_fn`.

On a mesh (:mod:`music_tpu_torch.parallel`) the loss is the JAX trainer's
``_sharded_ae_loss``: the batch split over ``data``, the decoder's skip
path over ``model`` (column-parallel skip products, row-parallel ``conn1``
with one sum), and, when the window divides evenly, the time axis of both
the encoder and the decoder over ``seq``, with a per-layer halo exchange
(:func:`~music_tpu_torch.parallel.halo.left_halo_exchange`).  Shard 0's
left context comes from a margin, the receptive-field zone ``[0,
sum(d))`` that every rank computes and that shrinks by ``d`` a layer, so
the result is the unsharded computation exactly.  When the shapes do not
divide, each seq rank computes the whole window (the loss a mean over
``data`` only).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from music_tpu_torch.core import checkpoint as ckpt_lib
from music_tpu_torch.core import optim
from music_tpu_torch.core.metrics import MetricsLogger
from music_tpu_torch.core.prng import KeySeq
from music_tpu_torch.data.audio import AudioWindows
from music_tpu_torch.models import wavenet_ae as ae
from music_tpu_torch.ops.conv import conv1x1, dilated_causal_conv, token_causal_conv
from music_tpu_torch.parallel.collectives import ModelSplit, all_gather, pmean
from music_tpu_torch.parallel.halo import left_halo_exchange
from music_tpu_torch.parallel.mesh import Mesh, MeshSpec, P, make_mesh, shard_params
from music_tpu_torch.train import wavenet_train
from music_tpu_torch.train.wavenet_train import TrainState


def ae_param_specs(cfg: ae.WaveNetAEConfig, tp: bool) -> dict:
    """Partition specs: with ``tp``, the decoder's skip path is split over
    ``model`` (column-parallel skip products, row-parallel conn1); the
    encoder and the conditioning projections stay replicated."""
    specs = {k: P() for k in (
        "en_causal", "en_dil", "en_dense", "bottleneck",
        "de_causal", "fg", "cond_fg", "dense", "cond_post", "conn2",
    )}
    specs["skip"] = P(None, None, "model") if tp else P()
    specs["conn1"] = P("model", None) if tp else P()
    return specs


def _seq_sharded_encode(params: dict, inputs: torch.Tensor, cfg: ae.WaveNetAEConfig,
                        mesh: Mesh) -> torch.Tensor:
    """The encoder over ``seq``: each rank owns ``w = E / seq`` positions of
    every layer (E the encoder's output length) and receives each layer's
    ``d``-wide left context from its neighbour; shard 0's comes from the
    margin.  The pooled frames of every rank are gathered in order."""
    M = sum(cfg.dilations)
    E = inputs.shape[1] - 1 - M
    w = E // mesh.shape["seq"]
    s = mesh.index("seq")
    x = token_causal_conv(inputs[:, M + s * w : M + s * w + w + 1], params["en_causal"])
    margin = token_causal_conv(inputs[:, : M + 1], params["en_causal"])  # [B, M, Cr]
    remaining = M
    for i, d in enumerate(cfg.dilations):
        x_ext = left_halo_exchange(x, d, mesh, first_shard_fill=margin[:, -d:, :])
        h = dilated_causal_conv(torch.relu(x_ext), params["en_dil"][i], dilation=d,
                                fuse_taps=True)
        x = conv1x1(torch.relu(h), params["en_dense"][i]) + x
        remaining -= d
        if remaining > 0:  # the last layer consumes the margin entirely
            mh = dilated_causal_conv(torch.relu(margin), params["en_dil"][i], dilation=d,
                                     fuse_taps=True)
            margin = conv1x1(torch.relu(mh), params["en_dense"][i]) + margin[:, d:, :]
    x = conv1x1(x, params["bottleneck"])  # [B, w, W]
    k = cfg.en_pool_kernel_size
    frames = x.reshape(x.shape[0], w // k, k, -1).mean(dim=2)
    return all_gather(frames, mesh.group("seq"), dim=1)


def _seq_sharded_decode_loss(params: dict, inputs: torch.Tensor, targets: torch.Tensor,
                             encoding: torch.Tensor, cfg: ae.WaveNetAEConfig, mesh: Mesh,
                             split: ModelSplit) -> torch.Tensor:
    """The decoder and loss over ``seq``, by the encoder's margin and halo
    scheme; each position's conditioning frame is indexed by its place in
    the whole layer's output, as the unsharded ratio-based upsample."""
    Cd, M = cfg.de_dilation_channel, sum(cfg.dilations)
    O = inputs.shape[1] - 1 - M  # output width
    w = O // mesh.shape["seq"]
    F = encoding.shape[1]
    s = mesh.index("seq")

    def cond(start: int, length: int, buf_len: int, proj: torch.Tensor) -> torch.Tensor:
        """Conditioning of positions ``[start, start + length)`` of a layer
        output ``buf_len`` long."""
        idx = ((start + torch.arange(length, device=encoding.device)) * F) // buf_len
        return conv1x1(encoding[:, idx], proj)

    x = token_causal_conv(inputs[:, M + s * w : M + s * w + w + 1], params["de_causal"])
    margin = token_causal_conv(inputs[:, : M + 1], params["de_causal"])
    remaining, skip_total = M, None
    for i, d in enumerate(cfg.dilations):
        remaining -= d
        buf_len = remaining + O  # the whole layer output's length
        x_ext = left_halo_exchange(x, d, mesh, first_shard_fill=margin[:, -d:, :])
        fg = dilated_causal_conv(x_ext, params["fg"][i], dilation=d, fuse_taps=True)
        z = ae.gate(fg + cond(remaining + s * w, w, buf_len, params["cond_fg"][i]), Cd)
        x = conv1x1(z, params["dense"][i]) + x
        skip = conv1x1(split.enter(z), params["skip"][i])  # [B, w, Cs / model]
        skip_total = skip if skip_total is None else skip_total + skip
        if remaining > 0:
            mfg = dilated_causal_conv(margin, params["fg"][i], dilation=d, fuse_taps=True)
            mz = ae.gate(mfg + cond(0, remaining, buf_len, params["cond_fg"][i]), Cd)
            margin = conv1x1(mz, params["dense"][i]) + margin[:, d:, :]
    h = split.exit(conv1x1(torch.relu(skip_total), params["conn1"]))
    h = torch.relu(h + cond(s * w, w, O, params["cond_post"]))
    logits = conv1x1(h, params["conn2"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[:, s * w : s * w + w, None].long()).mean()
    return pmean(nll, mesh)


def _sharded_ae_loss(params: dict, tokens: torch.Tensor, cfg: ae.WaveNetAEConfig, mesh: Mesh,
                     split: ModelSplit) -> torch.Tensor:
    """The global loss from this rank's rows and blocks: sequence-parallel
    when the encoder's length and its per-rank share divide evenly (by
    ``seq``, then by the pool), else the window whole on every seq rank and
    the loss a mean over ``data`` only."""
    inputs, targets = tokens[:, :-1], tokens[:, cfg.receptive_field:]
    sp, k = mesh.shape["seq"], cfg.en_pool_kernel_size
    E = inputs.shape[1] - 1 - sum(cfg.dilations)
    if sp > 1 and E % sp == 0 and (E // sp) % k == 0:
        encoding = _seq_sharded_encode(params, inputs, cfg, mesh)
        return _seq_sharded_decode_loss(params, inputs, targets, encoding, cfg, mesh, split)
    output_width = inputs.shape[1] - cfg.receptive_field + 1
    logits = ae.decode(params, inputs, ae.encode(params, inputs, cfg), cfg, output_width,
                       split=split)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long()).mean()
    return pmean(nll, mesh, ("data",))


def make_loss_fn(cfg: ae.WaveNetAEConfig, mesh: Mesh):
    """``(loss_fn, specs)``: ``loss_fn(params, tokens)`` the global loss
    from this rank's parameter blocks (by ``specs``) and data rows, its
    backward this rank's share of the gradients."""
    specs = ae_param_specs(cfg, mesh.shape["model"] > 1)
    split = ModelSplit(mesh)
    return (lambda params, tokens: _sharded_ae_loss(params, tokens, cfg, mesh, split)), specs


def make_train_step(cfg: ae.WaveNetAEConfig, tx: optim.GradientTransformation,
                    mesh: Mesh | None = None):
    """``train_step(state, tokens) -> (state, loss)`` on the reconstruction
    loss; with ``mesh``, on this rank's blocks and rows (the gradient
    shares summed over ``(data, seq)``; a clip norm as in
    :func:`music_tpu_torch.train.wavenet_train.make_train_step`)."""
    if mesh is None:
        return wavenet_train.step_fn(lambda p, t: ae.loss_fn(p, t, cfg), tx)
    return wavenet_train.step_fn(make_loss_fn(cfg, mesh)[0], tx, mesh)


def train(
    *,
    model_params: Mapping[str, Any],
    dataset_params: Mapping[str, Any],
    train_params: Mapping[str, Any],
    mesh: Mesh | None = None,
    device: str | torch.device = "cuda",
) -> TrainState:
    """Train the autoencoder from JSON param dicts (the JAX package's
    ``train()``); ``device`` and ``mesh`` as in
    :func:`music_tpu_torch.train.wavenet_train.train`."""
    cfg = ae.WaveNetAEConfig.from_json(dict(model_params))
    mesh = mesh or make_mesh(MeshSpec(data=-1), device=device)
    specs = ae_param_specs(cfg, mesh.shape["model"] > 1)
    tx = wavenet_train.tx_for(train_params, mesh, specs)
    keys = KeySeq(train_params.get("seed", 0))
    windows = AudioWindows.from_pickle(
        dataset_params["audio_path"], receptive_field=cfg.receptive_field,
        window_length=dataset_params["window_length"],
    )
    windows.check_vocab(cfg.quantization_channel)
    logger = (MetricsLogger(train_params.get("log_dir", "logs/wavenet_ae"))
              if mesh.is_main else None)
    ckpt_dir = train_params.get("restore_dir", "checkpoints/wavenet_ae")

    params = shard_params(mesh, ae.init_params(cfg, keys.next(), device=mesh.device), specs)
    state = TrainState(params, tx.init(params), torch.zeros((), dtype=torch.int32,
                                                            device=mesh.device))
    state, start_step = ckpt_lib.restore_or_init(ckpt_dir, state, mesh=mesh, specs=specs)
    return wavenet_train.run_epochs(
        state, make_train_step(cfg, tx, mesh), windows, dataset_params=dataset_params,
        train_params=train_params, logger=logger, ckpt_dir=ckpt_dir, start_step=start_step,
        mesh=mesh, specs=specs)
