"""C-RNN-GAN: a continuous LSTM GAN over MIDI note events (counterpart of
:mod:`music_tpu.models.crnngan`).

- **Generator**: per step, concat(uniform noise, previous output[, meta])
  -> fc1 + ReLU -> 2 stacked LSTM cells -> fc2 -> a 4-feature event
  (delta tick, length, frequency, velocity).  Free-running
  (:func:`generate`: the previous event is its own last output) or
  teacher-forced (:func:`generator_teacher_forced`: real event t-1, zeros
  at t = 0) for the MSE pretraining.
- **Discriminator**: a 2-layer bidirectional LSTM over the events (with the
  per-song genre/composer one-hot tiled onto every step when
  ``meta_dim > 0``) -> per-step linear -> sigmoid decisions ``[B, T]``,
  and the features ``[B, T, 2H]`` of the feature-matching loss.
- **Losses**: per-step BCE for D, -log D(fake) or feature matching for G,
  MSE regression for pretraining.

Parameters are dicts of tensors in the JAX package's layout
(:mod:`music_tpu_torch.ops.rnn`: ``wi``/``wh``/``bi``/``bh`` LSTMs,
``w``/``b`` linears), so weights and checkpoints cross packages.  Time is
a Python loop, and a step's small GEMMs and gate ops are launch-bound on a
card, so the loops are laid out for few launches (the sums the same up to
rounding): where every input of an LSTM layer is known up front (each
discriminator layer; the teacher-forced generator, layer by layer) its
input product ``x @ wi`` and both biases are one GEMM over all steps; a
bidirectional layer runs both directions side by side, and D reads real
and fake batches in one forward (:func:`discriminator_pair`).  Noise is
uniform in [0, 1), ``[length, batch,
noise_dim]`` as ``jax.random.uniform`` draws it: from ``noise`` when the
caller passes it (a test feeds JAX's own draws) or from ``generator``.
Not ported: the carries' zero-valued jitter, a shard_map workaround.

On a mesh (JAX's ``d_forward`` and ``axis_name``): the losses take
``d_forward``, the hidden-split D of a ``model`` mesh
(:func:`music_tpu_torch.parallel.gan_tp.crnngan_forward_tp`), and
:func:`g_feature_matching_loss` the process ``group`` over which it
averages the feature means before the MSE.
"""

from __future__ import annotations

import dataclasses

import torch

from music_tpu_torch.ops.rnn import (
    linear, linear_init, lstm_init, lstm_update, lstm_zero_state, tree_from_numpy,
    tree_to_numpy,
)

NUM_FEATURES = 4

params_from_numpy = tree_from_numpy
params_to_numpy = tree_to_numpy


@dataclasses.dataclass(frozen=True)
class CRnnGanConfig:
    """c-rnn-gan/params/crnngan_params.json schema.

    ``meta_dim``: width of the per-song genre+composer one-hot conditioning
    rows (:func:`music_tpu_torch.data.midi.build_meta_onehots`); 0 =
    unconditioned."""

    num_song_features: int = NUM_FEATURES
    noise_dim: int = 100
    hidden_dim: int = 350
    song_length: int = 100
    meta_dim: int = 0

    @classmethod
    def from_json(cls, cfg: dict) -> "CRnnGanConfig":
        return cls(
            num_song_features=cfg.get("num_song_features", NUM_FEATURES),
            noise_dim=cfg.get("noise_dim", cfg.get("random_input_dim", 100)),
            hidden_dim=cfg.get("hidden_dim", 350),
            song_length=cfg.get("song_length", 100),
            meta_dim=cfg.get("meta_dim", 0),
        )


def init_generator(generator: torch.Generator, cfg: CRnnGanConfig,
                   device: torch.device | str = "cpu") -> dict:
    H, F = cfg.hidden_dim, cfg.num_song_features
    return {
        "fc1": linear_init(generator, cfg.noise_dim + F + cfg.meta_dim, H, device=device),
        "lstm1": lstm_init(generator, H, H, device=device),
        "lstm2": lstm_init(generator, H, H, device=device),
        "fc2": linear_init(generator, H, F, device=device),
    }


def init_discriminator(generator: torch.Generator, cfg: CRnnGanConfig,
                       device: torch.device | str = "cpu") -> dict:
    """The conditional D: with ``meta_dim > 0`` it reads the one-hot beside
    each event, so that fooling it needs the condition honoured."""
    H, F = cfg.hidden_dim, cfg.num_song_features
    return {
        "fwd1": lstm_init(generator, F + cfg.meta_dim, H, device=device),
        "bwd1": lstm_init(generator, F + cfg.meta_dim, H, device=device),
        "fwd2": lstm_init(generator, 2 * H, H, device=device),
        "bwd2": lstm_init(generator, 2 * H, H, device=device),
        "out": linear_init(generator, 2 * H, 1, device=device),
    }


def _resolve_meta(meta, batch: int, cfg: CRnnGanConfig, device):
    """[B, meta_dim] conditioning rows, or None when unconditioned."""
    if cfg.meta_dim == 0:
        return None
    if meta is None:
        return torch.zeros((batch, cfg.meta_dim), device=device)
    return meta


def condition_events(events: torch.Tensor, meta, cfg: CRnnGanConfig) -> torch.Tensor:
    """Append the per-song meta one-hots to every step's event features, the
    conditional D's input (no-op when ``cfg.meta_dim == 0``)."""
    meta = _resolve_meta(meta, events.shape[0], cfg, events.device)
    if meta is None:
        return events
    B, T = events.shape[0], events.shape[1]
    tiled = meta[:, None, :].expand(B, T, meta.shape[-1]).to(events.dtype)
    return torch.cat([events, tiled], dim=-1)


def _noise(noise, generator, shape, device) -> torch.Tensor:
    """``noise`` (on ``device``) or a uniform draw of ``shape`` from
    ``generator``."""
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise {tuple(noise.shape)} != expected {tuple(shape)}")
        return noise.to(device)
    if generator is None:
        raise ValueError("need noise or a generator")
    return torch.rand(shape, generator=generator, device=device)


def generate(params: dict, cfg: CRnnGanConfig, batch: int, length: int | None = None,
             meta: torch.Tensor | None = None, *, generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None) -> torch.Tensor:
    """Free-running generation: ``[batch, length, 4]`` events, optionally
    conditioned on per-song ``[batch, meta_dim]`` one-hots; ``noise``
    ``[length, batch, noise_dim]`` or a draw from ``generator`` (on the
    parameters' device).  Each step: concat(noise, previous event, meta)
    -> fc1 + ReLU -> 2 LSTM cells -> fc2.  fc1's product is split by its
    input rows: the noise's and meta's part for all steps in one GEMM,
    the previous event's in the loop."""
    length = length or cfg.song_length
    nd, F, H = cfg.noise_dim, cfg.num_song_features, cfg.hidden_dim
    device = params["fc2"]["w"].device
    meta = _resolve_meta(meta, batch, cfg, device)
    noise = _noise(noise, generator, (length, batch, nd), device)
    w1 = params["fc1"]["w"]
    fixed = [noise] + ([meta[None].expand(length, batch, meta.shape[-1])]
                       if meta is not None else [])
    pre = (torch.cat(fixed, dim=-1).to(w1.dtype) @ torch.cat([w1[:nd], w1[nd + F:]])
           + params["fc1"]["b"])
    w_prev = w1[nd:nd + F]
    l1, l2 = params["lstm1"], params["lstm2"]
    b1, b2 = l1["bi"] + l1["bh"], l2["bi"] + l2["bh"]
    dtype = w1.dtype
    h1, c1 = lstm_zero_state(batch, H, device, dtype)
    h2, c2 = lstm_zero_state(batch, H, device, dtype)
    prev = torch.zeros((batch, F), device=device, dtype=dtype)
    outs = []
    for t in range(length):
        x = torch.relu(torch.addmm(pre[t], prev, w_prev))
        h1, c1 = lstm_update(torch.addmm(torch.addmm(b1, x, l1["wi"]), h1, l1["wh"]), c1)
        h2, c2 = lstm_update(torch.addmm(torch.addmm(b2, h1, l2["wi"]), h2, l2["wh"]), c2)
        prev = linear(params["fc2"], h2)
        outs.append(prev)
    return torch.stack(outs, dim=1)


def _lstm_stack(layers: list[dict], xs: torch.Tensor) -> torch.Tensor:
    """Independent LSTMs side by side over inputs known up front: ``xs [L, T,
    B, In]``, one slab for each of the ``L`` layers -> ``[L, T, B, H]``.  The
    input products of all steps with both biases are one batched GEMM; each
    step is then one batched GEMM of the recurrent products and one gate
    update for all ``L``."""
    L, T, B, _ = xs.shape
    wi = torch.stack([p["wi"] for p in layers])
    wh = torch.stack([p["wh"] for p in layers])
    bias = torch.stack([p["bi"] + p["bh"] for p in layers])[:, None]
    H = wh.shape[1]
    xw = torch.baddbmm(bias, xs.reshape(L, T * B, -1), wi).reshape(L, T, B, 4 * H)
    h = torch.zeros((L, B, H), device=xs.device, dtype=xs.dtype)
    c = torch.zeros_like(h)
    hs = []
    for t in range(T):
        h, c = lstm_update(torch.baddbmm(xw[:, t], h, wh), c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def generator_teacher_forced(params: dict, real: torch.Tensor, cfg: CRnnGanConfig,
                             meta: torch.Tensor | None = None, *,
                             generator: torch.Generator | None = None,
                             noise: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced outputs ``[B, T, 4]``: step t reads real event t-1
    (zeros at t = 0); the MSE pretraining's forward.  Nothing feeds back,
    so it runs layer by layer over all steps."""
    B, T, F = real.shape
    meta = _resolve_meta(meta, B, cfg, real.device)
    noise = _noise(noise, generator, (T, B, cfg.noise_dim), real.device)
    prev = torch.cat([torch.zeros((B, 1, F), device=real.device, dtype=real.dtype),
                      real[:, :-1]], dim=1).transpose(0, 1)  # [T, B, F]
    parts = [noise, prev] + ([meta[None].expand(T, B, meta.shape[-1])] if meta is not None
                             else [])
    x = torch.relu(linear(params["fc1"], torch.cat(parts, dim=-1).to(params["fc1"]["w"].dtype)))
    h1 = _lstm_stack([params["lstm1"]], x[None])[0]
    h2 = _lstm_stack([params["lstm2"]], h1[None])[0]
    return linear(params["fc2"], h2).transpose(0, 1)


def _bilstm(fwd_params: dict, bwd_params: dict, xs: torch.Tensor) -> torch.Tensor:
    """``xs [T, B, F]`` -> ``[T, B, 2H]``: the forward pass beside the
    backward one (run on the reversed sequence, its outputs reversed back),
    both directions side by side."""
    out = _lstm_stack([fwd_params, bwd_params], torch.stack([xs, xs.flip(0)]))
    return torch.cat([out[0], out[1].flip(0)], dim=-1)


def discriminator_forward(params: dict, events: torch.Tensor, cfg: CRnnGanConfig,
                          meta: torch.Tensor | None = None):
    """``[B, T, 4]`` events -> (decisions ``[B, T]`` in (0, 1), features
    ``[B, T, 2H]``); ``meta`` the ``[B, meta_dim]`` rows of a conditional D."""
    xs = condition_events(events, meta, cfg).transpose(0, 1)
    h = _bilstm(params["fwd1"], params["bwd1"], xs)
    h = _bilstm(params["fwd2"], params["bwd2"], h).transpose(0, 1)
    return torch.sigmoid(linear(params["out"], h)[..., 0]), h


def discriminator_pair(params: dict, real: torch.Tensor, fake: torch.Tensor,
                       cfg: CRnnGanConfig, meta: torch.Tensor | None = None, d_forward=None):
    """D on real and on fake events, ``((p_real, f_real), (p_fake,
    f_fake))``: one forward of both batches when their shapes agree (D
    reads each row alone, so the values are those of two forwards).
    ``d_forward``: D's forward (default :func:`discriminator_forward`)."""
    fwd = d_forward or discriminator_forward
    if real.shape[1:] != fake.shape[1:]:
        return fwd(params, real, cfg, meta=meta), fwd(params, fake, cfg, meta=meta)
    B = real.shape[0]
    p, f = fwd(params, torch.cat([real, fake]), cfg,
               meta=None if meta is None else torch.cat([meta, meta]))
    return (p[:B], f[:B]), (p[B:], f[B:])


def d_loss_from(p_real: torch.Tensor, p_fake: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Per-step BCE of D's decisions: real -> 1, fake -> 0."""
    return -(torch.log(p_real + eps).mean() + torch.log(1.0 - p_fake + eps).mean())


def d_loss(d_params: dict, real: torch.Tensor, fake: torch.Tensor, cfg: CRnnGanConfig,
           eps: float = 1e-7, meta: torch.Tensor | None = None, d_forward=None) -> torch.Tensor:
    """Per-step BCE: real -> 1, fake -> 0."""
    (p_real, _), (p_fake, _) = discriminator_pair(d_params, real, fake, cfg, meta, d_forward)
    return d_loss_from(p_real, p_fake, eps)


def g_adv_loss(g_params: dict, d_params: dict, batch: int, cfg: CRnnGanConfig,
               meta: torch.Tensor | None = None, *, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None, d_forward=None) -> torch.Tensor:
    """Adversarial G loss: -mean log D(fake)."""
    fake = generate(g_params, cfg, batch, meta=meta, generator=generator, noise=noise)
    p_fake, _ = (d_forward or discriminator_forward)(d_params, fake, cfg, meta=meta)
    return -torch.log(p_fake + 1e-7).mean()


def g_feature_matching_loss(g_params: dict, d_params: dict, real: torch.Tensor,
                            cfg: CRnnGanConfig, meta: torch.Tensor | None = None, *,
                            generator: torch.Generator | None = None,
                            noise: torch.Tensor | None = None, d_forward=None,
                            group=None) -> torch.Tensor:
    """The paper's feature matching: MSE between D's mean features (over
    batch and time) on real and on fake events.  ``group``: the process
    group of a mesh's ``(data, seq)`` ranks; the feature means are averaged
    over it before the MSE, which is not linear in them, so that the loss
    is the global batch's (every rank's the same, its backward this rank's
    share of the gradient)."""
    from music_tpu_torch.parallel.collectives import group_mean

    fake = generate(g_params, cfg, real.shape[0], meta=meta, generator=generator, noise=noise)
    (_, f_real), (_, f_fake) = discriminator_pair(d_params, real, fake, cfg, meta, d_forward)
    fr, ff = group_mean(torch.stack([f_real.mean(dim=(0, 1)), f_fake.mean(dim=(0, 1))]), group)
    return ((fr - ff) ** 2).mean()


def g_pretrain_loss(g_params: dict, real: torch.Tensor, cfg: CRnnGanConfig,
                    meta: torch.Tensor | None = None, *,
                    generator: torch.Generator | None = None,
                    noise: torch.Tensor | None = None) -> torch.Tensor:
    """MSE regression of the teacher-forced outputs onto the real events."""
    pred = generator_teacher_forced(g_params, real, cfg, meta=meta, generator=generator,
                                    noise=noise)
    return ((pred - real) ** 2).mean()
