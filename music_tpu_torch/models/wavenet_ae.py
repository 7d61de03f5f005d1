"""WaveNet autoencoder: temporal encoder + conditioned WaveNet decoder
(PyTorch).

Counterpart of :mod:`music_tpu.models.wavenet_ae`, with the same parameter
layout so weights move between the packages unchanged:

- encoder: ``en_causal [fw, Q, eCr]``, ``en_dil [L, fw, eCr, eCd]``,
  ``en_dense [L, eCd, eCr]``, ``bottleneck [eCr, W]``;
- decoder: ``de_causal [fw, Q, dCr]``, ``fg [L, fw, dCr, 2*dCd]``,
  ``cond_fg [L, W, 2*dCd]``, ``dense [L, dCd, dCr]``, ``skip [L, dCd, dCs]``,
  ``conn1 [dCs, dCs]``, ``cond_post [W, dCs]``, ``conn2 [dCs, Q]``.

The decoder's gate split is the opposite of WaveNet's: the gate is the
first half of the filter/gate pre-activation and the filter the second,
``tanh(fg[..., Cd:]) * sigmoid(fg[..., :Cd])``.

Conditioning: the encoder's pooled frames ``[B, F, W]`` are projected by
``cond_fg`` / ``cond_post`` and added as biases.  :func:`decode` places
frame ``floor(p * F / length)`` at position ``p`` (the reference's
ratio-based upsample); with ``start`` it places frame ``(start + t) //
pool`` (clamped to ``F - 1``) at absolute time ``t``, the clock of the
step decoders and of the fused decode kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from music_tpu_torch.ops.conv import conv1x1, dilated_causal_conv, token_causal_conv
from music_tpu_torch.ops.sampling import argmax_sample, gumbel_argmax


@dataclasses.dataclass(frozen=True)
class WaveNetAEConfig:
    """The ``wavenet_autoencoder/model_params.json`` schema (same fields and
    defaults as the JAX package's config)."""

    filter_width: int = 2
    dilations: tuple[int, ...] = tuple([2**i for i in range(10)] * 4)
    en_residual_channel: int = 32
    en_dilation_channel: int = 32
    de_residual_channel: int = 32
    de_dilation_channel: int = 32
    de_skip_channel: int = 512
    en_bottleneck_width: int = 512
    en_pool_kernel_size: int = 512
    quantization_channel: int = 256
    use_bias: bool = False

    @property
    def receptive_field(self) -> int:
        return (self.filter_width - 1) * (sum(self.dilations) + 1) + 1

    @property
    def n_blocks(self) -> int:
        return len(self.dilations)

    @classmethod
    def from_json(cls, cfg: dict) -> "WaveNetAEConfig":
        return cls(
            filter_width=cfg["filter_width"],
            dilations=tuple(cfg["dilations"]),
            en_residual_channel=cfg["en_residual_channel"],
            en_dilation_channel=cfg["en_dilation_channel"],
            de_residual_channel=cfg["de_residual_channel"],
            de_dilation_channel=cfg["de_dilation_channel"],
            de_skip_channel=cfg["de_skip_channel"],
            en_bottleneck_width=cfg["en_bottleneck_width"],
            en_pool_kernel_size=cfg["en_pool_kernel_size"],
            quantization_channel=cfg["quantization_channel"],
            use_bias=bool(cfg.get("use_bias", False)),
        )


def param_shapes(cfg: WaveNetAEConfig) -> dict[str, tuple[int, ...]]:
    """Shape of every parameter, keyed as in the JAX pytree."""
    fw, L, Q = cfg.filter_width, cfg.n_blocks, cfg.quantization_channel
    eCr, eCd = cfg.en_residual_channel, cfg.en_dilation_channel
    dCr, dCd, dCs = cfg.de_residual_channel, cfg.de_dilation_channel, cfg.de_skip_channel
    W = cfg.en_bottleneck_width
    return {
        "en_causal": (fw, Q, eCr),
        "en_dil": (L, fw, eCr, eCd),
        "en_dense": (L, eCd, eCr),
        "bottleneck": (eCr, W),
        "de_causal": (fw, Q, dCr),
        "fg": (L, fw, dCr, 2 * dCd),
        "cond_fg": (L, W, 2 * dCd),
        "dense": (L, dCd, dCr),
        "skip": (L, dCd, dCs),
        "conn1": (dCs, dCs),
        "cond_post": (W, dCs),
        "conn2": (dCs, Q),
    }


def _fan_in(cfg: WaveNetAEConfig) -> dict[str, int]:
    fw, Q = cfg.filter_width, cfg.quantization_channel
    return {
        "en_causal": Q * fw, "en_dil": cfg.en_residual_channel * fw,
        "en_dense": cfg.en_dilation_channel, "bottleneck": cfg.en_residual_channel,
        "de_causal": Q * fw, "fg": cfg.de_residual_channel * fw,
        "cond_fg": cfg.en_bottleneck_width, "dense": cfg.de_dilation_channel,
        "skip": cfg.de_dilation_channel, "conn1": cfg.de_skip_channel,
        "cond_post": cfg.en_bottleneck_width, "conn2": cfg.de_skip_channel,
    }


def init_params(
    cfg: WaveNetAEConfig,
    generator: torch.Generator,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """Random parameters with the JAX init's distribution,
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``."""
    fan_in = _fan_in(cfg)
    params = {}
    for name, shape in param_shapes(cfg).items():
        bound = 1.0 / np.sqrt(fan_in[name])
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        params[name] = ((2.0 * u - 1.0) * bound).to(device=device, dtype=dtype)
    return params


def params_from_numpy(
    d: dict[str, np.ndarray],
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
    cfg: WaveNetAEConfig | None = None,
) -> dict[str, torch.Tensor]:
    """Numpy arrays (a JAX checkpoint's ``.params``) -> tensors.  With
    ``cfg``, every expected key must be present with its shape."""
    if cfg is not None:
        for name, shape in param_shapes(cfg).items():
            if name not in d:
                raise KeyError(f"missing parameter {name!r}")
            if tuple(d[name].shape) != shape:
                raise ValueError(f"parameter {name!r} shape {d[name].shape} != {shape}")
    return {
        k: torch.tensor(np.asarray(v)).to(device=device, dtype=dtype)
        for k, v in d.items()
    }


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in params.items()}


def gate(fg: torch.Tensor, cd: int) -> torch.Tensor:
    """The decoder's gate: ``tanh(fg[..., Cd:]) * sigmoid(fg[..., :Cd])``
    (gate first half, filter second, unlike WaveNet's)."""
    return torch.tanh(fg[..., cd:]) * torch.sigmoid(fg[..., :cd])


def encode(params: dict, tokens: torch.Tensor, cfg: WaveNetAEConfig) -> torch.Tensor:
    """Temporal encoder: ``[B, T]`` codes -> ``[B, n_frames, W]`` (relu ->
    dilated conv -> relu -> dense + residual per block, 1x1 bottleneck,
    then AvgPool1d(kernel = stride = pool), which drops the tail)."""
    x = token_causal_conv(tokens, params["en_causal"])
    for i, d in enumerate(cfg.dilations):
        h = torch.relu(x)
        h = dilated_causal_conv(h, params["en_dil"][i], dilation=d)
        h = conv1x1(torch.relu(h), params["en_dense"][i])
        x = h + x[:, -h.shape[1]:, :]
    x = conv1x1(x, params["bottleneck"])
    k = cfg.en_pool_kernel_size
    n = x.shape[1] // k
    return x[:, : n * k, :].reshape(x.shape[0], n, k, x.shape[2]).mean(dim=2)


def _upsample_cond(encoding: torch.Tensor, length: int) -> torch.Tensor:
    """Nearest-neighbour upsample of ``[B, F, C]`` frames to ``[B, length,
    C]``: position ``p`` takes frame ``floor(p * F / length)``."""
    F = encoding.shape[1]
    idx = (torch.arange(length, device=encoding.device) * F) // length
    return encoding[:, idx]


def frame_of(times: torch.Tensor, pool: int, n_frames: int) -> torch.Tensor:
    """The encoding frame conditioning absolute time ``times``:
    ``min(times // pool, n_frames - 1)``."""
    return torch.clamp(torch.div(times, pool, rounding_mode="floor"), max=n_frames - 1)


def _cond_rows(encoding, length, first, start, pool):
    """Encoding rows ``[B, length, W]`` that condition ``length``
    consecutive positions whose first is token index ``first``."""
    if start is None:
        return _upsample_cond(encoding, length)
    B, F, _ = encoding.shape
    start = torch.as_tensor(start, device=encoding.device).reshape(-1).expand(B)
    t = start[:, None] + first + torch.arange(length, device=encoding.device)[None, :]
    frames = frame_of(t, pool, F)
    return torch.gather(encoding, 1, frames[..., None].expand(-1, -1, encoding.shape[2]))


def decode(
    params: dict,
    tokens: torch.Tensor,
    encoding: torch.Tensor,
    cfg: WaveNetAEConfig,
    output_width: int,
    start: int | torch.Tensor | None = None,
    split=None,
) -> torch.Tensor:
    """Conditioned decoder: ``[B, T]`` codes + ``[B, F, W]`` encoding ->
    logits ``[B, output_width, Q]``.

    ``start=None`` conditions by the reference's ratio-based upsample.
    Otherwise ``start`` (an int or a ``[B]`` tensor) is the absolute time
    of ``tokens[:, 0]``, and a position at absolute time ``t`` takes frame
    ``min(t // pool, F - 1)``.  ``split``
    (:class:`music_tpu_torch.parallel.collectives.ModelSplit`) runs the
    skip path split over ranks: ``params`` hold this rank's columns of
    ``skip`` and rows of ``conn1``, ``split.enter`` takes each skip
    product's input and ``split.exit`` sums ``conn1``'s partial products."""
    Cd, pool = cfg.de_dilation_channel, cfg.en_pool_kernel_size
    enter = split.enter if split is not None else (lambda v: v)
    T = tokens.shape[1]
    x = token_causal_conv(tokens, params["de_causal"])
    skip_total = None
    for i, d in enumerate(cfg.dilations):
        fg = dilated_causal_conv(x, params["fg"][i], dilation=d)
        cond = _cond_rows(encoding, fg.shape[1], T - fg.shape[1], start, pool)
        z = gate(fg + conv1x1(cond, params["cond_fg"][i]), Cd)
        x = conv1x1(z, params["dense"][i]) + x[:, -z.shape[1]:, :]
        skip = conv1x1(enter(z[:, -output_width:, :]), params["skip"][i])
        skip_total = skip if skip_total is None else skip_total + skip
    h = conv1x1(torch.relu(skip_total), params["conn1"])
    if split is not None:
        h = split.exit(h)
    cond = _cond_rows(encoding, output_width, T - output_width, start, pool)
    h = torch.relu(h + conv1x1(cond, params["cond_post"]))
    return conv1x1(h, params["conn2"])


def forward(params: dict, tokens: torch.Tensor, cfg: WaveNetAEConfig) -> torch.Tensor:
    """Full autoencoder: logits ``[B, T - receptive_field + 1, Q]``."""
    T = tokens.shape[1]
    output_width = T - cfg.receptive_field + 1
    if output_width <= 0:
        raise ValueError(f"sequence length {T} < receptive field {cfg.receptive_field}")
    return decode(params, tokens, encode(params, tokens, cfg), cfg, output_width)


def loss_fn(params: dict, tokens: torch.Tensor, cfg: WaveNetAEConfig) -> torch.Tensor:
    """Reconstruction cross entropy: ``tokens[:, receptive_field:]`` are
    the targets of the logits over ``tokens[:, :-1]``."""
    logits = forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, cfg.receptive_field:].long()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None]).mean()


# ---------------------------------------------------------------------------
# Plain autoregressive decode: per-layer ring caches, one step per call.
# ---------------------------------------------------------------------------


def init_cache(
    cfg: WaveNetAEConfig, batch: int, device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Decode cache: ``ring [L, D_max, B, Cr]``; slot ``t mod d_i`` of block
    ``i`` holds its residual input from step ``t - d_i`` at read time."""
    if cfg.filter_width != 2:
        raise NotImplementedError("decode cache assumes filter_width=2")
    return {
        "ring": torch.zeros((cfg.n_blocks, max(cfg.dilations), batch, cfg.de_residual_channel),
                            device=device, dtype=dtype),
        "prev_token": torch.zeros((batch,), dtype=torch.long, device=device),
        "t": 0,
    }


def decode_step(
    params: dict, cache: dict, token: torch.Tensor, cond_fg_t: torch.Tensor,
    cond_post_t: torch.Tensor, cfg: WaveNetAEConfig,
):
    """Consume ``token`` ([B] int) with this step's conditioning biases
    ``cond_fg_t [B, L, 2Cd]`` and ``cond_post_t [B, Cs]``; return ``(cache,
    logits [B, Q])``.  The ring is updated in place, each block reading
    its slot before writing its current input there."""
    Cd, t = cfg.de_dilation_channel, cache["t"]
    token = token.long()
    x = params["de_causal"][1][token] + params["de_causal"][0][cache["prev_token"]]
    ring = cache["ring"]
    zs = []
    for i, d in enumerate(cfg.dilations):
        slot = t % d
        fg = ring[i, slot] @ params["fg"][i, 0] + x @ params["fg"][i, 1] + cond_fg_t[:, i]
        z = gate(fg, Cd)
        ring[i, slot] = x
        x = x + z @ params["dense"][i]
        zs.append(z)
    h = torch.relu(torch.cat(zs, dim=-1) @ params["skip"].reshape(-1, cfg.de_skip_channel))
    h = torch.relu(h @ params["conn1"] + cond_post_t)
    return {"ring": ring, "prev_token": token, "t": t + 1}, h @ params["conn2"]


def cond_tables(params: dict, encoding: torch.Tensor, cfg: WaveNetAEConfig):
    """Per-frame conditioning biases: ``cond_fg [B, F, L, 2Cd]`` and
    ``cond_post [B, F, Cs]``."""
    cond_fg = torch.einsum("bfw,lwc->bflc", encoding, params["cond_fg"])
    cond_post = torch.einsum("bfw,wc->bfc", encoding, params["cond_post"])
    return cond_fg, cond_post


@torch.no_grad()
def generate_tokens(
    params: dict,
    encoding: torch.Tensor,
    prime: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    cfg: WaveNetAEConfig,
    n_steps: int,
    sample_mode: str = "argmax",
    temperature: float = 1.0,
) -> torch.Tensor:
    """Reconstruct ``n_steps`` codes conditioned on ``encoding [B, F, W]``
    after teacher-forcing ``prime [B, P]``, one :func:`decode_step` per
    sample; the step consuming the token at time ``t`` is conditioned by
    frame ``min(t // pool, F - 1)``.  Returns ``[B, n_steps]`` int32."""
    if sample_mode not in ("argmax", "categorical"):
        raise ValueError(f"unknown sample_mode {sample_mode!r}")
    B, prime_len = prime.shape
    F = encoding.shape[1]
    cond_fg, cond_post = cond_tables(params, encoding, cfg)
    cache = init_cache(cfg, B, device=prime.device, dtype=params["fg"].dtype)
    out, sampled = [], None
    for i in range(prime_len - 1 + n_steps):
        token = prime[:, i] if i < prime_len else sampled
        frame = min(i // cfg.en_pool_kernel_size, F - 1)
        cache, logits = decode_step(params, cache, token, cond_fg[:, frame],
                                    cond_post[:, frame], cfg)
        if sample_mode == "argmax":
            sampled = argmax_sample(logits)
        else:
            sampled = gumbel_argmax(generator, logits / temperature)
        if i >= prime_len - 1:
            out.append(sampled)
    return torch.stack(out, dim=1)
