"""WaveNet: dilated-causal-conv raw-audio model (PyTorch).

Counterpart of :mod:`music_tpu.models.wavenet`, with the same parameter
layout so weights move between the packages unchanged:

- ``causal``: ``[fw, Q, Cr]``
- ``fg``:     ``[L, fw, Cr, 2*Cd]`` (filter first half, gate second half)
- ``dense``:  ``[L, Cd, Cr]``
- ``skip``:   ``[L, Cd, Cs]``
- ``post1``:  ``[Cs, Cs]``
- ``post2``:  ``[Cs, Q]``
- optional ``*_b`` biases when ``cfg.use_bias``.

The functions take a plain ``dict[str, Tensor]`` of parameters;
:class:`WaveNet` wraps one as an ``nn.Module``.  :func:`generate_tokens`
is the plain step loop every decode kernel is held against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from music_tpu_torch.ops.conv import conv1x1, dilated_causal_conv, token_causal_conv
from music_tpu_torch.ops.sampling import argmax_sample, gumbel_argmax


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    """The ``wavenet_params.json`` schema (same fields and defaults as the
    JAX package's config)."""

    filter_width: int = 2
    dilations: tuple[int, ...] = tuple([2**i for i in range(10)] * 4)
    dilation_channels: int = 32
    residual_channels: int = 32
    skip_channels: int = 512
    quantization_channels: int = 256
    use_bias: bool = False

    @property
    def n_blocks(self) -> int:
        return len(self.dilations)

    @property
    def receptive_field(self) -> int:
        return (self.filter_width - 1) * (sum(self.dilations) + 1) + 1

    @classmethod
    def from_json(cls, cfg: dict) -> "WaveNetConfig":
        return cls(
            filter_width=cfg["filter_width"],
            dilations=tuple(cfg["dilations"]),
            dilation_channels=cfg["dilation_channels"],
            residual_channels=cfg["residual_channels"],
            skip_channels=cfg["skip_channels"],
            quantization_channels=cfg["quantization_channels"],
            use_bias=bool(cfg.get("use_bias", False)),
        )


def param_shapes(cfg: WaveNetConfig) -> dict[str, tuple[int, ...]]:
    """Shape of every parameter, keyed as in the JAX pytree."""
    fw, L = cfg.filter_width, cfg.n_blocks
    Q, Cr, Cd, Cs = (
        cfg.quantization_channels, cfg.residual_channels,
        cfg.dilation_channels, cfg.skip_channels,
    )
    shapes = {
        "causal": (fw, Q, Cr),
        "fg": (L, fw, Cr, 2 * Cd),
        "dense": (L, Cd, Cr),
        "skip": (L, Cd, Cs),
        "post1": (Cs, Cs),
        "post2": (Cs, Q),
    }
    if cfg.use_bias:
        shapes.update(
            causal_b=(Cr,), fg_b=(L, 2 * Cd), dense_b=(L, Cr),
            skip_b=(L, Cs), post1_b=(Cs,), post2_b=(Q,),
        )
    return shapes


def init_params(
    cfg: WaveNetConfig,
    generator: torch.Generator,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """Random parameters with the JAX init's distribution: weights
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` (fan_in = in_ch * fw for the
    convs), biases zero."""
    fw = cfg.filter_width
    fan_in = {
        "causal": cfg.quantization_channels * fw,
        "fg": cfg.residual_channels * fw,
        "dense": cfg.dilation_channels,
        "skip": cfg.dilation_channels,
        "post1": cfg.skip_channels,
        "post2": cfg.skip_channels,
    }
    params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("_b"):
            params[name] = torch.zeros(shape, device=device, dtype=dtype)
            continue
        bound = 1.0 / np.sqrt(fan_in[name])
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        params[name] = ((2.0 * u - 1.0) * bound).to(device=device, dtype=dtype)
    return params


def params_from_numpy(
    d: dict[str, np.ndarray],
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
    cfg: WaveNetConfig | None = None,
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


def _gate(fg: torch.Tensor) -> torch.Tensor:
    """``tanh(filter) * sigmoid(gate)``; filter is the first half."""
    f, g = torch.chunk(fg, 2, dim=-1)
    return torch.tanh(f) * torch.sigmoid(g)


def _bias(params: dict, cfg: WaveNetConfig, name: str, i: int | None = None):
    if not cfg.use_bias:
        return None
    b = params[name]
    return b if i is None else b[i]


def forward(params: dict, tokens: torch.Tensor, cfg: WaveNetConfig, *,
            fuse_taps: bool = False, skip_block: int = 0, split=None) -> torch.Tensor:
    """Logits ``[B, T - receptive_field + 1, Q]`` over int codes ``[B, T]``:
    the prediction for the sample after each full receptive field.
    ``fuse_taps`` contracts each layer's taps in one matmul and
    ``skip_block`` > 1 the skip products of that many layers in one (the
    trainer's forms; same math, reassociated adds).  ``split``: see
    :func:`_forward_from_causal`."""
    T = tokens.shape[1]
    if T - cfg.receptive_field + 1 <= 0:
        raise ValueError(f"sequence length {T} < receptive field {cfg.receptive_field}")
    x = token_causal_conv(tokens, params["causal"], _bias(params, cfg, "causal_b"))
    return _forward_from_causal(params, x, cfg, fuse_taps=fuse_taps, skip_block=skip_block,
                                split=split)


def forward_onehot(params: dict, wave: torch.Tensor, cfg: WaveNetConfig) -> torch.Tensor:
    """:func:`forward` over a one-hot input ``[B, T, Q]`` (channels last)
    instead of int codes."""
    x0 = dilated_causal_conv(wave, params["causal"], _bias(params, cfg, "causal_b"), dilation=1)
    return _forward_from_causal(params, x0, cfg)


def _forward_from_causal(params: dict, x: torch.Tensor, cfg: WaveNetConfig, *,
                         fuse_taps: bool = False, skip_block: int = 0,
                         split=None) -> torch.Tensor:
    """The layers after the causal conv: ``x [B, T - fw + 1, Cr]`` ->
    logits ``[B, T - receptive_field + 1, Q]``.

    ``skip_block`` = K > 1 computes the skip path as one
    ``[B·T, K·Cd] x [K·Cd, Cs]`` product a block of K layers (the last
    block may be shorter), with the block's skip biases summed: the
    per-layer sum reassociated, as the JAX trainer's ``skip_block`` (and
    ``stack_skips``, K = L).

    ``split`` (:class:`music_tpu_torch.parallel.collectives.ModelSplit`)
    runs the skip path split over ranks, as the JAX trainer's ``model``
    axis: ``params`` hold this rank's columns of ``skip`` (and ``skip_b``)
    and rows of ``post1``; ``split.enter`` takes each skip product's input
    and ``split.exit`` sums ``post1``'s partial products before its bias."""
    out_width = x.shape[1] + cfg.filter_width - cfg.receptive_field
    L, Cd = cfg.n_blocks, cfg.dilation_channels
    enter = split.enter if split is not None else (lambda v: v)
    skip_total, zs = None, []
    for i, d in enumerate(cfg.dilations):
        fg = dilated_causal_conv(x, params["fg"][i], _bias(params, cfg, "fg_b", i), dilation=d,
                                 fuse_taps=fuse_taps)
        z = _gate(fg)
        dense = conv1x1(z, params["dense"][i], _bias(params, cfg, "dense_b", i))
        x = dense + x[:, -dense.shape[1]:, :]
        if skip_block > 1:
            zs.append(z[:, -out_width:, :])
            if len(zs) < skip_block and i + 1 < L:
                continue
            k0 = i + 1 - len(zs)
            w = params["skip"][k0:i + 1].reshape(len(zs) * Cd, -1)
            skip = conv1x1(enter(torch.cat(zs, dim=-1)), w)
            if cfg.use_bias:
                skip = skip + params["skip_b"][k0:i + 1].sum(dim=0)
            zs = []
        else:
            skip = conv1x1(enter(z[:, -out_width:, :]), params["skip"][i],
                           _bias(params, cfg, "skip_b", i))
        skip_total = skip if skip_total is None else skip_total + skip
    h = conv1x1(torch.relu(skip_total), params["post1"])
    if split is not None:
        h = split.exit(h)
    if cfg.use_bias:
        h = h + params["post1_b"]
    return conv1x1(torch.relu(h), params["post2"], _bias(params, cfg, "post2_b"))


def loss_fn(params: dict, tokens: torch.Tensor, cfg: WaveNetConfig, *,
            fuse_taps: bool = False, compute_dtype: torch.dtype | None = None,
            skip_block: int = 0, split=None) -> torch.Tensor:
    """Next-sample cross entropy: ``tokens[:, receptive_field:]`` are the
    targets of the logits at positions ``[:-1]``.  With ``compute_dtype``
    (mixed precision, e.g. ``torch.bfloat16``) the parameters are cast to
    it inside the loss, so their gradients stay in the master dtype, and
    the log-softmax runs in float32.  ``skip_block``, ``split``: see
    :func:`_forward_from_causal`."""
    if compute_dtype is not None:
        params = {k: v.to(compute_dtype) for k, v in params.items()}
    logits = forward(params, tokens[:, :-1], cfg, fuse_taps=fuse_taps, skip_block=skip_block,
                     split=split)
    targets = tokens[:, cfg.receptive_field:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None]).mean()


class WaveNet(nn.Module):
    """``nn.Module`` over the functional model; parameter names are the
    JAX keys (``causal``, ``fg``, ``dense``, ``skip``, ``post1``, ``post2``)."""

    def __init__(self, cfg: WaveNetConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for k, v in params.items():
            self.register_parameter(k, nn.Parameter(v))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(dict(self.named_parameters()), tokens, self.cfg)


# ---------------------------------------------------------------------------
# Plain autoregressive decode: per-layer ring caches, one step per call.
# ---------------------------------------------------------------------------


def init_cache(
    cfg: WaveNetConfig, batch: int, device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Decode cache: ``ring [L, D_max, B, Cr]``, where slot ``t mod d_i`` of
    block ``i`` holds its residual input from step ``t - d_i`` at read time."""
    if cfg.filter_width != 2:
        raise NotImplementedError("decode cache assumes filter_width=2")
    D_max = max(cfg.dilations)
    return {
        "ring": torch.zeros(
            (cfg.n_blocks, D_max, batch, cfg.residual_channels), device=device, dtype=dtype
        ),
        "prev_token": torch.zeros((batch,), dtype=torch.long, device=device),
        "t": 0,
    }


def decode_step(params: dict, cache: dict, token: torch.Tensor, cfg: WaveNetConfig):
    """Consume ``token`` ([B] int), return ``(cache, logits [B, Q])``.  The
    cache's ring is updated in place; each block reads its slot before
    writing its current input into it."""
    t = cache["t"]
    token = token.long()
    x = params["causal"][1][token] + params["causal"][0][cache["prev_token"]]
    if cfg.use_bias:
        x = x + params["causal_b"]
    ring = cache["ring"]
    zs = []
    for i, d in enumerate(cfg.dilations):
        slot = t % d
        prev = ring[i, slot].clone()
        fg = prev @ params["fg"][i, 0] + x @ params["fg"][i, 1]
        if cfg.use_bias:
            fg = fg + params["fg_b"][i]
        z = _gate(fg)
        ring[i, slot] = x
        dense = z @ params["dense"][i]
        if cfg.use_bias:
            dense = dense + params["dense_b"][i]
        x = x + dense
        zs.append(z)
    z_all = torch.cat(zs, dim=-1)
    skip_total = z_all @ params["skip"].reshape(-1, cfg.skip_channels)
    if cfg.use_bias:
        skip_total = skip_total + params["skip_b"].sum(dim=0)
    h = torch.relu(skip_total) @ params["post1"]
    if cfg.use_bias:
        h = h + params["post1_b"]
    logits = torch.relu(h) @ params["post2"]
    if cfg.use_bias:
        logits = logits + params["post2_b"]
    return {"ring": ring, "prev_token": token, "t": t + 1}, logits


@torch.no_grad()
def generate_tokens(
    params: dict,
    prime: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    cfg: WaveNetConfig,
    n_steps: int,
    prime_len: int,
    sample_mode: str = "argmax",
    temperature: float = 1.0,
) -> torch.Tensor:
    """``n_steps`` codes after teacher-forcing ``prime [B, prime_len]``,
    one :func:`decode_step` per sample.  Returns ``[B, n_steps]`` int32."""
    if sample_mode not in ("argmax", "categorical"):
        raise ValueError(f"unknown sample_mode {sample_mode!r}")
    B = prime.shape[0]
    cache = init_cache(cfg, B, device=prime.device, dtype=params["fg"].dtype)
    out = []
    sampled = None
    for i in range(prime_len - 1 + n_steps):
        token = prime[:, i] if i < prime_len else sampled
        cache, logits = decode_step(params, cache, token, cfg)
        if sample_mode == "argmax":
            sampled = argmax_sample(logits)
        else:
            sampled = gumbel_argmax(generator, logits / temperature)
        if i >= prime_len - 1:
            out.append(sampled)
    return torch.stack(out, dim=1)
