"""SeqGAN: LSTM generator, CNN discriminator and Monte-Carlo rollout
rewards (counterpart of :mod:`music_tpu.models.seqgan`).

Plain functions on dicts of tensors with the JAX package's parameter
trees (``embed``, ``lstm``, ``out`` for G; ``embed``, the ``convs`` list,
``highway_h``, ``highway_t``, ``out`` for D), so weights move between the
packages through :func:`params_from_numpy` / :func:`params_to_numpy`.

Randomness.  ``jax.random.categorical(key, logits)`` is
``argmax(logits + jax.random.gumbel(key, logits.shape))``, so every
sampler here draws by Gumbel-max: from ``generator`` (a ``torch.Generator``
on the logits' device), or from ``noise`` that a caller supplies, one
``[rows, V]`` slab a step (a test feeds JAX's own Gumbel draws and
demands equal tokens).  ``torch.multinomial`` is another algorithm and
would not reproduce them.  Dropout likewise takes a generator or a
``dropout_mask`` (JAX's ``bernoulli(key, keep, shape)``).

The discriminator's width-``fs`` valid convolutions are one GEMM each
over the window of ``fs`` embeddings side by side (``[B, T-fs+1, fs*E] @
[fs*E, nf]``, :func:`cnn_features`): 12 GEMMs a forward where JAX runs 90
shifted ones.  Not ``F.conv1d``: cuDNN convolutions default to TF32 on
Hopper, which would break float32 parity.

Kept from the JAX package (docs/DIVERGENCES.md): #4 a trained highway,
#5 true categorical sampling, #6 the descending policy-gradient sign,
#17 the N(0, 1) oracle init (``init="normal"``, chosen by the trainer).
The model-parallel discriminator is
:func:`music_tpu_torch.parallel.gan_tp.discriminator_forward_tp`, which
the trainer on a ``model`` mesh passes to :func:`rollout_rewards` as
``pos_prob_fn``.
"""

from __future__ import annotations

import dataclasses

import torch

from music_tpu_torch.ops.rnn import (
    embedding_init,
    linear,
    linear_init,
    lstm_cell,
    lstm_init,
    lstm_scan,
    lstm_zero_state,
    tree_from_numpy,
    tree_to_numpy,
)
from music_tpu_torch.ops.sampling import gumbel_noise

params_from_numpy = tree_from_numpy
params_to_numpy = tree_to_numpy

# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """The JAX package's ``GeneratorConfig`` (same fields and defaults)."""

    vocab_size: int = 5000
    emb_dim: int = 32
    hidden_dim: int = 32
    seq_len: int = 20
    start_token: int = 0


def init_generator(generator: torch.Generator, cfg: GeneratorConfig, emb_std: float = 1.0,
                   init: str = "torch", device: torch.device | str = "cpu") -> dict:
    """``init="torch"``: module-default inits (N(0, 1) embedding, U(±1/sqrt(H))
    LSTM and output layer); ``init="normal"``: every parameter N(0, 1), the
    target-LSTM oracle's init (divergence #17)."""
    return {
        "embed": embedding_init(generator, cfg.vocab_size, cfg.emb_dim, std=emb_std,
                                device=device),
        "lstm": lstm_init(generator, cfg.emb_dim, cfg.hidden_dim, init=init, device=device),
        "out": linear_init(generator, cfg.hidden_dim, cfg.vocab_size, init=init, device=device),
    }


def generator_logits(params: dict, tokens: torch.Tensor, cfg: GeneratorConfig):
    """Teacher-forced logits [B, T, V]: position t predicts token t from the
    start token and the tokens before t."""
    tokens = tokens.long()
    start = torch.full((tokens.shape[0], 1), cfg.start_token, dtype=torch.long,
                       device=tokens.device)
    inputs = torch.cat([start, tokens[:, :-1]], dim=1)
    hs, _ = lstm_scan(params["lstm"], params["embed"][inputs])
    return linear(params["out"], hs)


def generator_nll(params: dict, tokens: torch.Tensor, cfg: GeneratorConfig) -> torch.Tensor:
    """Mean per-token NLL: the MLE loss, and the oracle NLL when ``params``
    is the oracle."""
    logp = torch.log_softmax(generator_logits(params, tokens, cfg), dim=-1)
    return -torch.gather(logp, -1, tokens.long()[..., None]).mean()


def _step_noise(noise, generator, t: int, shape, device) -> torch.Tensor:
    """Step ``t``'s Gumbel slab: ``noise[t]`` when given, else a fresh draw."""
    if noise is not None:
        return noise[t].to(device)
    return gumbel_noise(generator, shape, device)


@torch.no_grad()
def generate(params: dict, cfg: GeneratorConfig, batch: int, *,
             generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None) -> torch.Tensor:
    """Free-running sampling of [batch, seq_len] token ids (int64).
    ``noise``: ``[seq_len, batch, V]`` Gumbel draws, JAX's
    ``gumbel(k, (batch, V))`` for ``k`` in ``split(key, seq_len)``."""
    device = params["embed"].device
    h, c = lstm_zero_state(batch, cfg.hidden_dim, device, params["embed"].dtype)
    tok = torch.full((batch,), cfg.start_token, dtype=torch.long, device=device)
    toks = []
    for t in range(cfg.seq_len):
        h, c = lstm_cell(params["lstm"], params["embed"][tok], (h, c))
        logits = linear(params["out"], h)
        tok = torch.argmax(logits + _step_noise(noise, generator, t, logits.shape, device), -1)
        toks.append(tok)
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """The JAX package's ``DiscriminatorConfig`` (12 filter sizes, 1720
    filters)."""

    vocab_size: int = 5000
    emb_dim: int = 64
    filter_sizes: tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 15, 20)
    num_filters: tuple[int, ...] = (100, 200, 200, 200, 200, 100, 100, 100, 100, 100, 160, 160)
    seq_len: int = 20
    dropout: float = 0.25

    @property
    def feature_dim(self) -> int:
        return sum(self.num_filters)


def init_discriminator(generator: torch.Generator, cfg: DiscriminatorConfig,
                       device: torch.device | str = "cpu") -> dict:
    """Conv weights ``[fs, E, nf]`` U(±1/sqrt(fs·E)), zero conv biases,
    N(0, 1) embedding, ``nn.Linear``-default highway and output."""
    convs = []
    for fs, nf in zip(cfg.filter_sizes, cfg.num_filters):
        bound = 1.0 / (fs * cfg.emb_dim) ** 0.5
        w = (2.0 * torch.rand((fs, cfg.emb_dim, nf), generator=generator) - 1.0) * bound
        convs.append({"w": w.to(device), "b": torch.zeros((nf,), device=device)})
    F = cfg.feature_dim
    return {
        "embed": embedding_init(generator, cfg.vocab_size, cfg.emb_dim, device=device),
        "convs": convs,
        # a real, trained highway (divergence #4)
        "highway_h": linear_init(generator, F, F, device=device),
        "highway_t": linear_init(generator, F, F, device=device),
        "out": linear_init(generator, F, 2, device=device),
    }


def cnn_features(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Conv -> relu -> max over time, each branch one GEMM over its window:
    the feature vector [B, sum(num_filters)] (:func:`conv_features` of the
    tokens' embeddings)."""
    return conv_features(params["embed"][tokens.long()], params["convs"])


def conv_features(x: torch.Tensor, convs: list[dict]) -> torch.Tensor:
    """The conv branches on embeddings ``x [B, T, E]``: ``[B, sum(nf)]``.

    The windows are one strided view of the embeddings (``unfold``), laid
    out ``[B, T-fs+1, fs*E]`` tap-major as ``w.reshape(fs*E, nf)``: one copy
    forward and one ``unfold_backward`` backward a branch, where ``fs``
    shifted slices would cost ~3·fs small kernels in the backward pass."""
    B, T, E = x.shape
    feats = []
    for conv in convs:
        fs, _, nf = conv["w"].shape
        if fs > T:
            raise ValueError(f"sequence length {T} too short for filter size {fs}")
        win = x.unfold(1, fs, 1).transpose(2, 3).reshape(B * (T - fs + 1), fs * E)
        acc = torch.addmm(conv["b"], win, conv["w"].reshape(fs * E, nf))
        # max over time: the gradient goes to one maximal position, where
        # jnp.max splits it among exact ties (after the relu only zeros tie,
        # and they take no gradient)
        feats.append(torch.relu(acc).reshape(B, T - fs + 1, nf).max(dim=1).values)
    return torch.cat(feats, dim=-1)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None = None,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout with keep probability ``1 - rate``: applied when a
    ``generator`` or a boolean keep ``mask`` (JAX's ``bernoulli(key, keep,
    x.shape)``) is given and ``rate > 0``; else ``x`` unchanged."""
    if rate <= 0 or (generator is None and mask is None):
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask.to(x.device), x / keep, 0.0)


def highway(params: dict, f: torch.Tensor) -> torch.Tensor:
    h = torch.relu(linear(params["highway_h"], f))
    t = torch.sigmoid(linear(params["highway_t"], f))
    return t * h + (1.0 - t) * f


def discriminator_features(params: dict, tokens: torch.Tensor, cfg: DiscriminatorConfig):
    """The feature vector [B, feature_dim] before the highway."""
    return cnn_features(params, tokens)


def discriminator_forward(params: dict, tokens: torch.Tensor, cfg: DiscriminatorConfig, *,
                          dropout_generator: torch.Generator | None = None,
                          dropout_mask: torch.Tensor | None = None) -> dict:
    """``{"pred": log-probs [B, 2], "feature": [B, F], "score": logits [B, 2]}``;
    the feature before the highway, dropout after it."""
    f = cnn_features(params, tokens)
    hw = dropout(highway(params, f), cfg.dropout, dropout_generator, dropout_mask)
    score = linear(params["out"], hw)
    return {"pred": torch.log_softmax(score, dim=-1), "feature": f, "score": score}


def discriminator_pos_prob(params: dict, tokens: torch.Tensor, cfg: DiscriminatorConfig):
    """P(real) per sequence, class 1 (the reward signal); the default
    ``pos_prob_fn`` of :func:`rollout_rewards`."""
    score = discriminator_forward(params, tokens, cfg)["score"]
    return torch.softmax(score, dim=-1)[:, 1]


def discriminator_loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
                       cfg: DiscriminatorConfig, *,
                       dropout_generator: torch.Generator | None = None,
                       dropout_mask: torch.Tensor | None = None) -> torch.Tensor:
    out = discriminator_forward(params, tokens, cfg, dropout_generator=dropout_generator,
                                dropout_mask=dropout_mask)
    logp = torch.log_softmax(out["score"], dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


# ---------------------------------------------------------------------------
# Rollout rewards + policy gradient
# ---------------------------------------------------------------------------


@torch.no_grad()
def rollout_rewards(g_params: dict, d_params: dict, samples: torch.Tensor, *,
                    g_cfg: GeneratorConfig, d_cfg: DiscriminatorConfig,
                    rollout_num: int = 16, generator: torch.Generator | None = None,
                    noise: torch.Tensor | None = None, pos_prob_fn=None) -> torch.Tensor:
    """Monte-Carlo rewards [B, T]: for prefix length t in [1, T), the mean
    P(real) of ``rollout_num`` completions; the last column is D on the
    sample itself.

    All R x (T-1) x B streams run together (19,456 at the shipped config):
    every stream starts from the state after ``[start, samples[:, 0]]`` and
    runs positions 1..T-1, fed the sample's token while the position is
    inside its prefix and its own Gumbel-max draw after, one loop over
    positions; then one D forward scores every completion.  ``noise``:
    ``[T-1, R*(T-1)*B, V]``, JAX's ``gumbel(k, (N, V))`` for ``k`` in
    ``split(key, T-1)``.  ``pos_prob_fn(d_params, tokens)`` scores them
    (default :func:`discriminator_pos_prob`; the tensor-parallel trainer
    passes the split forward's)."""
    samples = samples.long()
    B, T = samples.shape
    R, n_prefix = rollout_num, T - 1
    N = R * n_prefix * B
    lstm, embed = g_params["lstm"], g_params["embed"]
    device = embed.device
    start = torch.full((B,), g_cfg.start_token, dtype=torch.long, device=device)
    s0 = lstm_cell(lstm, embed[start], lstm_zero_state(B, g_cfg.hidden_dim, device, embed.dtype))
    h, c = lstm_cell(lstm, embed[samples[:, 0]], s0)
    h = h.expand(R * n_prefix, B, -1).reshape(N, -1)
    c = c.expand(R * n_prefix, B, -1).reshape(N, -1)
    prefix_len = torch.arange(1, T, device=device)[None, :, None].expand(R, n_prefix, B)
    prefix_len = prefix_len.reshape(N)
    sample_rep = samples.expand(R, n_prefix, B, T).reshape(N, T)

    toks = []
    for i, p in enumerate(range(1, T)):
        logits = linear(g_params["out"], h)
        sampled = torch.argmax(logits + _step_noise(noise, generator, i, logits.shape, device),
                               -1)
        tok = torch.where(p >= prefix_len, sampled, sample_rep[:, p])
        h, c = lstm_cell(lstm, embed[tok], (h, c))
        toks.append(tok)
    completions = torch.cat([sample_rep[:, :1], torch.stack(toks, dim=1)], dim=1)  # [N, T]
    score = pos_prob_fn or (lambda p, t: discriminator_pos_prob(p, t, d_cfg))
    probs = score(d_params, completions)
    rewards_mc = probs.reshape(R, n_prefix, B).mean(dim=0)  # [T-1, B]
    final = score(d_params, samples)
    return torch.cat([rewards_mc.T, final[:, None]], dim=1)


def pg_loss(g_params: dict, samples: torch.Tensor, rewards: torch.Tensor,
            cfg: GeneratorConfig) -> torch.Tensor:
    """Policy-gradient surrogate ``-mean(log pi(y_t | .) * reward_t)``; the
    rewards are constants (divergence #6 fixes the reference's sign)."""
    logp = torch.log_softmax(generator_logits(g_params, samples, cfg), dim=-1)
    chosen = torch.gather(logp, -1, samples.long()[..., None])[..., 0]
    return -(chosen * rewards.detach()).mean()
