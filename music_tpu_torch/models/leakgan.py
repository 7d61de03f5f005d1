"""LeakGAN: hierarchical Manager/Worker generator with leaked discriminator
features (counterpart of :mod:`music_tpu.models.leakgan`).

Plain functions on dicts of tensors with the JAX package's parameter trees
(``{"manager": {lstm, fc, goal_init}, "worker": {embed, lstm, fc,
goal_change}}`` for G, the SeqGAN discriminator's tree with ``vocab_size +
1`` embedding rows for the pad token for D), carried across by
:func:`params_from_numpy` / :func:`params_to_numpy`.

One engine, :func:`_engine`, covers the four modes ('pre', 'adv',
'rollout', 'gen') as ``_engine_scan`` does in JAX: each step runs D on the
current padded prefix (under ``no_grad``: no gradient reaches G through
the leaked feature, whose input is integer tokens), one generator step,
the goal reset, and writes the emitted token into the prefix.  It is a
Python loop over the ``seq_len (+ 1)`` steps.

Randomness, as in :mod:`music_tpu_torch.models.seqgan`: each engine step
samples by Gumbel-max (``jax.random.categorical(key, logits) ==
argmax(logits + gumbel(key, logits.shape))``) from ``generator`` or from
a supplied ``noise`` slab ``[rows, V]`` a step (JAX's ``split(key,
n_steps)``); dropout from ``dropout_generator`` or a supplied
``dropout_mask [n_steps, rows, F]`` (JAX's ``bernoulli(k, keep, [rows,
F])`` for ``k`` in ``split(dropout_key, n_steps)``).

``goal_init`` is a parameter ``[batch_size, G]``, one row per batch row:
whole batches run the engines, and the rollout streams of batch row ``b``
start from row ``b`` (:func:`get_rewards`).  ``rescale_rewards`` ranks with
a stable sort, as ``jnp.argsort`` does: identical completions get equal
sums, which must rank by index.

Kept from the JAX package (docs/DIVERGENCES.md): #7 the pre-manager loss
minimised, #8 the reward column ``given_num / step_size``, #9 one uniform
rollout (teacher-forced to the restore point, sampling after); and its
non-bug notes: the 'pre' engine's Worker free-runs on its own samples
while D reads real prefixes, and the rank rescale is divided by
``rollout_num``.  Not here: the tensor-parallel ``d_forward`` and the
cross-shard ``axis_name`` gather (ROADMAP.md, A11).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from music_tpu_torch.models.seqgan import cnn_features, dropout, highway
from music_tpu_torch.ops.rnn import (
    linear,
    linear_init,
    lstm_cell,
    lstm_init,
    lstm_zero_state,
    tree_from_numpy,
    tree_to_numpy,
)
from music_tpu_torch.ops.sampling import gumbel_noise

params_from_numpy = tree_from_numpy
params_to_numpy = tree_to_numpy


@dataclasses.dataclass(frozen=True)
class LeakGanConfig:
    """The JAX package's ``LeakGanConfig`` (same fields and defaults)."""

    vocab_size: int = 5258
    seq_len: int = 20
    step_size: int = 5
    goal_size: int = 16
    worker_emb_dim: int = 32
    worker_hidden: int = 32
    manager_hidden: int = 32
    start_token: int = 0
    temperature: float = 1.0
    dis_emb_dim: int = 64
    filter_sizes: tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 15, 20)
    num_filters: tuple[int, ...] = (100, 200, 200, 200, 200, 100, 100, 100, 100, 100, 160, 160)
    dropout: float = 0.2
    l2_reg_lambda: float = 1e-5

    @property
    def goal_out_size(self) -> int:
        return sum(self.num_filters)

    @property
    def pad_token(self) -> int:
        # prefixes are padded with vocab_size; D's embedding has vocab + 1 rows
        return self.vocab_size

    @property
    def n_goals(self) -> int:
        return self.seq_len // self.step_size

    @classmethod
    def from_json(cls, leak_gan_params: dict) -> "LeakGanConfig":
        """The flat schema of the shipped params and the reference's nested
        one (``discriminator_params`` / ``generator_params.{worker,manager}_params``)."""
        p = dict(leak_gan_params)
        d = p.get("discriminator_params", {})
        g = p.get("generator_params", {})
        w = g.get("worker_params", {})
        m = g.get("manager_params", {})

        def pick(*vals, default):
            for v in vals:
                if v is not None:
                    return v
            return default

        return cls(
            vocab_size=pick(p.get("vocab_size"), w.get("vocab_size"),
                            d.get("vocab_size"), default=5258),
            seq_len=pick(p.get("seq_len"), d.get("seq_len"), default=20),
            step_size=pick(p.get("step_size"), g.get("step_size"),
                           d.get("step_size"), default=5),
            goal_size=pick(p.get("goal_size"), w.get("goal_size"), default=16),
            worker_emb_dim=pick(p.get("embed_dim"), w.get("embed_dim"), default=32),
            worker_hidden=pick(p.get("hidden_dim"), w.get("hidden_dim"), default=32),
            manager_hidden=pick(p.get("hidden_dim"), m.get("hidden_dim"), default=32),
            start_token=pick(p.get("start_token"), d.get("start_token"), default=0),
            temperature=float(p.get("temperature", 1.0)),
            dis_emb_dim=pick(p.get("dis_emb_dim"), d.get("dis_emb_dim"), default=64),
            filter_sizes=tuple(pick(p.get("filter_sizes"), d.get("filter_sizes"),
                                    default=cls.filter_sizes)),
            num_filters=tuple(pick(p.get("num_filters"), d.get("num_filters"),
                                   default=cls.num_filters)),
            dropout=float(pick(p.get("dropout"),
                               1.0 - d["dropout_keep_prob"]
                               if "dropout_keep_prob" in d else None,
                               default=0.2)),
            l2_reg_lambda=float(pick(p.get("l2_reg_lambda"),
                                     d.get("l2_reg_lambda"), default=1e-5)),
        )


def _truncated_normal(generator: torch.Generator, shape, std: float = 0.1) -> torch.Tensor:
    """``std`` times a standard normal truncated to (-2, 2), by the inverse
    CDF as ``jax.random.truncated_normal`` draws it."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator) * (hi - lo) + lo
    x = math.sqrt(2.0) * torch.erfinv(u)
    return std * x.clamp(math.nextafter(-2.0, 0.0), math.nextafter(2.0, 0.0))


def renorm_unit_ball(x: torch.Tensor, maxnorm: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """``torch.renorm(x, p=2, dim=0, maxnorm)``: rows scaled down into the
    L2 ball."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x * torch.clamp(maxnorm / torch.clamp(n, min=eps), max=1.0)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity along the last axis, each norm floored at ``eps``."""
    na = torch.clamp(torch.linalg.vector_norm(a, dim=-1), min=eps)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=eps)
    return torch.sum(a * b, dim=-1) / (na * nb)


# ---------------------------------------------------------------------------
# Discriminator (feature-leaking CNN)
# ---------------------------------------------------------------------------


def init_discriminator(generator: torch.Generator, cfg: LeakGanConfig,
                       device: torch.device | str = "cpu") -> dict:
    """Truncated-normal (std 0.1) conv weights and embedding (vocab + 1
    rows, the last for the pad token), conv biases 0.1, ``nn.Linear``-default
    highway and output."""
    convs = [{"w": _truncated_normal(generator, (fs, cfg.dis_emb_dim, nf)).to(device),
              "b": torch.full((nf,), 0.1, device=device)}
             for fs, nf in zip(cfg.filter_sizes, cfg.num_filters)]
    F = cfg.goal_out_size
    return {
        "embed": _truncated_normal(generator, (cfg.vocab_size + 1, cfg.dis_emb_dim)).to(device),
        "convs": convs,
        "highway_h": linear_init(generator, F, F, device=device),
        "highway_t": linear_init(generator, F, F, device=device),
        "out": linear_init(generator, F, 2, device=device),
    }


def discriminator_forward(params: dict, tokens: torch.Tensor, cfg: LeakGanConfig, *,
                          dropout_generator: torch.Generator | None = None,
                          dropout_mask: torch.Tensor | None = None) -> dict:
    """``{"pred": softmax probs [B, 2], "feature": [B, G], "score": [B, 2]}``;
    the leaked feature is taken after the highway and dropout."""
    f = highway(params, cnn_features(params, tokens))
    f = dropout(f, cfg.dropout, dropout_generator, dropout_mask)
    score = linear(params["out"], f)
    return {"pred": torch.softmax(score, dim=-1), "feature": f, "score": score}


def discriminator_l2(params: dict, cfg: LeakGanConfig) -> torch.Tensor:
    """L2 penalty on the output layer only."""
    W, b = params["out"]["w"], params["out"]["b"]
    return cfg.l2_reg_lambda * (torch.sum(W * W) + torch.sum(b * b))


# ---------------------------------------------------------------------------
# Manager / Worker / Generator
# ---------------------------------------------------------------------------


def init_generator(generator: torch.Generator, cfg: LeakGanConfig, batch_size: int,
                   device: torch.device | str = "cpu") -> dict:
    """Every Manager and Worker parameter N(0, 0.1); ``goal_init`` truncated
    normal, one row per batch row ``[batch_size, G]``."""
    G = cfg.goal_out_size
    nrm = lambda *shape: (0.1 * torch.randn(shape, generator=generator)).to(device)

    def lstm(in_dim, hidden):
        return {"wi": nrm(in_dim, 4 * hidden), "wh": nrm(hidden, 4 * hidden),
                "bi": nrm(4 * hidden), "bh": nrm(4 * hidden)}

    manager = {
        "lstm": lstm(G, cfg.manager_hidden),
        "fc": {"w": nrm(cfg.manager_hidden, G), "b": nrm(G)},
        "goal_init": _truncated_normal(generator, (batch_size, G)).to(device),
    }
    V, gs = cfg.vocab_size, cfg.goal_size
    worker = {
        "embed": nrm(V, cfg.worker_emb_dim),
        "lstm": lstm(cfg.worker_emb_dim, cfg.worker_hidden),
        "fc": {"w": nrm(cfg.worker_hidden, gs * V), "b": nrm(gs * V)},
        "goal_change": nrm(G, gs),
    }
    return {"manager": manager, "worker": worker}


def generator_step(g_params: dict, x_t: torch.Tensor, f_t: torch.Tensor, state: dict,
                   cfg: LeakGanConfig, temperature: float, *,
                   generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None):
    """One generator step: the Manager's sub-goal from the leaked feature,
    the Worker's logits through its goal-projected matrix O, the next token
    by Gumbel-max on ``temperature * logits`` (``noise [B, V]`` or a draw).

    ``state``: dict(h_m, c_m, h_w, c_w, last_goal, real_goal).
    Returns (sampled token [B], probs [B, V], sub_goal [B, G], new_state)."""
    B = x_t.shape[0]
    man, wrk = g_params["manager"], g_params["worker"]
    h_m, c_m = lstm_cell(man["lstm"], f_t, (state["h_m"], state["c_m"]))
    sub_goal = renorm_unit_ball(linear(man["fc"], h_m))
    h_w, c_w = lstm_cell(wrk["lstm"], wrk["embed"][x_t.long()], (state["h_w"], state["c_w"]))
    O = linear(wrk["fc"], h_w).reshape(B, cfg.vocab_size, cfg.goal_size)
    w_t = renorm_unit_ball(state["real_goal"] @ wrk["goal_change"])  # [B, goal_size]
    logits = temperature * torch.bmm(O, w_t[:, :, None])[..., 0]
    probs = torch.softmax(logits, dim=-1)
    if noise is None:
        noise = gumbel_noise(generator, logits.shape, logits.device)
    sampled = torch.argmax(logits.detach() + noise.to(logits.device), dim=-1)
    new_state = dict(state, h_m=h_m, c_m=c_m, h_w=h_w, c_w=c_w,
                     last_goal=state["last_goal"] + sub_goal)
    return sampled, probs, sub_goal, new_state


def _init_gen_state(g_params: dict, batch: int, cfg: LeakGanConfig,
                    goal_init_rows: torch.Tensor | None = None) -> dict:
    device = g_params["worker"]["embed"].device
    h_w, c_w = lstm_zero_state(batch, cfg.worker_hidden, device)
    h_m, c_m = lstm_zero_state(batch, cfg.manager_hidden, device)
    if goal_init_rows is None:
        goal_init_rows = g_params["manager"]["goal_init"][:batch]
    return {"h_m": h_m, "c_m": c_m, "h_w": h_w, "c_w": c_w,
            "last_goal": torch.zeros((batch, cfg.goal_out_size), device=device),
            "real_goal": goal_init_rows}


def _apply_goal_reset(state: dict, t: int, cfg: LeakGanConfig) -> dict:
    """At ``t % step_size == 0``: promote the accumulated goal to real_goal
    (except at t = 0, which keeps goal_init) and zero the accumulator."""
    if t % cfg.step_size:
        return state
    real_goal = state["last_goal"] if t > 0 else state["real_goal"]
    return dict(state, real_goal=real_goal, last_goal=torch.zeros_like(state["last_goal"]))


def _engine(g_params: dict, d_params: dict, cfg: LeakGanConfig, batch: int, *,
            n_steps: int, teacher_tokens: torch.Tensor | None = None,
            teacher_until: torch.Tensor | None = None,
            real_prefix: torch.Tensor | None = None, temperature: float = 1.0,
            goal_init_rows: torch.Tensor | None = None,
            generator: torch.Generator | None = None, noise: torch.Tensor | None = None,
            dropout_generator: torch.Generator | None = None,
            dropout_mask: torch.Tensor | None = None, collect: bool = True):
    """The unified recurrent engine (JAX's ``_engine_scan``).

    Per step t: D's feature on the current padded prefix, one generator
    step, the goal reset, the emitted token written into the prefix.

    - ``teacher_tokens`` + ``teacher_until``: the token at position t is
      ``teacher_tokens[:, t]`` while ``t < teacher_until`` (per stream:
      rollout streams of every restore point run together).
    - ``real_prefix``: 'pre' mode, D reads real tokens before t and pad
      after, whatever the Worker samples (it free-runs on its own samples).

    Returns ``(tokens [batch, seq_len], outs)``, ``outs`` the per-step
    ``feature``, ``probs``, ``token`` and ``real_goal`` stacked on a leading
    step axis, or None without ``collect``."""
    device = g_params["worker"]["embed"].device
    state = _init_gen_state(g_params, batch, cfg, goal_init_rows)
    buf = torch.full((batch, cfg.seq_len), cfg.pad_token, dtype=torch.long, device=device)
    pos = torch.arange(cfg.seq_len, device=device)
    if real_prefix is not None:
        real_prefix = real_prefix.long()
    if teacher_tokens is not None:
        teacher_tokens = teacher_tokens.long()
    x_t = torch.full((batch,), cfg.start_token, dtype=torch.long, device=device)
    outs = {"feature": [], "probs": [], "token": [], "real_goal": []}
    for t in range(n_steps):
        prefix = buf if real_prefix is None else torch.where(pos < t, real_prefix, cfg.pad_token)
        with torch.no_grad():
            f_t = discriminator_forward(
                d_params, prefix, cfg, dropout_generator=dropout_generator,
                dropout_mask=None if dropout_mask is None else dropout_mask[t])["feature"]
        sampled, probs, _, state = generator_step(
            g_params, x_t, f_t, state, cfg, temperature, generator=generator,
            noise=None if noise is None else noise[t])
        state = _apply_goal_reset(state, t, cfg)
        tok_t = sampled
        if teacher_tokens is not None:
            tok_t = torch.where(t < teacher_until, teacher_tokens[:, t], sampled)
        if t < cfg.seq_len:
            buf[:, t] = tok_t
        if collect:
            for k, v in (("feature", f_t), ("probs", probs), ("token", tok_t),
                         ("real_goal", state["real_goal"])):
                outs[k].append(v)
        x_t = tok_t
    return buf, ({k: torch.stack(v) for k, v in outs.items()} if collect else None)


# ---------------------------------------------------------------------------
# The four public engines
# ---------------------------------------------------------------------------


def _pre_adv_post(outs: dict, cfg: LeakGanConfig) -> dict:
    feats = outs["feature"]  # [T+1, B, G]
    k, n = cfg.step_size, cfg.n_goals
    # delta_feature[j] = f_{(j+1)k} - f_{jk}
    delta = torch.stack([feats[(j + 1) * k] - feats[j * k] for j in range(n)], dim=1)
    # real_goal after the reset at t = 0, k, ..., (n-1)k
    real_goal = torch.stack([outs["real_goal"][j * k] for j in range(n)], dim=1)
    prediction = outs["probs"][: cfg.seq_len].transpose(0, 1)  # [B, T, V]
    return {"real_goal": real_goal, "prediction": prediction, "delta_feature": delta}


def pre_engine(g_params, d_params, real_data, *, cfg: LeakGanConfig,
               generator=None, noise=None, dropout_generator=None, dropout_mask=None):
    """'pre': D reads real-data prefixes; returns real_goal [B, n_goals, G],
    prediction [B, T, V], delta_feature [B, n_goals, G]."""
    _, outs = _engine(g_params, d_params, cfg, real_data.shape[0], n_steps=cfg.seq_len + 1,
                      real_prefix=real_data, generator=generator, noise=noise,
                      dropout_generator=dropout_generator, dropout_mask=dropout_mask)
    return _pre_adv_post(outs, cfg)


def adv_engine(g_params, d_params, batch: int, *, cfg: LeakGanConfig,
               temperature: float = 1.0, generator=None, noise=None,
               dropout_generator=None, dropout_mask=None):
    """'adv': free-running; also returns all_goal [B, T, G],
    delta_feature_for_worker [B, T, G] and gen_token [B, T]."""
    tokens, outs = _engine(g_params, d_params, cfg, batch, n_steps=cfg.seq_len + 1,
                           temperature=temperature, generator=generator, noise=noise,
                           dropout_generator=dropout_generator, dropout_mask=dropout_mask)
    rets = _pre_adv_post(outs, cfg)
    feats, k = outs["feature"], cfg.step_size
    # Worker deltas at t = 1..T: f_t - f_{t - (t % k or k)}
    rets["delta_feature_for_worker"] = torch.stack(
        [feats[t] - feats[t - (t % k or k)] for t in range(1, cfg.seq_len + 1)], dim=1)
    rets["all_goal"] = outs["real_goal"][1:].transpose(0, 1)
    rets["gen_token"] = tokens
    return rets


@torch.no_grad()
def gen_samples(g_params, d_params, batch: int, *, cfg: LeakGanConfig,
                temperature: float = 1.0, generator=None, noise=None,
                goal_init_rows: torch.Tensor | None = None) -> torch.Tensor:
    """'gen': [batch, seq_len] sampled token ids.  ``goal_init_rows``
    (default ``goal_init[:batch]``) lets one pass sample several batches:
    row ``i`` from ``goal_init[i % batch_size]``, as batch after batch
    would."""
    tokens, _ = _engine(g_params, d_params, cfg, batch, n_steps=cfg.seq_len,
                        temperature=temperature, goal_init_rows=goal_init_rows,
                        generator=generator, noise=noise, collect=False)
    return tokens


def rescale_rewards(sums: torch.Tensor, *, delta: float = 16.0) -> torch.Tensor:
    """Rank-based rescale across the batch (axis 1):
    ``sigmoid(delta * (0.5 - rank / B))``, rank 1 the highest sum.  Stable
    sorts, as ``jnp.argsort``: equal sums rank by index."""
    B = sums.shape[1]
    order = torch.argsort(sums, dim=1, stable=True)
    rank = B - torch.argsort(order, dim=1, stable=True)
    return torch.sigmoid(delta * (0.5 - rank.to(torch.float32) / B))


@torch.no_grad()
def get_rewards(g_params, d_params, input_x: torch.Tensor, *, cfg: LeakGanConfig,
                rollout_num: int = 4, temperature: float = 1.0, delta: float = 16.0,
                generator=None, noise=None) -> torch.Tensor:
    """Rollout rewards [B, n_goals]: for each restore point 0, k, 2k, ...,
    ``rollout_num`` completions of each sequence, P(real) summed over the
    rollouts, rank-rescaled across the batch, divided by ``rollout_num``.
    All R x n_goals x B streams run in one engine pass (1,024 at the
    shipped config), stream (r, j, b) from batch row b's ``goal_init``.
    ``noise``: ``[seq_len, R*n_goals*B, V]``."""
    input_x = input_x.long()
    B, T = input_x.shape
    R, n = rollout_num, cfg.n_goals
    N = R * n * B
    device = input_x.device
    given = (torch.arange(n, device=device) * cfg.step_size)[None, :, None].expand(R, n, B)
    teacher = input_x.expand(R, n, B, T).reshape(N, T)
    gi = g_params["manager"]["goal_init"][:B]
    gi = gi.expand(R, n, B, gi.shape[-1]).reshape(N, -1)
    completions, _ = _engine(g_params, d_params, cfg, N, n_steps=cfg.seq_len,
                             teacher_tokens=teacher, teacher_until=given.reshape(N),
                             temperature=temperature, goal_init_rows=gi,
                             generator=generator, noise=noise, collect=False)
    pred = discriminator_forward(d_params, completions, cfg)["pred"][:, 1]
    sums = pred.reshape(R, n, B).sum(dim=0)  # [n, B]
    return rescale_rewards(sums, delta=delta).T / rollout_num


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def pre_manager_loss(real_goal, delta_feature):
    """``mean(1 - cos(goal, delta-f))``, minimised (divergence #7)."""
    return torch.mean(1.0 - cosine_similarity(real_goal, delta_feature))


def pre_worker_loss(real_data, prediction, vocab_size):
    """``-sum(onehot(real) * log clamp(probs)) / (B*T*V)``: the mean over
    every element, as the reference takes it."""
    logp = torch.log(torch.clamp(prediction, 1e-20, 1.0))
    picked = torch.gather(logp, -1, real_data.long()[..., None])
    return -torch.sum(picked) / prediction.numel()


def adv_manager_loss(rewards, real_goal, delta_feature):
    """``-mean(reward * (1 - cos))``."""
    return -torch.mean(rewards * (1.0 - cosine_similarity(delta_feature, real_goal)))


def adv_worker_loss(all_goal, delta_feature_for_worker, gen_token, prediction, vocab_size):
    """``-mean(intrinsic * log p(token))``, intrinsic ``1 - cos(goal, delta-f)``."""
    intrinsic = 1.0 - cosine_similarity(all_goal, delta_feature_for_worker)  # [B, T]
    logp = torch.log(torch.clamp(prediction, 1e-20, 1.0))
    picked = torch.gather(logp, -1, gen_token.long()[..., None])[..., 0]
    return -torch.mean(intrinsic * picked)


def dis_loss(d_params, tokens, labels, cfg: LeakGanConfig, *, dropout_generator=None,
             dropout_mask=None):
    """Cross-entropy plus the output layer's L2."""
    out = discriminator_forward(d_params, tokens, cfg, dropout_generator=dropout_generator,
                                dropout_mask=dropout_mask)
    logp = torch.log_softmax(out["score"], dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[:, None]).mean()
    return ce + discriminator_l2(d_params, cfg)
