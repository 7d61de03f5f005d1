"""The GAN families' data and tensor parallelism (counterpart of
:mod:`music_tpu.parallel.gan_tp`).

The widest layers of the GAN families are the 12-bank, 1720-filter CNN
discriminator of SeqGAN and LeakGAN with its 1720-wide highway, and the
bi-LSTM discriminator of C-RNN-GAN.  Both split Megatron-style over the
mesh's ``model`` axis (:mod:`music_tpu_torch.parallel.collectives`):

- CNN (:func:`discriminator_forward_tp`): every conv bank's filters are
  split as columns, so each rank computes a contiguous chunk of every
  bank's features; one gather over ``model`` and a fixed permutation
  rebuild the bank-major feature ``f`` on every rank.  The highway's two
  ``F x F`` products are split as columns (``f`` whole in, through
  ``copy_to``: its gradient sums over ``model``), the gate then needs only
  the matching columns of ``f``, and the 2-logit head is split as rows,
  followed by one sum (``reduce_from``).  LeakGAN's contract also gathers
  the post-highway feature it leaks to its generator.  Dropout draws the
  whole ``[B, F]`` mask from a generator every ``model`` rank shares and
  applies this rank's columns: the single-device mask.
- bi-LSTM (:func:`crnngan_forward_tp`): the hidden dimension is split by
  :mod:`music_tpu_torch.parallel.rnn_tp`, one gather of ``h`` per layer
  pair per time step (both directions of a layer side by side).

JAX derives the backward collectives by differentiating through
``shard_map``; here they are the autograd of ``copy_to``, ``reduce_from``
and ``gather_from``.  :class:`TrainerMesh` is what the three GAN trainers
need of a mesh: the ``data`` split of their batches and randomness, the
loss mean and gradient sum over ``data``, and the ``model`` split of D.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from music_tpu_torch.core import optim
from music_tpu_torch.ops.rnn import linear
from music_tpu_torch.parallel import rnn_tp
from music_tpu_torch.parallel.collectives import (
    LOSS_AXES, copy_to, gather_from, mean_over, pmean, reduce_from, sharded_global_norm,
    sum_grads,
)
from music_tpu_torch.parallel.mesh import Mesh, P, block, gather, shard

# ---------------------------------------------------------------------------
# Trees of split parameters
# ---------------------------------------------------------------------------


def discriminator_specs(cfg) -> dict:
    """Partition specs of a SeqGAN or LeakGAN discriminator tree (either
    model's ``init_discriminator``): conv filters and the highway split as
    columns, the head as rows, the embedding replicated."""
    return {
        "embed": P(),
        "convs": [{"w": P(None, None, "model"), "b": P("model")} for _ in cfg.num_filters],
        "highway_h": {"w": P(None, "model"), "b": P("model")},
        "highway_t": {"w": P(None, "model"), "b": P("model")},
        "out": {"w": P("model", None), "b": P()},
    }


def check_filters(cfg, m: int) -> None:
    """Every conv bank must split evenly over ``m`` ranks."""
    for nf in cfg.num_filters:
        if nf % m:
            raise ValueError(f"num_filters entry {nf} not divisible by model axis {m}")


def shard_tree(mesh: Mesh, tree: Any, specs: Any) -> Any:
    """This rank's blocks of a whole parameter tree, split by the tree of
    ``specs`` beside it, on the mesh's device."""
    return optim.tree_map(lambda x, spec: shard(mesh, x, spec), tree, specs)


def gather_tree(mesh: Mesh, tree: Any, specs: Any) -> Any:
    """The whole tree of which ``tree`` holds this rank's blocks (every rank
    of the split axes' groups must call it)."""
    return optim.tree_map(lambda x, spec: gather(mesh, x, spec), tree, specs)


def map_param_trees(state: Any, fn: Callable[[Any], Any]) -> Any:
    """``fn`` applied to every parameter-shaped tree of an optimizer state
    (Adam's ``mu`` and ``nu``: the dicts of its tuples and dataclasses),
    the rest (counts, empty states) unchanged."""
    if isinstance(state, dict):
        return fn(state)
    if isinstance(state, tuple):
        return tuple(map_param_trees(s, fn) for s in state)
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return dataclasses.replace(state, **{
            f.name: map_param_trees(getattr(state, f.name), fn)
            for f in dataclasses.fields(state)})
    return state


# ---------------------------------------------------------------------------
# The CNN discriminator of SeqGAN and LeakGAN
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _bank_major(num_filters: tuple[int, ...], m: int) -> np.ndarray:
    """For each bank-major feature index, its column in the gather of the
    ranks' local features (rank-major, each rank's chunks bank-major)."""
    offsets = np.concatenate([[0], np.cumsum(num_filters)])
    width = int(offsets[-1]) // m
    local = np.concatenate([[0], np.cumsum([nf // m for nf in num_filters])])
    perm = np.empty(int(offsets[-1]), np.int64)
    for i, nf in enumerate(num_filters):
        chunk = nf // m
        for s in range(m):
            perm[offsets[i] + s * chunk: offsets[i] + (s + 1) * chunk] = (
                s * width + local[i] + np.arange(chunk))
    return perm


def _rank(group) -> tuple[int, int]:
    """``(index, size)`` of this rank in ``group`` (``(0, 1)`` without one)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def discriminator_forward_tp(params: dict, tokens: torch.Tensor, cfg, group, *,
                             dropout_generator: torch.Generator | None = None,
                             dropout_mask: torch.Tensor | None = None,
                             post_highway_feature: bool = False,
                             softmax_pred: bool = False) -> dict:
    """The discriminator forward from this rank's blocks (split by
    :func:`discriminator_specs`) over the ``model`` ``group``: the values of
    the single-device ``discriminator_forward`` of either GAN.
    ``post_highway_feature``/``softmax_pred`` select LeakGAN's contract
    (the post-highway feature, softmax ``pred``), SeqGAN's is the default.
    ``tokens`` replicated; ``dropout_mask``: the whole ``[B, F]`` keep
    mask, or drawn whole from ``dropout_generator`` (which every rank of
    ``group`` must hold in the same state)."""
    from music_tpu_torch.models.seqgan import conv_features

    s, m = _rank(group)
    num_filters = tuple(cfg.num_filters)
    F = sum(num_filters)
    width = F // m
    # 1. this rank's chunk of every bank; one gather and a permutation
    #    rebuild the bank-major feature on every rank
    x = copy_to(params["embed"][tokens.long()], group)
    local = conv_features(x, params["convs"])  # [B, F/m]
    f = gather_from(local, group, 1)
    if m > 1:
        f = f[:, torch.as_tensor(_bank_major(num_filters, m), device=f.device)]
    # 2. column-split highway: f whole in, this rank's columns out
    f_in = copy_to(f, group)
    h = torch.relu(linear(params["highway_h"], f_in))
    t = torch.sigmoid(linear(params["highway_t"], f_in))
    hw = t * h + (1.0 - t) * f_in[:, s * width:(s + 1) * width]
    if cfg.dropout > 0 and (dropout_generator is not None or dropout_mask is not None):
        keep = 1.0 - cfg.dropout
        if dropout_mask is None:
            dropout_mask = torch.rand((f.shape[0], F), generator=dropout_generator,
                                      device=f.device) < keep
        mask = dropout_mask.to(hw.device)[:, s * width:(s + 1) * width]
        hw = torch.where(mask, hw / keep, 0.0)
    # 3. row-split head: one sum
    score = reduce_from(hw @ params["out"]["w"], group) + params["out"]["b"]
    feature = gather_from(hw, group, 1) if post_highway_feature else f
    pred = torch.softmax(score, dim=-1) if softmax_pred else torch.log_softmax(score, dim=-1)
    return {"pred": pred, "feature": feature, "score": score}


def _ce(score: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(score, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def seqgan_dis_loss_tp(d_params: dict, tokens, labels, cfg, group, *,
                       dropout_generator=None, dropout_mask=None) -> torch.Tensor:
    """SeqGAN's D loss (cross-entropy) from the split forward."""
    out = discriminator_forward_tp(d_params, tokens, cfg, group,
                                   dropout_generator=dropout_generator,
                                   dropout_mask=dropout_mask)
    return _ce(out["score"], labels)


def leakgan_dis_loss_tp(d_params: dict, tokens, labels, cfg, group, *,
                        dropout_generator=None, dropout_mask=None) -> torch.Tensor:
    """LeakGAN's D loss: cross-entropy plus the head's L2, its split rows'
    squares summed over ``group``."""
    out = leakgan_forward_tp(d_params, tokens, cfg, group=group,
                             dropout_generator=dropout_generator, dropout_mask=dropout_mask)
    W, b = d_params["out"]["w"], d_params["out"]["b"]
    l2 = cfg.l2_reg_lambda * (reduce_from(torch.sum(W * W), group) + torch.sum(b * b))
    return _ce(out["score"], labels) + l2


def leakgan_forward_tp(d_params: dict, tokens, cfg, *, group, dropout_generator=None,
                       dropout_mask=None) -> dict:
    """LeakGAN's contract of the split forward with the engines'
    ``d_forward`` signature (bind ``group`` with ``functools.partial``), so
    the in-engine feature leaks run split."""
    return discriminator_forward_tp(d_params, tokens, cfg, group,
                                    dropout_generator=dropout_generator,
                                    dropout_mask=dropout_mask, post_highway_feature=True,
                                    softmax_pred=True)


def seqgan_pos_prob_tp(d_params: dict, tokens, cfg, *, group) -> torch.Tensor:
    """P(real) per sequence from the split forward: the rollout's
    ``pos_prob_fn`` (bind ``cfg`` and ``group``)."""
    score = discriminator_forward_tp(d_params, tokens, cfg, group)["score"]
    return torch.softmax(score, dim=-1)[:, 1]


# ---------------------------------------------------------------------------
# The bi-LSTM discriminator of C-RNN-GAN
# ---------------------------------------------------------------------------

_CRNNGAN_LSTMS = ("fwd1", "bwd1", "fwd2", "bwd2")


def crnngan_d_specs() -> dict:
    """Partition specs of a repacked C-RNN-GAN discriminator tree
    (:func:`repack_crnngan_d`); the small per-step head stays replicated."""
    specs = {k: rnn_tp.lstm_specs() for k in _CRNNGAN_LSTMS}
    specs["out"] = {"w": P(), "b": P()}
    return specs


def repack_crnngan_d(params: dict, m: int) -> dict:
    """Gate-major repack of all four LSTMs (:func:`rnn_tp.repack_lstm_params`);
    :func:`unpack_crnngan_d` inverts it, for checkpoints in torch's gate
    order."""
    return {k: (rnn_tp.repack_lstm_params(v, m) if k in _CRNNGAN_LSTMS else v)
            for k, v in params.items()}


def unpack_crnngan_d(params: dict, m: int) -> dict:
    """The inverse of :func:`repack_crnngan_d` (torch's gate order)."""
    return {k: (rnn_tp.unpack_lstm_params(v, m) if k in _CRNNGAN_LSTMS else v)
            for k, v in params.items()}


def crnngan_forward_tp(params: dict, events: torch.Tensor, cfg, meta=None, *, group):
    """The bi-LSTM discriminator forward from this rank's repacked blocks
    (:func:`crnngan_d_specs`): the single-device
    ``crnngan.discriminator_forward`` of the unpacked parameters,
    ``(decisions [B, T], features [B, T, 2H])`` whole on every rank.  Both
    directions of a layer run side by side, one gather of ``h`` a step."""
    from music_tpu_torch.models.crnngan import condition_events

    xs = condition_events(events, meta, cfg).transpose(0, 1)  # [T, B, F]

    def bilstm(fwd, bwd, xs):
        out = rnn_tp.lstm_stack_tp([fwd, bwd], torch.stack([xs, xs.flip(0)]), group)
        return torch.cat([out[0], out[1].flip(0)], dim=-1)

    h = bilstm(params["fwd1"], params["bwd1"], xs)
    h = bilstm(params["fwd2"], params["bwd2"], h).transpose(0, 1)
    return torch.sigmoid(linear(params["out"], h)[..., 0]), h


# ---------------------------------------------------------------------------
# What a GAN trainer needs of its mesh
# ---------------------------------------------------------------------------


class TrainerMesh:
    """A GAN trainer's view of its ``(data, seq, model)`` mesh, or of one
    device when ``mesh`` is None (every method then the identity).

    - ``data``: each rank takes the rows of its data coordinate
      (:meth:`rows`), draws its own randomness (:attr:`data_index` folded
      into the trainer's seeds), its loss is the mean over ``data``
      (:meth:`loss`) and its gradients are summed before every update
      (:meth:`reduce_grads`), so the update is that of the global batch.
    - ``seq``: its ranks hold the same rows and draw the same numbers:
      replicas, as in JAX's GAN trainers.
    - ``model``: D is split (:attr:`tp`, :attr:`model_group`), its clip norm
      taken over the whole arrays (:meth:`global_norm`)."""

    def __init__(self, mesh: Mesh | None):
        self.mesh = mesh
        self.m = 1 if mesh is None else mesh.shape["model"]
        self.tp = self.m > 1
        self.data_index = 0 if mesh is None else mesh.index("data")
        self.data_group = None if mesh is None else mesh.group("data")
        self.model_group = None if mesh is None else mesh.group("model")
        # a mean over the whole batch inside a loss is taken over (data, seq):
        # the seq ranks' equal shares then sum to the gradient as data's do
        self.loss_group = None if mesh is None else mesh.group(LOSS_AXES)

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` global rows (all of them alone)."""
        if self.mesh is None:
            return slice(0, n)
        return block(n, self.mesh.shape["data"], self.data_index)

    def loss(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of this rank's loss over ``data`` (its backward this
        rank's share of the gradient)."""
        return x if self.mesh is None else pmean(x, self.mesh, ("data",))

    def reduce_grads(self, grads: Any) -> Any:
        """The ranks' gradient shares summed over ``(data, seq)``."""
        return grads if self.mesh is None else sum_grads(grads, self.mesh)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over ``data`` outside autograd: a statistic every
        rank must read alike (the C-RNN-GAN gates)."""
        return mean_over(x, self.data_group)

    def global_norm(self, specs: Any):
        """The clip norm of a split tree (None, optax's own, unless split)."""
        return sharded_global_norm(self.mesh, specs) if self.tp else None

    def shard(self, tree: Any, specs: Any) -> Any:
        """This rank's blocks of a whole tree split by ``specs`` (the tree
        itself unless D is split)."""
        return tree if not self.tp else shard_tree(self.mesh, tree, specs)

    def gather(self, tree: Any, specs: Any) -> Any:
        """The whole tree of this rank's blocks (every rank calls it)."""
        return tree if not self.tp else gather_tree(self.mesh, tree, specs)
