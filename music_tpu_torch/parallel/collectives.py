"""Collectives with the gradients JAX derives for them under ``shard_map``.

JAX differentiates through ``shard_map``: the transpose of each collective
and the sum of a replicated parameter's gradient over the devices come from
the compiler.  Over ``torch.distributed`` each is written out here, as
``torch.autograd.Function``s.  A plain ``dist.all_reduce`` has no autograd,
and ``torch.distributed.nn.functional.all_reduce`` sums the gradient in its
backward, which is wrong where every rank goes on with the same sum.

- :func:`copy_to` (Megatron's "f"): identity forward, sum over the group
  backward.  The entry of a column-parallel product: its input is
  replicated and each rank's product gives it a partial gradient.
- :func:`reduce_from` (Megatron's "g"): sum over the group forward,
  identity backward.  The exit of a row-parallel product (JAX's ``psum``
  after ``post1``/``conn1``).
- :func:`all_gather`: concatenation of the ranks' blocks; backward hands
  each rank its block of the gradient summed over the group.
- :func:`gather_from`: the same concatenation for a tensor every rank then
  uses whole and alike (the tensor-parallel GAN discriminators' features
  and hidden states); backward hands each rank its block of the gradient,
  which is whole on every rank already.
- :func:`group_mean`: the mean over a group of a tensor that the ranks go
  on to use alike; backward gives this rank its share, the gradient over
  the group's size (for :func:`sum_grads` to sum).
- :func:`pmean`: a loss's mean over mesh axes; backward gives this rank's
  share of the gradient, which :func:`sum_grads` sums over ``(data, seq)``.

Every function is the identity without a process group (a mesh of one
rank).  The collectives run in the tensors' dtype: gloo (PyTorch 2.13, on
the CPU) and NCCL both sum bf16.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from music_tpu_torch.core import optim
from music_tpu_torch.parallel.mesh import Mesh

LOSS_AXES = ("data", "seq")
"""The axes a loss is a mean over and its gradient a sum over."""


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, share):
        ctx.share = share
        return _all_reduce(x, group) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.share, None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` forward (JAX's ``psum``); identity backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``group`` concatenated along ``dim`` in rank
    order (JAX's ``all_gather(tiled=True)``); backward returns this rank's
    block of the gradient summed over ``group``."""
    return x if group is None else _AllGather.apply(x, group, dim)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``group`` concatenated along ``dim`` in rank
    order, for a result every rank uses alike (or enters through
    :func:`copy_to` where it uses its own part): backward returns this
    rank's block of the gradient, with no collective (Megatron's gather of
    a tensor-parallel region)."""
    return x if group is None else _GatherFrom.apply(x, group, dim)


def group_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (JAX's ``pmean`` of a value inside a
    loss, such as feature matching's feature means).  Every rank goes on
    with the same mean, so backward gives this rank's share, the gradient
    over the group's size: :func:`sum_grads` over the group then gives the
    whole gradient."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    return _Pmean.apply(x, group, n, n)


@torch.no_grad()
def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group``, outside autograd (statistics that
    every rank must read alike, such as a trainer's gates)."""
    if group is None:
        return x
    return _all_reduce(x, group) / dist.get_world_size(group)


def pmean(x: torch.Tensor, mesh: Mesh, axes: tuple[str, ...] = LOSS_AXES) -> torch.Tensor:
    """The mean of the scalar ``x`` over the mesh ``axes`` (JAX's ``pmean``,
    for a loss).  Its backward gives this rank's share, the gradient over
    the size of ``(data, seq)``: :func:`sum_grads` over that group then
    gives the gradient of the mean.  With ``axes=("data",)`` the ``seq``
    ranks hold the same loss, and their shares sum to its gradient too."""
    group = mesh.group(axes)
    if group is None:
        return x
    return _Pmean.apply(x, group, mesh.size(axes), mesh.size(LOSS_AXES))


def sum_grads(grads: Any, mesh: Mesh) -> Any:
    """Every gradient leaf summed over the ``(data, seq)`` group, in one
    all-reduce of their concatenation."""
    group = mesh.group(LOSS_AXES)
    if group is None:
        return grads
    leaves = optim.tree_leaves(grads)
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in leaves]), group)
    sums, i = [], 0
    for g in leaves:
        sums.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
        i += g.numel()
    return optim.tree_unflatten(grads, sums)


class ModelSplit:
    """The tensor-parallel split of a skip path over the mesh's ``model``
    axis, as the models' ``split=`` hook: :meth:`enter` before the
    column-parallel skip products, :meth:`exit` after the row-parallel
    ``post1``/``conn1`` product."""

    def __init__(self, mesh: Mesh):
        self.group = mesh.group("model")

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.group)


def _leaf_specs(tree: Any, specs: Any):
    """``(leaf, spec)`` pairs of a tree of updates and the tree of specs
    beside it (a spec is a tuple; a key missing from a dict of specs, or no
    spec at all, means replicated)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_specs(tree[k], specs.get(k, ()) if isinstance(specs, dict) else ())
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _leaf_specs(t, specs[i] if isinstance(specs, list) else ())
    else:
        yield tree, specs if isinstance(specs, tuple) else ()


def sharded_global_norm(mesh: Mesh, specs: Any) -> Callable[[Any], torch.Tensor]:
    """The global norm of a tree of updates, some leaves split by ``specs``
    (the same tree of partition specs: a dict of parameter name -> spec for
    WaveNet, :func:`music_tpu_torch.parallel.gan_tp.discriminator_specs` for
    a GAN discriminator): each split leaf's square summed over its axes'
    group, each replicated leaf counted once (what optax's global norm of
    the whole arrays gives); for
    :func:`music_tpu_torch.core.optim.from_config`'s ``global_norm``."""
    def norm(updates: Any) -> torch.Tensor:
        sq: dict[tuple, torch.Tensor] = {}
        for g, spec in _leaf_specs(updates, specs):
            axes = tuple(a for a in spec if a is not None)
            g = g.to(torch.promote_types(g.dtype, torch.float32))
            sq[axes] = sq.get(axes, 0) + torch.linalg.vector_norm(g) ** 2
        total = sq.pop((), 0)
        for axes, s in sq.items():
            group = mesh.group(axes)
            total = total + (s if group is None else _all_reduce(s, group))
        return torch.sqrt(torch.as_tensor(total))

    return norm
