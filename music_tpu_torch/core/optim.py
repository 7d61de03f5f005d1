"""Optimizers with optax's semantics on dicts of tensors (counterpart of
:mod:`music_tpu.core.optim`).

Each optimizer is a chain of small transformations, as optax builds it,
and its state has optax's layout: a tuple with one entry per transformation
of the chain, each a dataclass whose fields carry optax's names.  So
``adam``'s state is ``(ScaleByAdamState(count, mu, nu), EmptyState())`` and
a checkpoint stores its leaves under ``.opt_state[0].count``,
``.opt_state[0].mu['fg']``..., the key paths of a JAX checkpoint: either
package resumes from the other's optimizer state.

The update rules are optax's, not ``torch.optim``'s defaults: ``rmsprop``
decays its second moment by 0.9 and adds eps inside the square root, and
learning-rate schedules count update steps.  Adam, the global-norm clip,
the learning-rate scales and ``apply_updates`` run each of their
elementwise steps over all leaves at once (``torch._foreach_*``): a few
launches a step instead of ~20 a leaf, which set the pace of the GAN
discriminators' small steps (31 leaves).  The clip multiplies by
``max_norm / norm`` where optax divides by the norm, then multiplies:
within an ulp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple

import torch

from music_tpu_torch.utils import profiling


class OptimizerError(ValueError):
    pass


@dataclasses.dataclass
class EmptyState:
    pass


@dataclasses.dataclass
class TraceState:
    trace: Any


@dataclasses.dataclass
class ScaleByRmsState:
    nu: Any


@dataclasses.dataclass
class ScaleByAdamState:
    count: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass
class ScaleByScheduleState:
    count: torch.Tensor


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(updates, state, params) ->
    (updates, state)``, on (nested) dicts of tensors."""

    init: Callable
    update: Callable


Schedule = Callable[[Any], Any]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of nested dicts (keys in sorted order) and
    lists (the GAN discriminators' ``convs``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of nested dicts and lists in jax's order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Any, leaves: list[torch.Tensor]) -> Any:
    """``leaves`` (in :func:`tree_leaves`' order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _count_like(params: Any) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda updates, state, params=None: (updates, state))


def trace(decay: float) -> GradientTransformation:
    """Momentum: ``t = g + decay * t``, and the update is ``t``."""
    def update(updates, state, params=None):
        new = tree_map(lambda g, t: g + decay * t, updates, state.trace)
        return new, TraceState(new)

    return GradientTransformation(lambda params: TraceState(tree_map(torch.zeros_like, params)),
                                  update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8) -> GradientTransformation:
    """``nu = (1 - decay) g^2 + decay nu`` from zero; ``g / sqrt(nu + eps)``."""
    def update(updates, state, params=None):
        nu = tree_map(lambda g, n: (1 - decay) * g**2 + decay * n, updates, state.nu)
        return tree_map(lambda g, n: torch.rsqrt(n + eps) * g, updates, nu), ScaleByRmsState(nu)

    return GradientTransformation(
        lambda params: ScaleByRmsState(tree_map(torch.zeros_like, params)), update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """Adam's moments with bias correction: ``mu_hat / (sqrt(nu_hat) + eps)``."""
    def init(params):
        return ScaleByAdamState(_count_like(params), tree_map(torch.zeros_like, params),
                                tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        g, fe = tree_leaves(updates), torch
        mu = fe._foreach_add(fe._foreach_mul(g, 1 - b1),
                             fe._foreach_mul(tree_leaves(state.mu), b1))
        nu = fe._foreach_add(fe._foreach_mul(fe._foreach_mul(g, g), 1 - b2),
                             fe._foreach_mul(tree_leaves(state.nu), b2))
        count = state.count + 1
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        denom = fe._foreach_add(fe._foreach_sqrt(fe._foreach_div(nu, c2)), eps)
        out = fe._foreach_div(fe._foreach_div(mu, c1), denom)
        return tree_unflatten(updates, out), ScaleByAdamState(
            count.to(torch.int32), tree_unflatten(updates, mu), tree_unflatten(updates, nu))

    return GradientTransformation(init, update)


def scale(step_size: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return tree_unflatten(updates, torch._foreach_mul(tree_leaves(updates), step_size)), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
    """``step_size_fn(count) * g``, ``count`` the updates made so far."""
    def update(updates, state, params=None):
        g = tree_leaves(updates)
        step = torch.as_tensor(step_size_fn(state.count), dtype=g[0].dtype, device=g[0].device)
        out = tree_unflatten(updates, torch._foreach_mul(g, step))
        return out, ScaleByScheduleState((state.count + 1).to(torch.int32))

    return GradientTransformation(lambda params: ScaleByScheduleState(_count_like(params)),
                                  update)


def scale_by_learning_rate(learning_rate: float | Schedule) -> GradientTransformation:
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -learning_rate(count))
    return scale(-learning_rate)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise OptimizerError("add_decayed_weights needs the params")
        return tree_map(lambda g, p: g + weight_decay * p, updates, params), state

    return GradientTransformation(lambda params: EmptyState(), update)


def clip_by_global_norm(max_norm: float,
                        global_norm: Callable[[Any], torch.Tensor] | None = None
                        ) -> GradientTransformation:
    """Scale every update by ``max_norm / ||g||`` when the global norm of
    all of them reaches ``max_norm``.  ``global_norm(updates)`` replaces
    the norm over the leaves held here: a state split over ranks needs the
    norm of the whole arrays
    (:func:`music_tpu_torch.parallel.collectives.sharded_global_norm`)."""
    def update(updates, state, params=None):
        g = tree_leaves(updates)
        if global_norm is not None:
            g_norm = global_norm(updates)
        else:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        factor = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm).to(g[0].dtype)
        return tree_unflatten(updates, torch._foreach_mul(g, factor)), state

    return GradientTransformation(lambda params: EmptyState(), update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """Apply ``txs`` in order; the state is the tuple of their states."""
    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(lambda params: tuple(tx.init(params) for tx in txs), update)


def adam(learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam``: Adam's moments, then the (scheduled) learning rate."""
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))


@torch.no_grad()
def apply_updates(params: Any, updates: Any) -> Any:
    """``params + updates``, each in its parameter's dtype."""
    p = tree_leaves(params)
    new = torch._foreach_add(p, tree_leaves(updates))
    return tree_unflatten(params, [n.to(q.dtype) for n, q in zip(new, p)])


def make_optimizer(
    name: str,
    learning_rate: float | Schedule,
    *,
    momentum: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip_norm: float | None = None,
    global_norm: Callable[[Any], torch.Tensor] | None = None,
) -> GradientTransformation:
    """Build an optimizer by name, as the JAX package builds it from optax:
    ``sgd`` (with ``momentum``), ``rmsprop`` (decay 0.9, eps inside the
    square root, with a momentum trace), ``adam`` and ``adamw``; with
    ``grad_clip_norm``, clipped by global norm first (``global_norm``: see
    :func:`clip_by_global_norm`)."""
    name = name.lower()
    if name == "sgd":
        tx = chain(trace(momentum) if momentum else identity(),
                   scale_by_learning_rate(learning_rate))
    elif name == "rmsprop":
        tx = chain(scale_by_rms(eps=eps), scale_by_learning_rate(learning_rate),
                   trace(momentum))
    elif name == "adam":
        tx = adam(learning_rate, b1, b2, eps)
    elif name == "adamw":
        tx = chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                   scale_by_learning_rate(learning_rate))
    elif name == "lbfgs":
        raise NotImplementedError(
            "lbfgs (optax's zoom linesearch) is not ported yet; see ROADMAP.md, queue A")
    else:
        raise OptimizerError(f"unknown optimizer {name!r}")
    if grad_clip_norm is not None:
        tx = chain(clip_by_global_norm(grad_clip_norm, global_norm), tx)
    return tx


def step_lr(base_lr: float, step_size: int, gamma: float) -> Schedule:
    """``base_lr * gamma ** (count // step_size)`` over update steps
    (``torch.optim.lr_scheduler.StepLR`` stepped once per update)."""
    def schedule(count):
        return base_lr * (gamma ** (count // step_size))

    return schedule


def from_config(cfg: Mapping[str, Any],
                global_norm: Callable[[Any], torch.Tensor] | None = None
                ) -> GradientTransformation:
    """An optimizer from a ``train_params`` dict (``optimizer`` or
    ``optimizer_type``; ``learning_rate`` or ``lr``); ``global_norm`` for
    its clip, as :func:`clip_by_global_norm` takes it."""
    name = cfg.get("optimizer", cfg.get("optimizer_type", "adam"))
    lr = cfg.get("learning_rate", cfg.get("lr", 1e-3))
    return make_optimizer(
        name,
        lr,
        momentum=cfg.get("momentum", 0.0),
        weight_decay=cfg.get("weight_decay", 0.0),
        grad_clip_norm=cfg.get("grad_clip_norm"),
        global_norm=global_norm,
    )


def live(params: Any) -> Any:
    """``params`` detached, as leaves that autograd differentiates."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def tree_grads(loss: torch.Tensor, tree: Any, retain_graph: bool = False) -> Any:
    """d loss / d every tensor of ``tree`` (leaves of :func:`live`), in its
    structure; zeros where the loss does not reach, as ``jax.grad`` gives."""
    leaves = tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves, retain_graph=retain_graph, allow_unused=True)
    return tree_unflatten(tree, [torch.zeros_like(p) if g is None else g
                                 for p, g in zip(leaves, grads)])


def grad_update(tx: GradientTransformation, params: Any, opt_state: Any,
                loss_fn: Callable, reduce_grads: Callable[[Any], Any] | None = None
                ) -> tuple[Any, Any, torch.Tensor]:
    """One update on ``loss_fn(params)`` (``jax.value_and_grad``, then
    ``tx.update`` and ``apply_updates``): ``(params, opt_state, loss)``.
    ``reduce_grads`` combines the gradients of ranks before the update
    (:func:`music_tpu_torch.parallel.collectives.sum_grads`)."""
    variables = live(params)
    with profiling.span("step.forward"):
        loss = loss_fn(variables)
    with profiling.span("step.backward"):
        grads = tree_grads(loss, variables)
    if reduce_grads is not None:
        grads = reduce_grads(grads)
    with torch.no_grad(), profiling.span("step.update"):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
    return params, opt_state, loss.detach()
