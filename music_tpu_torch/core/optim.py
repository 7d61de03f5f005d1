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
learning-rate schedules count update steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple

import torch


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
    """``fn`` over the tensors of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


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
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, updates, state.mu)
        nu = tree_map(lambda g, n: (1 - b2) * g**2 + b2 * n, updates, state.nu)
        count = state.count + 1
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        out = tree_map(lambda m, n: (m / c1.to(m.dtype)) / (torch.sqrt(n / c2.to(n.dtype)) + eps),
                       mu, nu)
        return out, ScaleByAdamState(count.to(torch.int32), mu, nu)

    return GradientTransformation(init, update)


def scale(step_size: float) -> GradientTransformation:
    return GradientTransformation(
        lambda params: EmptyState(),
        lambda updates, state, params=None: (tree_map(lambda g: step_size * g, updates), state))


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
    """``step_size_fn(count) * g``, ``count`` the updates made so far."""
    def update(updates, state, params=None):
        step = step_size_fn(state.count)
        out = tree_map(lambda g: torch.as_tensor(step, dtype=g.dtype, device=g.device) * g,
                       updates)
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


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by ``max_norm / ||g||`` when the global norm of
    all of them reaches ``max_norm``."""
    def update(updates, state, params=None):
        g_norm = torch.sqrt(sum(torch.sum(g**2) for g in tree_leaves(updates)))
        keep = g_norm < max_norm
        return tree_map(lambda g: torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm),
                        updates), state

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


@torch.no_grad()
def apply_updates(params: Any, updates: Any) -> Any:
    """``params + updates``, each in its parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


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
) -> GradientTransformation:
    """Build an optimizer by name, as the JAX package builds it from optax:
    ``sgd`` (with ``momentum``), ``rmsprop`` (decay 0.9, eps inside the
    square root, with a momentum trace), ``adam`` and ``adamw``; with
    ``grad_clip_norm``, clipped by global norm first."""
    name = name.lower()
    if name == "sgd":
        tx = chain(trace(momentum) if momentum else identity(),
                   scale_by_learning_rate(learning_rate))
    elif name == "rmsprop":
        tx = chain(scale_by_rms(eps=eps), scale_by_learning_rate(learning_rate),
                   trace(momentum))
    elif name == "adam":
        tx = chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))
    elif name == "adamw":
        tx = chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                   scale_by_learning_rate(learning_rate))
    elif name == "lbfgs":
        raise NotImplementedError(
            "lbfgs (optax's zoom linesearch) is not ported yet; see ROADMAP.md, queue A")
    else:
        raise OptimizerError(f"unknown optimizer {name!r}")
    if grad_clip_norm is not None:
        tx = chain(clip_by_global_norm(grad_clip_norm), tx)
    return tx


def step_lr(base_lr: float, step_size: int, gamma: float) -> Schedule:
    """``base_lr * gamma ** (count // step_size)`` over update steps
    (``torch.optim.lr_scheduler.StepLR`` stepped once per update)."""
    def schedule(count):
        return base_lr * (gamma ** (count // step_size))

    return schedule


def from_config(cfg: Mapping[str, Any]) -> GradientTransformation:
    """An optimizer from a ``train_params`` dict (``optimizer`` or
    ``optimizer_type``; ``learning_rate`` or ``lr``)."""
    name = cfg.get("optimizer", cfg.get("optimizer_type", "adam"))
    lr = cfg.get("learning_rate", cfg.get("lr", 1e-3))
    return make_optimizer(
        name,
        lr,
        momentum=cfg.get("momentum", 0.0),
        weight_decay=cfg.get("weight_decay", 0.0),
        grad_clip_norm=cfg.get("grad_clip_norm"),
    )
