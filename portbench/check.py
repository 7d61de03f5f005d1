"""The numbers that decide ``correct``, each held against its limit.

Serving: the widest gap by which a served code scores below the
reference's best, over a sample of the clips the window completed.

Training: for the first steps, run alike by the program and by the plain
reference from the same weights on the same windows,

- ``batch_mismatch``: codes of the fed batches that differ from the
  windows the reference cuts from the corpus itself (exact: limit 0);
- ``loss_gap``: the worst step's loss gap, over the reference's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient, over the larger of the reference's norm of that leaf and of
  the median leaf;
- ``change_gap``: the same of the parameters' change over the steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone under Adam).
"""

from __future__ import annotations

import statistics

import torch


def _norms(tree: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_gap(prog: dict, ref: dict, leaves: list[str]) -> float:
    """The worst of ``leaves``' norm gaps, each over the larger of its
    reference norm and the median leaf's."""
    p, r = _norms(prog), _norms(ref)
    med = statistics.median(r[k] for k in leaves)
    return max(abs(p[k] - r[k]) / max(r[k], med) for k in leaves)


def train_numbers(losses_p, losses_r, grads_p, grads_r, params0, params_p, params_r) -> dict:
    g = _norms(grads_r)
    med = statistics.median(g.values())
    moved = [k for k in g if g[k] >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r)),
        "grad_gap": leaf_gap(grads_p, grads_r, list(g)),
        "change_gap": leaf_gap({k: params_p[k] - params0[k] for k in moved},
                               {k: params_r[k] - params0[k] for k in moved}, moved),
    }


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every number at or under its limit."""
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
