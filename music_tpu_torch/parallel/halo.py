"""Sequence-parallel halo exchange for causal convolutions (counterpart of
:mod:`music_tpu.parallel.halo`).

Each rank along ``seq`` holds a contiguous chunk of a window; before a
causal conv stack runs, every rank receives the last ``halo`` samples of
its left neighbour, so valid convolutions over the extended chunk give
exactly the chunk's outputs of the unsharded computation.  JAX sends the
tails with ``ppermute`` and derives its transpose; here both directions
are one ``batch_isend_irecv`` each, in a ``torch.autograd.Function``:

- forward: rank ``i`` sends its tail to rank ``i + 1`` and receives rank
  ``i - 1``'s; rank 0 receives nothing (no ring) and takes
  ``first_shard_fill`` or zeros;
- backward: the reverse exchange.  Rank ``i`` sends the gradient of the
  halo it received back to rank ``i - 1``, which adds it to its tail's
  gradient; rank 0's halo gradient is ``first_shard_fill``'s.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from music_tpu_torch.parallel.mesh import Mesh


def _exchange(send: torch.Tensor | None, to: int | None, recv_like: torch.Tensor | None,
              src: int | None, group) -> torch.Tensor | None:
    """Send ``send`` to global rank ``to`` and receive a tensor like
    ``recv_like`` from ``src`` (either may be None), in one batch."""
    ops, buf = [], None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, group))
    if recv_like is not None:
        buf = torch.empty_like(recv_like)
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return buf


class _LeftHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fill, halo, time_axis, line, i, group):
        n, T = len(line), x.shape[time_axis]
        ctx.save = (halo, time_axis, line, i, group, fill is not None, T)
        tail = x.narrow(time_axis, T - halo, halo)
        recv = _exchange(tail if i < n - 1 else None, line[i + 1] if i < n - 1 else None,
                         tail if i > 0 else None, line[i - 1] if i > 0 else None, group)
        if recv is None:
            recv = fill if fill is not None else torch.zeros_like(tail)
        return torch.cat([recv.to(x.dtype), x], dim=time_axis)

    @staticmethod
    def backward(ctx, g):
        halo, time_axis, line, i, group, has_fill, T = ctx.save
        n = len(line)
        g_halo = g.narrow(time_axis, 0, halo)
        g_x = g.narrow(time_axis, halo, T).clone()
        back = _exchange(g_halo if i > 0 else None, line[i - 1] if i > 0 else None,
                         g_halo if i < n - 1 else None, line[i + 1] if i < n - 1 else None,
                         group)
        if back is not None:
            g_x.narrow(time_axis, T - halo, halo).add_(back)
        g_fill = None
        if has_fill:
            g_fill = g_halo.clone() if i == 0 else torch.zeros_like(g_halo)
        return g_x, g_fill, None, None, None, None, None


def left_halo_exchange(
    x: torch.Tensor,
    halo: int,
    mesh: Mesh,
    axis: str = "seq",
    time_axis: int = 1,
    first_shard_fill: torch.Tensor | None = None,
) -> torch.Tensor:
    """Prepend the left neighbour's trailing ``halo`` timesteps to ``x``.

    ``x``: this rank's chunk, time on ``time_axis``; ``halo``: the
    timesteps of left context needed (``receptive_field - 1`` for a causal
    conv stack); ``axis``: the mesh axis the sequence is split over.  The
    first rank along ``axis`` receives ``first_shard_fill`` (``[..., halo,
    ...]``, its real left context) or zeros.  Returns ``x`` with ``halo``
    extra leading timesteps; differentiable in ``x`` and the fill."""
    if halo > x.shape[time_axis]:
        raise ValueError(f"halo {halo} > local chunk {x.shape[time_axis]}")
    if mesh.size(axis) == 1:
        tail = x.narrow(time_axis, x.shape[time_axis] - halo, halo)
        recv = torch.zeros_like(tail) if first_shard_fill is None else first_shard_fill
        return torch.cat([recv.to(x.dtype), x], dim=time_axis)
    return _LeftHalo.apply(x, first_shard_fill, halo, time_axis, mesh.line(axis),
                           mesh.index(axis), mesh.group(axis))
