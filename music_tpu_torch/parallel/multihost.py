"""Multi-process distribution (counterpart of
:mod:`music_tpu.parallel.multihost`).

JAX joins each process (a host holding several chips) to a
``jax.distributed`` cluster.  In the port a process drives one device, so
a cluster of N devices is N processes in one ``torch.distributed`` process
group, each feeding only its own rows of every batch:

    multihost.initialize(coordinator, num_processes, process_id)  # no-op alone
    mesh = make_mesh(MeshSpec(data=-1))               # over every rank
    tokens = multihost.put_global_batch(mesh, batch)  # this rank's rows only
    state, loss = train_step(state, tokens)           # gradients all-reduce

Nothing tells a process of a cluster: the caller passes the coordinator's
``host:port`` (a TCP store, served by process 0), the world size and the
rank.  The backend is an explicit choice, never a fallback: NCCL on CUDA
by default, gloo on the CPU or when asked for (``backend="gloo"``, which
also takes CUDA tensors).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from music_tpu_torch.parallel.mesh import Mesh, block, shard_batch


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Join (or create) the process group of ``num_processes`` ranks whose
    rank 0 serves the TCP store at ``coordinator`` (``host:port``), as rank
    ``process_id``.  Idempotent, and a no-op when all three are None (one
    process).  ``device``: ``"cuda"`` (this rank then uses ``cuda:<rank
    modulo the host's cards>``; raises without a card) or ``"cpu"``;
    ``backend``: ``"nccl"`` (the default on CUDA) or ``"gloo"`` (the
    default on the CPU)."""
    if dist.is_initialized():
        return
    if coordinator is None and num_processes is None and process_id is None:
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("multi-process training needs coordinator, num_processes and "
                         "process_id")
    from music_tpu_torch.generate.wavenet_generate import resolve_device

    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    kw = {}
    if device.type == "cuda":
        local = torch.device("cuda", int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(local)
        if backend == "nccl":
            kw["device_id"] = local  # NCCL's communicator bound to this rank's card
    address = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=address, world_size=int(num_processes),
                            rank=int(process_id), **kw)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_shard(n: int, mesh: Mesh | None = None) -> slice:
    """This rank's contiguous slice of ``n`` global batch rows: the block of
    its data coordinate on ``mesh`` (ranks along ``seq`` and ``model`` get
    the same rows, JAX's ``P("data", None)``), else of its rank.  ``n``
    must divide evenly."""
    if mesh is None:
        return block(n, process_count(), process_index())
    return block(n, mesh.shape["data"], mesh.index("data"))


def put_global_batch(mesh: Mesh, batch: np.ndarray) -> torch.Tensor:
    """This rank's rows of a GLOBAL batch, on its device: every process
    holds the same global batch and transfers only its data block."""
    return shard_batch(mesh, batch)


def fetch_scalar(x: torch.Tensor) -> float:
    """A replicated scalar (every rank holds the same loss) as a float."""
    return float(x)
