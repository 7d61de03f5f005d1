"""Device-mesh construction, sharding rules, and sequence-parallel halo
exchange over ``torch.distributed``, one process per device (counterpart
of :mod:`music_tpu.parallel`)."""

from music_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    make_mesh,
    batch_sharding,
    replicated,
    shard_batch,
)
