"""Device-mesh construction, sharding rules, sequence-parallel halo
exchange and the GAN families' split discriminators (``gan_tp``,
``rnn_tp``) over ``torch.distributed``, one process per device
(counterpart of :mod:`music_tpu.parallel`)."""

from music_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    make_mesh,
    batch_sharding,
    replicated,
    shard_batch,
)
