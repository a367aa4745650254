"""Multi-GPU rendering and training on ``torch.distributed`` (port of
``gpcr_tpu/parallel/``): ``distributed`` starts the process group,
``sharding`` holds the ('dp', 'sp') mesh and the batch shardings,
``render`` renders views or tiles across ranks, ``dryrun`` checks all of it
in a world of CPU processes."""

from .sharding import Mesh, batch_sharding, make_mesh, replicate, shard_batch
