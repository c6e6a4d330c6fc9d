"""Process-level parallelism of the port (cosmoprimo_tpu/parallel/): the
communicators, the (dp, tp) mesh of the world's ranks over
``torch.distributed``, and the placement and seed helpers."""

from .distributed import (FakeComm, TorchDistributedComm, bcast_seed, get_comm, rank_device, set_common_seed,
                          set_independent_seed, split_ranks)
from .mesh import Mesh, batch_sharding, gather_array, make_mesh, mesh_shape, replicate, shard_array
