"""Process-level parallelism of the port (cosmoprimo_tpu/parallel/): the
single-rank communicator that the emulators use. The torch.distributed
communicator and the device mesh are not ported yet (ROADMAP slice 6c)."""

from .distributed import FakeComm, get_comm, split_ranks
