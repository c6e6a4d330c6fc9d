"""Process-parallel communication (cosmoprimo_tpu/parallel/distributed.py):
:class:`TorchDistributedComm`, the multi-process communicator over
``torch.distributed``; :class:`FakeComm`, which runs everything serially in
one process; :func:`get_comm`, which chooses between them; the block
distribution :func:`split_ranks`; and the seed helpers.

The caller initialises the process group (``torch.distributed.
init_process_group``, or ``torchrun``), as the JAX package's callers call
``jax.distributed.initialize``. Object collectives go through a CPU (gloo)
group: the default group when its backend is gloo, else a gloo group over
all ranks made once, so the same calls work under NCCL."""

import pickle

import numpy as np
import torch


class FakeComm(object):
    """Single-process stand-in with the subset of the MPI interface used by
    the samplers: rank/size, bcast, (all)gather, scatter, barrier."""

    rank = 0
    size = 1

    def Get_rank(self):
        return self.rank

    def Get_size(self):
        return self.size

    def bcast(self, value, root=0):
        return value

    def gather(self, value, root=0):
        return [value]

    def allgather(self, value):
        return [value]

    def scatter(self, values, root=0):
        if values is None:
            return None
        if len(values) != 1:
            raise ValueError(f'a single rank scatters one value, got {len(values)}')
        return values[0]

    def barrier(self):
        pass

    barrier_idle = barrier

    def reduce_sum(self, value, root=0):
        return value

    def allreduce_sum(self, value):
        return value

    def send(self, value, dest=0, tag=0):
        """Point-to-point send: with one rank, queued locally so that a
        matching :meth:`recv` returns it."""
        if dest != 0:
            raise ValueError(f'a single rank sends to rank 0, not {dest}')
        self._queue = getattr(self, '_queue', {})
        self._queue.setdefault(tag, []).append(value)

    def recv(self, source=0, tag=0):
        if source != 0:
            raise ValueError(f'a single rank receives from rank 0, not {source}')
        return self._queue[tag].pop(0)


def _dist():
    import torch.distributed as dist
    return dist


def world():
    """(rank, size) of the initialised process group, (0, 1) without one."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


_object_groups = []   # [(default group, its gloo group)], one entry a world


def object_group():
    """The CPU group of the object collectives: None (the default group)
    when the default backend is gloo, else a gloo group over all ranks,
    made once per world. Every rank must make its first call together."""
    dist = _dist()
    if dist.get_backend() == 'gloo':
        return None
    for default, group in _object_groups:
        if default is dist.group.WORLD:
            return group
    group = dist.new_group(backend='gloo')
    _object_groups[:] = [(dist.group.WORLD, group)]
    return group


class TorchDistributedComm(object):
    """Multi-process communicator over the initialised ``torch.
    distributed`` process group; each process is one rank.

    The object collectives (bcast, allgather, gather, scatter, the sums,
    barrier) are torch's pickled-object collectives over the CPU group of
    :func:`object_group`. Point-to-point ``send``/``recv`` ride on the
    broadcast, as in the JAX package: every rank takes part (the source
    calls send, every other rank recv with the matching source), the
    destination gets the value, a bystander gets None, and a destination
    whose tag differs from the sender's raises. With one rank, values are
    copied through pickle and send/recv use a local mailbox whose empty
    recv gives None."""

    def __init__(self):
        self.rank, self.size = world()
        self._group = object_group() if self.size > 1 else None
        self._mailbox = {}   # size-1 local p2p queue (tag -> values)

    def Get_rank(self):
        return self.rank

    def Get_size(self):
        return self.size

    def bcast(self, value, root=0):
        if self.size == 1:
            return pickle.loads(pickle.dumps(value))
        box = [value if self.rank == root else None]
        _dist().broadcast_object_list(box, src=root, group=self._group)
        return box[0]

    def allgather(self, value):
        if self.size == 1:
            return [pickle.loads(pickle.dumps(value))]
        out = [None] * self.size
        _dist().all_gather_object(out, value, group=self._group)
        return out

    def gather(self, value, root=0):
        if self.size == 1:
            return [pickle.loads(pickle.dumps(value))]
        out = [None] * self.size if self.rank == root else None
        _dist().gather_object(value, out, dst=root, group=self._group)
        return out

    def scatter(self, values, root=0):
        if self.size == 1:
            return pickle.loads(pickle.dumps(values[0]))
        out = [None]
        _dist().scatter_object_list(out, list(values) if self.rank == root else None, src=root, group=self._group)
        return out[0]

    def send(self, value, dest=0, tag=0):
        if self.size == 1:
            self._mailbox.setdefault(tag, []).append(value)
            return
        self.bcast((dest, tag, value), root=self.rank)

    def recv(self, source=0, tag=0):
        if self.size == 1:
            box = self._mailbox.get(tag)
            return box.pop(0) if box else None
        packet = self.bcast(None, root=source)
        if packet is None:   # the source broadcast nothing (no paired send)
            return None
        dest, sent_tag, value = packet
        if dest != self.rank:
            return None   # a bystander taking part in the collective
        if sent_tag != tag:
            raise RuntimeError(
                f'mismatched point-to-point pairing: rank {source} sent to rank {dest} '
                f'with tag {sent_tag}, but rank {self.rank} expected tag {tag}')
        return value

    def barrier(self):
        if self.size > 1:
            _dist().barrier(group=self._group)

    barrier_idle = barrier

    def allreduce_sum(self, value):
        return sum(self.allgather(value))

    def reduce_sum(self, value, root=0):
        total = self.allreduce_sum(value)
        return total if self.rank == root else None


def get_comm():
    """The communicator: :class:`TorchDistributedComm` when a process
    group of more than one rank is initialised, else :class:`FakeComm`."""
    if world()[1] > 1:
        return TorchDistributedComm()
    return FakeComm()


def rank_device(rank=None):
    """The card of ``rank`` (this process's by default): cuda:(rank mod the
    number of cards), so that ranks on one host share its cards in turn.
    Without a card, raise: a rank never falls back to the CPU silently."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by default; pass device='cpu' to run on "
                           'the CPU')
    rank = world()[0] if rank is None else rank
    return torch.device('cuda', rank % torch.cuda.device_count())


def split_ranks(nitems, rank, size):
    """Indices of the items this rank owns (block distribution)."""
    return list(range(rank * nitems // size, (rank + 1) * nitems // size))


def bcast_seed(seed=None, comm=None, size=None):
    """Seed array broadcast from rank 0: every process gets the same pool to
    draw per-task seeds from."""
    comm = comm if comm is not None else get_comm()
    if comm.Get_rank() == 0:
        seeds = np.random.RandomState(seed).randint(0, high=0xFFFF, size=size)
    else:
        seeds = None
    return comm.bcast(seeds, root=0)


def set_common_seed(seed=None, comm=None):
    """Seed numpy identically on all processes."""
    comm = comm if comm is not None else get_comm()
    seed = comm.bcast(int(np.random.RandomState(seed).randint(0, high=0xFFFFFFFF))
                      if comm.Get_rank() == 0 else None, root=0)
    np.random.seed(seed)
    return seed


def set_independent_seed(seed=None, comm=None, size=10000):
    """Seed numpy differently (but reproducibly) per process."""
    comm = comm if comm is not None else get_comm()
    seed = bcast_seed(seed=seed, comm=comm, size=size)[comm.Get_rank() % size]
    np.random.seed(seed)
    return seed
