"""Process-parallel communication (cosmoprimo_tpu/parallel/distributed.py),
its single-rank part: :class:`FakeComm`, which runs everything serially in
one process with the subset of the MPI interface the emulators use,
:func:`get_comm` and :func:`split_ranks`."""


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


def get_comm():
    """The communicator: the serial fallback (the multi-process one is not
    ported yet)."""
    return FakeComm()


def split_ranks(nitems, rank, size):
    """Indices of the items this rank owns (block distribution)."""
    return list(range(rank * nitems // size, (rank + 1) * nitems // size))
