"""The port's multi-process communicator (cosmoprimo_tpu_torch/parallel/
distributed.py) in real worlds: 2 (and, marked slow, 3) localhost processes
join one gloo process group on the CPU and run this file as a script
(``python test_torch_distributed_multiprocess.py PORT NPROC RANK OUTDIR``),
each within a 120 s timeout.

Each rank drives every collective and the point-to-point of
tests/distributed_worker.py through ``get_comm()``, which must be the
torch communicator: bcast of a ragged object, allgather of objects of
different sizes, scatter from a non-zero root, gather onto the root only,
the sums, send/recv (the destination gets the value, a bystander None, a
tag mismatch raises naming both tags), barrier, and the seed helpers.
Then a QMC fan-out through the real communicator, with per-rank
checkpoints: the gathered samples must equal the JAX package's
single-process samples exactly. The 3-process world adds the bystander
and uneven blocks (12 points over 3 ranks)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

TIMEOUT = 120


def calculator(a, b):
    import torch
    return {'y': torch.stack([a + 2 * b, a * b], dim=-1)}


def worker(port, nproc, rank, outdir):
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}', world_size=nproc, rank=rank)
    try:
        run_worker(nproc, rank, outdir)
    finally:
        dist.destroy_process_group()


def run_worker(nproc, rank, outdir):
    from cosmoprimo_tpu_torch.parallel.distributed import (TorchDistributedComm, bcast_seed, get_comm,
                                                           set_common_seed, set_independent_seed)
    comm = get_comm()
    assert isinstance(comm, TorchDistributedComm), type(comm)
    assert comm.Get_size() == nproc and comm.Get_rank() == rank

    # bcast of a ragged object (the other ranks give None)
    payload = {'arr': np.arange(7.0), 'tag': 'hello', 'n': 42} if rank == 0 else None
    got = comm.bcast(payload, root=0)
    assert got['tag'] == 'hello' and np.array_equal(got['arr'], np.arange(7.0)) and got['n'] == 42
    # allgather of objects of different pickled sizes
    got = comm.allgather(np.arange(rank + 1) * 1.0)
    assert len(got) == nproc and all(np.array_equal(got[r], np.arange(r + 1) * 1.0) for r in range(nproc))
    # scatter from a non-zero root
    values = [{'r': r, 'x': np.full(r + 2, float(r))} for r in range(nproc)] if rank == 1 else None
    mine = comm.scatter(values, root=1)
    assert mine['r'] == rank and np.array_equal(mine['x'], np.full(rank + 2, float(rank)))
    # gather lands on the root only
    g = comm.gather(rank * 10, root=0)
    assert g == ([r * 10 for r in range(nproc)] if rank == 0 else None)
    # the sums
    assert comm.allreduce_sum(rank + 1) == nproc * (nproc + 1) // 2
    red = comm.reduce_sum(np.array([rank + 1.0]), root=1)
    if rank == 1:
        assert np.array_equal(red, [nproc * (nproc + 1) / 2])
    else:
        assert red is None
    # point-to-point rank 1 -> rank 0: every rank takes part, bystanders get None
    if rank == 1:
        comm.send({'data': np.array([3.14])}, dest=0, tag=3)
    else:
        pkt = comm.recv(source=1, tag=3)
        assert np.array_equal(pkt['data'], [3.14]) if rank == 0 else pkt is None
    # a tag mismatch raises on the destination, naming both tags
    if rank == 1:
        comm.send('x', dest=0, tag=5)
    else:
        try:
            pkt = comm.recv(source=1, tag=6)
        except RuntimeError as exc:
            assert rank == 0 and 'tag 5' in str(exc) and 'tag 6' in str(exc), exc
        else:
            assert rank != 0 and pkt is None
    comm.barrier()

    # the seed helpers
    seeds = bcast_seed(seed=11, comm=comm, size=100)
    assert len(seeds) == 100
    assert all(np.array_equal(s, seeds) for s in comm.allgather(np.asarray(seeds)))
    set_common_seed(seed=7, comm=comm)
    draws = comm.allgather(np.random.random())
    assert all(d == draws[0] for d in draws)
    set_independent_seed(seed=7, comm=comm)
    draws = comm.allgather(np.random.random())
    assert len(set(draws)) == nproc

    # the QMC fan-out: each rank's block, gathered on rank 0, with checkpoints
    from cosmoprimo_tpu_torch.emulators.samples import QMCSampler
    sampler = QMCSampler(calculator, {'a': [0.0, 1.0], 'b': [2.0, 3.0]}, comm=comm, device='cpu',
                         chunk_size=2, save_every=2, save_fn=os.path.join(outdir, 'samples.npy'))
    samples = sampler.run(niterations=12)
    assert os.path.exists(os.path.join(outdir, f'samples.rank{rank}.npy'))
    if rank == 0:
        np.save(os.path.join(outdir, 'gathered.npy'),
                {'a': samples['X.a'], 'b': samples['X.b'], 'y': samples['Y.y']}, allow_pickle=True)
    else:
        assert samples is None
    with open(os.path.join(outdir, f'ok.{rank}'), 'w') as f:
        f.write('ok')


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run_world(script, nproc, tmp_path, *args, timeout=TIMEOUT):
    """Run ``script`` as ``nproc`` ranks of one world (PORT NPROC RANK
    OUTDIR args...); fail with the output of any rank that fails."""
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, 'PYTHONPATH': repo + os.pathsep + os.environ.get('PYTHONPATH', ''), 'OMP_NUM_THREADS': '1'}
    procs = [subprocess.Popen([sys.executable, script, str(port), str(nproc), str(rank), str(tmp_path), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
             for rank in range(nproc)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{out[-3000:]}'
        assert os.path.exists(tmp_path / f'ok.{rank}'), f'rank {rank} wrote no ok file:\n{out[-3000:]}'
    return outputs


def jax_single_process():
    """The same QMC points through the JAX package's sampler, one process."""
    from cosmoprimo_tpu.emulators.samples import QMCSampler

    def jcalculator(a=0.0, b=0.0):
        return {'y': np.array([a + 2 * b, a * b])}

    samples = QMCSampler(jcalculator, {'a': [0.0, 1.0], 'b': [2.0, 3.0]}).run(niterations=12)
    return {'a': np.asarray(samples['X.a']), 'b': np.asarray(samples['X.b']), 'y': np.asarray(samples['Y.y'])}


def check_world(nproc, tmp_path):
    pytest.importorskip('jax')
    run_world(__file__, nproc, tmp_path)
    gathered = np.load(tmp_path / 'gathered.npy', allow_pickle=True).item()
    ref = jax_single_process()
    for name in ('a', 'b', 'y'):
        np.testing.assert_array_equal(gathered[name], ref[name])


def test_two_process_comm(tmp_path):
    check_world(2, tmp_path)


@pytest.mark.slow
def test_three_process_comm(tmp_path):
    check_world(3, tmp_path)


if __name__ == '__main__':
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
