"""The port's parallel surface (cosmoprimo_tpu_torch/parallel/) in one
process, against cosmoprimo_tpu.parallel on the virtual 8-device CPU mesh
that tests/conftest.py sets:

- the mesh factorisation for n = 1, 2, 3, 4, 6, 8 ranks equals JAX
  ``make_mesh(jax.devices()[:n]).shape``, for two axes and one;
- ``split_ranks`` and ``FakeComm`` behave as the JAX package's;
- the seed helpers draw the same numbers as JAX's (exact);
- ``TorchDistributedComm`` of one rank (no process group, and a one-rank
  gloo group): collectives copy their values, and its point-to-point
  mailbox keeps tags apart, with None from an empty recv, as
  ``JaxDistributedComm``'s;
- ``get_comm`` gives ``FakeComm`` with no process group or one of one rank;
- ``make_mesh``, ``shard_array``, ``gather_array``, ``replicate`` and
  ``batch_sharding`` on one rank: the whole array, on the device asked for.

The multi-process worlds are in test_torch_distributed_multiprocess.py and
test_torch_sharded.py. Bars: exact equality throughout.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from cosmoprimo_tpu import parallel as jparallel  # noqa: E402
from cosmoprimo_tpu.parallel import distributed as jdistributed  # noqa: E402
from cosmoprimo_tpu_torch import parallel  # noqa: E402
from cosmoprimo_tpu_torch.parallel import distributed  # noqa: E402


@pytest.mark.parametrize('n', [1, 2, 3, 4, 6, 8])
def test_factorisation_against_jax(n):
    if len(jax.devices()) < n:
        pytest.skip(f'{len(jax.devices())} JAX devices')
    jmesh = jparallel.make_mesh(jax.devices()[:n])
    assert parallel.mesh_shape(n) == tuple(jmesh.devices.shape)
    assert dict(zip(('dp', 'tp'), parallel.mesh_shape(n))) == dict(jmesh.shape)
    jmesh1 = jparallel.make_mesh(jax.devices()[:n], axis_names=('dp',))
    assert parallel.mesh_shape(n, axis_names=('dp',)) == tuple(jmesh1.devices.shape)


@pytest.mark.parametrize('nitems,size', [(10, 3), (12, 4), (5, 8), (0, 2)])
def test_split_ranks(nitems, size):
    owned = [parallel.split_ranks(nitems, rank, size) for rank in range(size)]
    assert owned == [jparallel.split_ranks(nitems, rank, size) for rank in range(size)]
    assert [i for part in owned for i in part] == list(range(nitems))


def test_fake_comm():
    comm = parallel.FakeComm()
    assert comm.Get_size() == 1 and comm.Get_rank() == 0
    assert comm.bcast(42) == 42 and comm.gather('x') == ['x'] and comm.allgather(3) == [3]
    assert comm.scatter([7]) == 7 and comm.allreduce_sum(5) == 5 and comm.reduce_sum(5) == 5
    comm.send({'a': 1}, dest=0, tag=3)
    comm.send('second', dest=0, tag=3)
    assert comm.recv(source=0, tag=3) == {'a': 1} and comm.recv(source=0, tag=3) == 'second'
    assert isinstance(parallel.get_comm(), parallel.FakeComm)


def test_seed_helpers_against_jax():
    jcomm, comm = jdistributed.FakeComm(), parallel.FakeComm()
    np.testing.assert_array_equal(parallel.bcast_seed(seed=11, comm=comm, size=16),
                                  jparallel.bcast_seed(seed=11, comm=jcomm, size=16))
    for fn, jfn in ((parallel.set_common_seed, jparallel.set_common_seed),
                    (parallel.set_independent_seed, jparallel.set_independent_seed)):
        seed = fn(seed=7, comm=comm)
        draw = np.random.random(5)
        jseed = jfn(seed=7, comm=jcomm)
        jdraw = np.random.random(5)
        assert seed == jseed
        np.testing.assert_array_equal(draw, jdraw)


def one_rank_comm_checks(comm, jcomm):
    obj = {'params': np.arange(5.0), 'name': 'desi', 'none': None}
    out = comm.bcast(obj, root=0)
    assert out is not obj
    np.testing.assert_array_equal(out['params'], obj['params'])
    assert out['name'] == 'desi' and out['none'] is None
    assert comm.scatter([obj], root=0)['name'] == jcomm.scatter([obj], root=0)['name']
    assert comm.allgather(('tuple', 3)) == jcomm.allgather(('tuple', 3)) == [('tuple', 3)]
    assert comm.gather(4) == [4]
    assert comm.reduce_sum(2.5, root=0) == jcomm.reduce_sum(2.5, root=0) == 2.5
    comm.barrier()
    for c in (comm, jcomm):
        c.send({'x': 1}, dest=0, tag=7)
        c.send('second', dest=0, tag=7)
    for c in (comm, jcomm):
        assert c.recv(source=0, tag=7) == {'x': 1}
        assert c.recv(source=0, tag=7) == 'second'
        assert c.recv(source=0, tag=7) is None
        assert c.recv(source=0, tag=3) is None


def test_one_rank_comm_mailbox():
    """No process group: rank 0 of 1, as JaxDistributedComm without
    jax.distributed."""
    comm = parallel.TorchDistributedComm()
    assert comm.Get_size() == 1 and comm.Get_rank() == 0
    one_rank_comm_checks(comm, jdistributed.JaxDistributedComm())


def test_one_rank_world(tmp_path):
    """A gloo process group of one rank: the same as without one; get_comm
    stays the serial fallback; the mesh is (1, 1) on the device asked for."""
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/store', world_size=1, rank=0)
    try:
        assert isinstance(parallel.get_comm(), parallel.FakeComm)
        comm = parallel.TorchDistributedComm()
        assert comm.Get_size() == 1
        one_rank_comm_checks(comm, jdistributed.JaxDistributedComm())
        mesh = parallel.make_mesh(devices='cpu')
        assert mesh.shape == {'dp': 1, 'tp': 1} and mesh.coords == {'dp': 0, 'tp': 0}
        assert mesh.group('dp') is None and mesh.group('tp') is None
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_placement():
    mesh = parallel.make_mesh(devices='cpu')
    assert mesh.size == 1 and mesh.device == torch.device('cpu')
    x = np.arange(12.0).reshape(4, 3)
    local = parallel.shard_array(x, mesh)
    assert isinstance(local, torch.Tensor) and local.device == mesh.device
    np.testing.assert_array_equal(local.numpy(), x)
    np.testing.assert_array_equal(parallel.gather_array(local, mesh).numpy(), x)
    sharding = parallel.batch_sharding(mesh, ndim=2)
    assert sharding.spec == ('dp', None) and sharding.indices(4) == [0, 1, 2, 3]
    tree = {'a': np.arange(6.0), 'b': (np.ones((2, 2)), [torch.zeros(3)]), 'name': 'x'}
    rep = parallel.replicate(tree, mesh)
    assert rep['name'] == 'x' and isinstance(rep['b'], tuple) and isinstance(rep['b'][1], list)
    np.testing.assert_array_equal(rep['a'].numpy(), tree['a'])
    assert rep['b'][0].device == mesh.device and float(rep['b'][0].sum()) == 4.0
    with pytest.raises(ValueError):
        parallel.make_mesh(devices='cpu', shape=(2, 1))


def test_rank_device_needs_a_card():
    if torch.cuda.is_available():
        assert distributed.rank_device(0).type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            distributed.rank_device(0)
