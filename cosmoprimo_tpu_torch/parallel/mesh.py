"""The (dp, tp) mesh of the world's ranks and the placement helpers
(cosmoprimo_tpu/parallel/mesh.py).

A JAX mesh lays devices out and XLA inserts the collectives; here each
rank is one process with one device, holds plain local tensors, and the
code that runs on a mesh calls its collectives explicitly, through the
sub-groups of each axis (:meth:`Mesh.group`). Only ``all_reduce`` and
``broadcast`` are used on device tensors: NCCL has both, and gloo has them
for CUDA tensors too, so the same code runs where ranks share a card."""

import math

import numpy as np
import torch

from .distributed import object_group, rank_device, split_ranks, world


def mesh_shape(n, axis_names=('dp', 'tp')):
    """The JAX package's factorisation of ``n`` ranks: 'tp' the largest
    power of two <= sqrt(n) that divides n, 'dp' the rest (one axis: all
    n); further axes 1."""
    if len(axis_names) == 1:
        return (n,)
    tp = 1
    while tp * 2 <= max(1, int(math.isqrt(n))) and n % (tp * 2) == 0:
        tp *= 2
    return (n // tp, tp) + (1,) * (len(axis_names) - 2)


class Mesh(object):
    """This rank's view of the mesh: ``shape`` (axis name -> size, as a JAX
    mesh's), ``ranks`` (the world's ranks laid out in the mesh's shape), this
    rank's ``coords`` (axis name -> coordinate), its ``device``, and per
    axis the group of the ranks that differ from this one along that axis
    only (None where the axis has one rank)."""

    def __init__(self, axis_names, shape, rank, device, groups=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.ranks = np.arange(int(np.prod(shape))).reshape(shape)
        self.rank = rank
        self.coords = dict(zip(self.axis_names, (int(c[0]) for c in np.nonzero(self.ranks == rank))))
        self.device = torch.device(device)
        self._groups = dict(groups or {})

    @property
    def size(self):
        return self.ranks.size

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def coordinate(self, axis):
        return self.coords.get(axis, 0)

    def group(self, axis):
        """The process group along ``axis`` through this rank, None if the
        axis has one rank (or is not in the mesh)."""
        return self._groups.get(axis)


def make_mesh(devices=None, axis_names=('dp', 'tp'), shape=None):
    """The mesh over the world's ranks (one rank, without a process group).

    ``shape`` defaults to :func:`mesh_shape` of the world size. Each rank's
    device is cuda:(rank mod the number of cards) unless ``devices`` says
    otherwise: one device (e.g. 'cpu') for every rank, or a list with one
    per rank. Every rank must call it together: the axis groups are made
    collectively."""
    rank, size = world()
    shape = tuple(shape) if shape is not None else mesh_shape(size, axis_names)
    if int(np.prod(shape)) != size or len(shape) != len(axis_names):
        raise ValueError(f'a mesh of shape {shape} over axes {axis_names} does not hold the {size} ranks')
    if devices is None:
        device = rank_device(rank)
    elif isinstance(devices, (list, tuple)):
        if len(devices) != size:
            raise ValueError(f'{len(devices)} devices given for {size} ranks')
        device = devices[rank]
    else:
        device = devices
    ranks = np.arange(size).reshape(shape)
    groups = {}
    if size > 1:
        import torch.distributed as dist
        for iaxis, axis in enumerate(axis_names):
            if shape[iaxis] == 1:
                continue
            lines = np.moveaxis(ranks, iaxis, -1).reshape(-1, shape[iaxis])
            for line in lines:   # every rank makes every group, in the same order
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[axis] = group
    return Mesh(axis_names, shape, rank, device, groups=groups)


class BatchSharding(object):
    """Where :func:`shard_array` puts an array: its leading axis split in
    contiguous blocks over the mesh ``axis`` (the JAX package's
    ``PartitionSpec(axis, None, ...)``), the other axes whole."""

    def __init__(self, mesh, axis='dp', ndim=1):
        self.mesh, self.axis, self.ndim = mesh, axis, ndim
        self.spec = (axis,) + (None,) * (ndim - 1)

    def indices(self, n):
        """The rows of ``n`` that this rank holds."""
        return split_ranks(n, self.mesh.coordinate(self.axis), self.mesh.axis_size(self.axis))

    def block(self, n):
        index = self.indices(n)
        return slice(index[0], index[-1] + 1) if index else slice(0, 0)


def batch_sharding(mesh, axis='dp', ndim=1):
    """The placement of an array of ``ndim`` axes whose leading axis is split
    over the mesh ``axis``."""
    return BatchSharding(mesh, axis=axis, ndim=ndim)


def shard_array(array, mesh, axis='dp'):
    """This rank's contiguous block of ``array``'s leading axis (numpy or a
    tensor, the block of :func:`split_ranks` at this rank's ``axis``
    coordinate), as a tensor on the rank's device. The blocks in rank order
    give the array back (:func:`gather_array`)."""
    sharding = batch_sharding(mesh, axis=axis, ndim=np.ndim(array))
    block = array[sharding.block(len(array))]
    return torch.as_tensor(block.copy() if isinstance(block, np.ndarray) else block).to(mesh.device)


def gather_array(local, mesh, axis='dp'):
    """The array whose blocks the ranks along ``axis`` hold (the inverse of
    :func:`shard_array`), on every one of them: each block put in place in
    zeros and summed with ``all_reduce``."""
    group = mesh.group(axis)
    if group is None:
        return local
    import torch.distributed as dist
    nrank, coord = mesh.axis_size(axis), mesh.coordinate(axis)
    counts = torch.zeros(nrank, dtype=torch.int64, device=local.device)
    counts[coord] = local.shape[0]
    dist.all_reduce(counts, group=group)
    counts = counts.tolist()
    start = sum(counts[:coord])
    full = local.new_zeros((sum(counts),) + tuple(local.shape[1:]))
    full[start:start + local.shape[0]] = local
    dist.all_reduce(full, group=group)
    return full


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((key, _tree_map(fn, value)) for key, value in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, value) for value in tree)
    return fn(tree)


def replicate(tree, mesh):
    """Rank 0's pytree (nested dicts, lists and tuples of arrays or tensors)
    on every rank, as tensors on each rank's device: pickled over the CPU
    group from rank 0 (the other ranks may pass None)."""
    def to_host(leaf):
        return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf

    if mesh.size > 1:
        import torch.distributed as dist
        box = [_tree_map(to_host, tree) if mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=object_group())
        tree = box[0]

    def to_device(leaf):
        if isinstance(leaf, (np.ndarray, torch.Tensor, float, int, np.generic)):
            leaf = torch.as_tensor(np.array(leaf) if not isinstance(leaf, torch.Tensor) else leaf)
            return leaf.to(mesh.device)
        return leaf

    return _tree_map(to_device, tree)
