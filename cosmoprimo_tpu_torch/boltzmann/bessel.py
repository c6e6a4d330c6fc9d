"""Spherical Bessel function tables for the CMB line-of-sight projection
(cosmoprimo_tpu/boltzmann/bessel.py).

j_l(x) and j_l'(x) do not depend on the cosmology: only on the multipoles
and the argument range x = k (tau0 - tau) <= k_max tau0. They are made once
on the host (scipy's jv(l + 1/2, x)), cached on disk in this package's own
``_cache/`` directory (or ``COSMOPRIMO_TORCH_BESSEL_CACHE``) and in memory
for the process, and copied to each device once. On the device the
projection evaluates them by cubic Hermite interpolation on the uniform
x-grid (boltzmann/harmonic.py).
"""

import functools
import hashlib
import os

import numpy as np
import torch

_CACHE_DIR = os.environ.get('COSMOPRIMO_TORCH_BESSEL_CACHE',
                            os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), '_cache'))

DX = 0.125  # uniform x-grid spacing (cubic-Hermite relative error ~ dx^4/384)


def default_ells(lmax, dense_until=48, step_frac=0.085, step_max=72):
    """Multipole sample: every integer l <= ``dense_until``, then geometric
    ~8.5% steps capped at ``step_max`` (the acoustic oscillation's period
    in l is ~300, so an uncapped geometric grid would undersample it)."""
    ells = list(range(2, min(dense_until, lmax) + 1))
    ell = float(dense_until)
    while ell < lmax:
        ell = ell + min(max(4.0, ell * step_frac), float(step_max))
        ells.append(int(min(round(ell), lmax)))
    return np.unique(np.asarray(ells, dtype=np.int32))


def bessel_tables(ells, x_max, dx=DX):
    """(x_grid, j, jp) tables: ``j`` and ``jp`` of shape (n_ell, n_x),
    float64, on ``x_grid = arange(n_x) dx`` up to x_max + 4 dx. Host numpy,
    cached on disk and in memory."""
    ells = np.asarray(ells, dtype=np.int64)
    n_x = int(np.floor((x_max + 4 * dx) / dx)) + 1
    return _tables(tuple(ells.tolist()), n_x, float(dx))


@functools.lru_cache(maxsize=4)
def _tables(ells, n_x, dx):
    from scipy.special import jv

    key = hashlib.sha1(repr((list(ells), n_x, dx)).encode()).hexdigest()[:16]
    path = os.path.join(_CACHE_DIR, f'bessel_{key}.npz')
    if os.path.exists(path):
        with np.load(path) as f:
            return f['x'], f['j'], f['jp']
    x = np.arange(n_x, dtype=np.float64) * dx
    z = x[1:]
    pref = np.sqrt(np.pi / (2.0 * z))
    j = np.zeros((len(ells), n_x))
    jp = np.zeros((len(ells), n_x))
    for i, ell in enumerate(ells):
        with np.errstate(under='ignore'):
            jl = pref * jv(ell + 0.5, z)
            jlm1 = pref * jv(ell - 0.5, z)
        j[i, 1:] = jl
        # j_l'(x) = j_{l-1}(x) - (l+1)/x j_l(x)
        jp[i, 1:] = jlm1 - (ell + 1.0) / z * jl
        if ell == 1:
            jp[i, 0] = 1.0 / 3.0
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tmp = path[:-4] + f'.tmp{os.getpid()}.npz'
    np.savez(tmp, x=x, j=j, jp=jp)
    os.replace(tmp, path)
    return x, j, jp


_device_tables = {}


def device_tables(tables, device):
    """The tables ``(x_grid, j, jp)`` as float64 tensors on ``device``,
    copied there once per process."""
    key = (id(tables[1]), str(device))
    if key not in _device_tables:
        while len(_device_tables) >= 4:       # as many as the host cache holds
            _device_tables.pop(next(iter(_device_tables)))
        _device_tables[key] = (tables, tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device) for t in tables))
    return _device_tables[key][1]
