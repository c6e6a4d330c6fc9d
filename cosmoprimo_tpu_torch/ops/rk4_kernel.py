"""Phase A of the native perturbations as a hand-written CUDA kernel
(``csrc/rk4_phase_a.cu``): when it engages, the layout of its arguments,
their checks and the launch.

:func:`launch` runs every RK4 step of phase A (``deriv_full``, the
coefficients ``_coefs_a`` at each step's midpoint and end, the projections
``_project_a`` and the harvest of ``_rows_a``, as
``boltzmann/perturbations.py::_rk4_loop`` does them) in one launch, two
threads a lane (cosmology, mode), the state in shared memory. The caller,
``perturbations._rk4_a``, asks :func:`fallback_reason` first: the kernel
takes CUDA float64 tensors outside forward mode and autograd, a loop that
emits no rows, and 1 to 3 massive species (a massless row has one of mass
0); every other loop runs the PyTorch path and is counted as a fallback
with its reason.

The kernel is built with the FFTLog core into one library
(:func:`fftlog_kernel.build`, every ``.cu`` under ``csrc/``).
"""

import ctypes
import functools

import numpy as np
import torch

from .. import tracing
from . import fftlog_kernel
from .step_loop import is_dual

SPECIES = (1, 2, 3)       # the numbers of massive species the kernel is built for
STACK_ROWS = 13           # tabs['stack']: lna, ln Hc .. ln fde, w_nc, dw_nc, w_de
ROW_KEYS = ('lneta0', 'dlneta', 'K', 'wa_fld', 'cs2_fld')   # per-cosmology scalars of the tables, (B, 1)


@functools.lru_cache(maxsize=1)
def _library():
    lib = fftlog_kernel._library()
    lib.rk4_phase_a_launch.argtypes = [ctypes.c_void_p] * 4
    lib.rk4_phase_a_launch.restype = ctypes.c_int
    lib.rk4_phase_a_block.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.rk4_phase_a_block.restype = ctypes.c_int
    return lib


def block(ns):
    """(lanes, threads, bytes of shared memory) of a block of the kernel
    for ``ns`` massive species: one block runs on an SM at a time."""
    threads, shared = ctypes.c_int(0), ctypes.c_int(0)
    lanes = _library().rk4_phase_a_block(int(ns), ctypes.byref(threads), ctypes.byref(shared))
    return lanes, threads.value, shared.value


def fallback_reason(tensors, ns, emit=None):
    """Why the kernel does not take a phase-A loop over ``tensors`` (every
    tensor it reads) with ``ns`` massive species and ``emit``, or None where
    it does; the first that holds of 'emit' (a loop that emits rows every
    step), 'dual' (forward-mode AD, see ``step_loop.is_dual``), 'grad' (a
    tensor that requires grad, with grad enabled), 'device' (not all on
    CUDA), 'dtype' (not all float64) and 'species'."""
    if emit is not None:
        return 'emit'
    if any(is_dual(t) for t in tensors):
        return 'dual'
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return 'grad'
    if not all(t.is_cuda for t in tensors):
        return 'device'
    if any(t.dtype != torch.float64 for t in tensors):
        return 'dtype'
    if ns not in SPECIES:
        return 'species'
    return None


def _tensor(name, t):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{name} must be a tensor, got {type(t).__name__}')
    if t.dtype != torch.float64:
        raise TypeError(f'the phase-A kernel takes float64, got {name} of {t.dtype}')
    return t


def _shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} must be {tuple(shape)}, got {tuple(t.shape)}')


def plan(y0, eta, tabs, lanes, harvest_eta, n_state, n_rows):
    """Check the arguments of :func:`launch` and lay them out for the
    kernel: a dict with ``arrays`` (the 14 contiguous tensors in the
    kernel's order, outputs last), ``consts`` (``lanes.grid``, the momentum
    grid on the host, 30 float64), ``sizes`` (lanes, nk, B, M, n_steps, nz, ns), and the
    outputs ``y`` (N, B, nk) and ``harvest`` (nz, n_rows, B, nk), zeroed.
    Raises TypeError or ValueError on what the kernel does not take."""
    y0, eta = _tensor('y0', y0), _tensor('eta', eta)
    stack = _tensor("tabs['stack']", tabs['stack'])
    am = _tensor("tabs['am']", tabs['am'])
    if y0.dim() != 3:
        raise ValueError(f'y0 must be (n_state, B, nk), got shape {tuple(y0.shape)}')
    N, B, nk = y0.shape
    if am.dim() != 3 or am.shape[1:] != (B, 1):
        raise ValueError(f"tabs['am'] must be (ns, {B}, 1), got {tuple(am.shape)}")
    ns = am.shape[0]
    if ns not in SPECIES:
        raise ValueError(f'the phase-A kernel is built for {SPECIES} massive species, got {ns}')
    if N != n_state:
        raise ValueError(f'y0 has {N} state rows, {n_state} for {ns} massive species')
    if eta.dim() != 3 or eta.shape[1:] != (B, nk) or eta.shape[0] < 2:
        raise ValueError(f'eta must be (n_steps + 1, {B}, {nk}) with n_steps >= 1, got {tuple(eta.shape)}')
    if stack.dim() != 3 or stack.shape[:2] != (STACK_ROWS, B) or stack.shape[2] < 2:
        raise ValueError(f"tabs['stack'] must be ({STACK_ROWS}, {B}, M) with M >= 2, got {tuple(stack.shape)}")
    rows = [_tensor(f"tabs['{key}']", tabs[key]) for key in ROW_KEYS]
    for key, t in zip(ROW_KEYS, rows):
        _shape(f"tabs['{key}']", t, (B, 1))
    k, eta_rsa = _tensor('lanes.k', lanes.k), _tensor('lanes.eta_rsa', lanes.eta_rsa)
    _shape('lanes.k', k, (B, nk))
    _shape('lanes.eta_rsa', eta_rsa, (B, nk))
    if harvest_eta is None:
        harvest_eta = y0.new_empty((B, 0))
    harvest_eta = _tensor('harvest_eta', harvest_eta)
    if harvest_eta.dim() != 2 or harvest_eta.shape[0] != B:
        raise ValueError(f'harvest_eta must be ({B}, n_z), got {tuple(harvest_eta.shape)}')
    consts = np.ascontiguousarray(lanes.grid, dtype=np.float64)
    if consts.shape != (30,):
        raise ValueError(f"lanes' momentum grid must hold q, q^2, dlnf0, w2, w2 q, w2 q^2 (5 each), got "
                         f'{consts.shape}')
    inputs = [y0, eta, stack] + rows + [am, k, eta_rsa, harvest_eta]
    device = y0.device
    for t in inputs:
        if t.device != device:
            raise ValueError(f'every argument must be on {device}, got one on {t.device}')
    nz = harvest_eta.shape[1]
    y = torch.empty_like(y0, memory_format=torch.contiguous_format)
    harvest = y0.new_zeros((nz, n_rows, B, nk))
    return {'arrays': [t.contiguous() for t in inputs] + [y, harvest], 'consts': consts,
            'sizes': (B * nk, nk, B, stack.shape[2], eta.shape[0] - 1, nz, ns), 'y': y, 'harvest': harvest}


def launch(y0, eta, tabs, lanes, harvest_eta, n_state, n_rows, name='phase_a'):
    """Phase A on CUDA tensors: ``y0`` (n_state, B, nk) the state at each
    lane's first grid point, ``eta`` (n_steps + 1, B, nk) the grids, ``tabs``
    the tables of ``perturbations.build_tables`` ('stack', 'lneta0',
    'dlneta', 'K', 'wa_fld', 'cs2_fld', 'am'), ``lanes`` the
    ``perturbations.Lanes`` (its ``k``, ``eta_rsa`` and ``grid``),
    ``harvest_eta`` (B, n_z) or None, and ``n_state``, ``n_rows`` the state
    rows and the harvested rows as perturbations.py lays them out for
    ``lanes.ns`` species (``_n_state``, ``_rows_a``), the layout the kernel
    is built for. Returns the state at the grids' end (n_state, B, nk) and
    the harvest (n_z, n_rows, B, nk) (None without ``harvest_eta``).
    Counted in ``tracing.counters['rk4_kernel.launches']`` by (name,
    lanes, steps) once the launch returned without error."""
    p = plan(y0, eta, tabs, lanes, harvest_eta, n_state, n_rows)
    if not y0.is_cuda:
        raise ValueError(f'the phase-A kernel runs on CUDA tensors, not on {y0.device}')
    n_lanes, steps = p['sizes'][0], p['sizes'][4]
    if n_lanes:
        lib = _library()
        ptrs = (ctypes.c_void_p * len(p['arrays']))(*[t.data_ptr() for t in p['arrays']])
        consts = p['consts'].ctypes.data_as(ctypes.c_void_p)
        sizes = (ctypes.c_longlong * len(p['sizes']))(*p['sizes'])
        err = lib.rk4_phase_a_launch(ptrs, consts, sizes, torch.cuda.current_stream(y0.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'rk4_phase_a kernel launch failed: {lib.fftlog_core_error_string(err).decode()}')
        tracing.count('rk4_kernel.launches', (name, n_lanes, steps))
    return p['y'], (p['harvest'] if harvest_eta is not None else None)
