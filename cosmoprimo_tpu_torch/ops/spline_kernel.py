"""The natural-spline solve as a hand-written CUDA kernel (``csrc/spline_solve.cu``):
the layout of its arguments, their checks and the launch.

For knots ``x`` (..., n) and values ``v`` (..., n), the leading axes
broadcast, :func:`launch` returns the second derivatives M (..., n) of the
natural cubic splines through (x, v) along the last axis, M[..., 0] =
M[..., -1] = 0; with ``given``, ``v`` (..., n - 2) is the right-hand side of
the same tridiagonal system instead (the tangent and adjoint solves of
``spline._NaturalSpline``). The last axis is the knot axis of a view: the
callers pass ``f.movedim(0, -1)``, ``y.T`` or ``expand``-ed knots as they
are, and :func:`plan` reads the strides, so none of them is copied.

The kernel is built with the FFTLog core into one library
(:func:`fftlog_kernel.build`, every ``.cu`` under ``csrc/``).
"""

import ctypes
import functools
import math

import torch

from .. import tracing
from . import fftlog_kernel

MIN_KNOTS = 4


@functools.lru_cache(maxsize=1)
def _library():
    lib = fftlog_kernel._library()
    lib.spline_solve_launch.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3) * 3 + \
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.spline_solve_launch.restype = ctypes.c_int
    return lib


def check(x, v, given=False):
    """Raise unless ``x`` (..., n) and ``v`` (..., n), or (..., n - 2) with
    ``given``, are float64 tensors on one device whose leading axes
    broadcast."""
    for name, t in (('x', x), ('v', v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f'{name} must be a tensor, got {type(t).__name__}')
        if t.dtype != torch.float64:
            raise TypeError(f'the spline kernel takes float64, got {name} of {t.dtype}')
        if t.dim() < 1:
            raise ValueError(f'{name} must have a knot axis')
    if x.device != v.device:
        raise ValueError(f'x is on {x.device}, v on {v.device}')
    n = x.shape[-1]
    if v.shape[-1] != (n - 2 if given else n):
        raise ValueError(f'{"given right-hand sides" if given else "values"} of {v.shape[-1]} knots for {n} knots')
    torch.broadcast_shapes(x.shape[:-1], v.shape[:-1])


def _empty_like(t, shape):
    """An uninitialised tensor of ``shape`` whose axes lie in memory in the
    order of ``t``'s strides (expanded axes outermost), as ``empty_like``
    lays out a dense tensor: a transposed or moved view gives a result that
    is contiguous once moved back."""
    order = sorted(range(t.dim()), key=lambda d: -(t.stride(d) if t.stride(d) else math.inf))
    out = torch.empty([shape[d] for d in order], dtype=torch.float64, device=t.device)
    return out.permute([order.index(d) for d in range(t.dim())])


def _merged(shape, tensors):
    """The batch axes of ``shape`` (the knot axis left out), size-1 axes
    dropped, ordered by the last tensor's strides, adjacent axes merged
    where every tensor allows it: a list of [size, stride of each tensor]."""
    dims = sorted((d for d in range(len(shape)) if shape[d] != 1), key=lambda d: -tensors[-1].stride(d))
    merged = []
    for d in dims:
        axis = [shape[d]] + [t.stride(d) for t in tensors]
        if merged and all(merged[-1][i] == shape[d] * axis[i] for i in range(1, len(axis))):
            merged[-1] = [merged[-1][0] * shape[d]] + axis[1:]
        else:
            merged.append(axis)
    return merged


def plan(x, v, given=False):
    """How the kernel sees the systems: a dict with the broadcast views
    ``x`` and ``v``, the output ``out`` (batch + (n,), laid out as ``v``),
    ``axes`` (at most two [size, x, v, out strides] batch axes, outer
    first), ``knot_strides`` (x, v, out), ``shared`` (the knots are the
    same for every system), ``tiled`` (``v``'s knot axis is contiguous:
    the shared-memory tiles) and ``systems``. Axes that do not merge into
    two are copied into one."""
    n = x.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-1], v.shape[:-1])
    x, v = x.expand(batch + (n,)), v.expand(batch + v.shape[-1:])
    out = _empty_like(v, batch + (n,))
    axes = _merged(batch, (x, v, out))
    if len(axes) > 2:
        shared = all(x.stride(d) == 0 for d in range(len(batch)))
        v = v.contiguous()
        x = x if shared else x.contiguous()
        out = torch.empty(batch + (n,), dtype=torch.float64, device=v.device)
        axes = _merged(batch, (x, v, out))
    axes = [[1, 0, 0, 0]] * (2 - len(axes)) + axes
    return {'x': x, 'v': v, 'out': out, 'axes': axes,
            'knot_strides': (x.stride(-1), v.stride(-1), out.stride(-1)),
            'shared': all(axis[1] == 0 for axis in axes), 'tiled': v.stride(-1) == 1,
            'systems': axes[0][0] * axes[1][0]}


def layout(p):
    """The layout of a plan, as the counter ``spline.shapes`` keys it."""
    return '.'.join(('tiled' if p['tiled'] else 'strided', 'shared' if p['shared'] else 'rows'))


def launch(x, v, given=False):
    """The kernel on CUDA tensors (see the module docstring); returns M
    (batch + (n,)). Counted in ``tracing.counters`` (``spline.launches``,
    ``spline.shapes`` by (systems, knots, layout)) once the launch returned
    without error."""
    check(x, v, given)
    if not x.is_cuda:
        raise ValueError(f'the spline kernel runs on CUDA tensors, not on {x.device}')
    n = x.shape[-1]
    if n < MIN_KNOTS:
        raise ValueError(f'the spline kernel takes {MIN_KNOTS} knots or more, got {n}')
    p = plan(x, v, given)
    out = p['out']
    if p['systems'] == 0:
        return out
    lib = _library()
    (na, xa, va, oa), (nb, xb, vb, ob) = p['axes']
    xk, vk, ok = p['knot_strides']
    if p['shared']:
        fac, scratch = torch.empty(4 * n, dtype=torch.float64, device=x.device), None
    else:
        fac, scratch = None, torch.empty(p['systems'] * n, dtype=torch.float64, device=x.device)
    err = lib.spline_solve_launch(p['x'].data_ptr(), xk, xa, xb, p['v'].data_ptr(), vk, va, vb,
                                  out.data_ptr(), ok, oa, ob, fac.data_ptr() if fac is not None else None,
                                  scratch.data_ptr() if scratch is not None else None, n, na, nb,
                                  int(p['shared']), int(given), int(p['tiled']),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'spline_solve kernel launch failed: {lib.fftlog_core_error_string(err).decode()}')
    counters = tracing.counters
    counters['spline.launches'] += 1
    shape = (p['systems'], n, layout(p))
    counters['spline.shapes'][shape] = counters['spline.shapes'].get(shape, 0) + 1
    return out
