"""Composite Simpson, Romberg, Gauss-Legendre sums, Gauss-Laguerre and
Gauss-Legendre nodes and trapezoid weights (cosmoprimo_tpu/ops/quadrature.py)."""

import functools

import numpy as np
import torch


def simpson(y, x=None, dx=1.0, axis=-1, even='avg'):
    """Composite Simpson integration of sampled values along ``axis``,
    matching scipy.integrate.simpson semantics, including the 'avg' handling
    of an even number of samples. ``x`` is 1D or shaped like ``y``."""
    N = y.shape[axis]
    y = torch.movedim(y, axis, 0)
    if x is not None:
        if x.dim() == 1:
            xb = x.reshape((N,) + (1,) * (y.dim() - 1))
        else:
            xb = torch.movedim(x, axis, 0)
    else:
        xb = None

    def basic(ys, xs, start, stop):
        # Simpson over [start, stop) in steps of 2
        y0 = ys[start:stop:2]
        y1 = ys[start + 1:stop + 1:2]
        y2 = ys[start + 2:stop + 2:2]
        if xs is None:
            return torch.sum(dx / 3.0 * (y0 + 4 * y1 + y2), dim=0)
        h = torch.diff(xs, dim=0)
        h0 = h[start:stop:2]
        h1 = h[start + 1:stop + 1:2]
        hsum = h0 + h1
        hprod = h0 * h1
        h0divh1 = h0 / h1
        tmp = hsum / 6.0 * (y0 * (2 - 1.0 / h0divh1) + y1 * hsum * hsum / hprod + y2 * (2 - h0divh1))
        return torch.sum(tmp, dim=0)

    if N % 2 == 0:
        val = 0.0
        result = 0.0
        if even in ('avg', 'first'):
            hlast = (xb[-1] - xb[-2]) if xb is not None else dx
            val = val + 0.5 * hlast * (y[-1] + y[-2])
            result = result + basic(y, xb, 0, N - 3)
        if even in ('avg', 'last'):
            hfirst = (xb[1] - xb[0]) if xb is not None else dx
            val = val + 0.5 * hfirst * (y[1] + y[0])
            result = result + basic(y, xb, 1, N - 2)
        if even == 'avg':
            val = val / 2.0
            result = result / 2.0
        return result + val
    return basic(y, xb, 0, N - 2)


def trapezoid_weights(x):
    """Composite-trapezoid weights over the (1D, increasing) grid ``x``:
    int f dx ~= sum w_i f(x_i). Shared by the sigma^2 / sigma_v^2 matmul
    integrals (models/halofit.py, models/hmcode.py)."""
    dx = torch.diff(x)
    return torch.cat([dx[:1] / 2, (dx[:-1] + dx[1:]) / 2, dx[-1:] / 2])


def romberg(function, a, b, args=(), epsabs=1e-8, epsrel=1e-8, divmax=10, return_error=False, device=None):
    """Romberg integration of ``function(x, *args)`` over [a, b] with
    ``divmax`` refinements. ``a`` is a Python float. With ``b`` a Python
    float, ``function`` takes a 1D tensor of abscissae on ``device`` and
    returns (..., x.size), the batch leading; with ``b`` a tensor of the
    batch shape (an upper limit per row), it takes the abscissae of each
    row, batch + (m,), and returns the same shape. The result has the batch
    shape; with ``return_error``, (result, err), ``err`` the last two
    diagonal entries' difference. Where that difference exceeds ``epsabs``
    or ``epsrel``, the row is NaN: nothing is checked on the host."""
    def func(x):
        return function(x, *args)

    rows = isinstance(b, torch.Tensor)
    if rows:   # the batch leads, then one axis for the abscissae
        device, b = b.device, b[..., None]
        ends = func(torch.cat([torch.full_like(b, a), b], dim=-1))
    else:
        ends = func(torch.tensor([a, b], dtype=torch.float64, device=device))
    interval_size = b - a
    ordsum = 0.5 * (ends[..., 0] + ends[..., 1])
    if rows:
        ordsum = ordsum[..., None]
    last_row = [interval_size * ordsum]
    n = 1
    for i in range(1, divmax + 1):
        n *= 2
        h = interval_size / (n // 2)
        points = a + (torch.arange(n // 2, dtype=torch.float64, device=device) + 0.5) * h
        ordsum = ordsum + torch.sum(func(points), dim=-1, keepdim=rows)
        row = [interval_size * ordsum / n]
        for k in range(1, i + 1):
            pow4 = 4.0 ** k
            row.append((pow4 * row[k - 1] - last_row[k - 1]) / (pow4 - 1.0))
        err = torch.abs(last_row[i - 1] - row[i])
        last_row = row
    result = last_row[divmax]
    result = torch.where((err < epsabs) & (err < torch.abs(result) * epsrel), result, torch.nan)
    if rows:
        result, err = result[..., 0], err[..., 0]
    return (result, err) if return_error else result


def gauss_legendre(fun, a, b, n=128, device=None):
    """Gauss-Legendre integral of ``fun`` over [a, b] with ``n`` nodes.
    ``a`` and ``b`` are floats, or tensors of one batch shape: ``fun`` then
    takes the nodes (n,) or (n,) + that shape, and may return trailing axes,
    which are kept; the sum runs over axis 0. The nodes lie on the bounds'
    device, else on ``device``, else on the CPU; the sum runs where ``fun``
    returns."""
    xi, wi = leggauss(n)
    tensors = [v for v in (a, b) if isinstance(v, torch.Tensor)]
    if tensors:
        device = tensors[0].device
    half = (b - a) / 2.0
    mid = (b + a) / 2.0
    batch = torch.broadcast_shapes(*(v.shape for v in tensors)) if tensors else ()
    nodes = (n,) + (1,) * len(batch)
    xi = torch.from_numpy(xi).to(device).reshape(nodes)
    y = fun(half * xi + mid)
    w = torch.from_numpy(wi).to(y.device).reshape(nodes + (1,) * (y.dim() - len(nodes)))
    total = torch.sum(y * w, dim=0)
    if tensors:
        half = half.to(total.device).reshape(half.shape + (1,) * (total.dim() - half.dim()))
    return half * total


fixed_quad_legendre = gauss_legendre


@functools.lru_cache(maxsize=32)
def leggauss(n):
    """Gauss-Legendre nodes and weights on [-1, 1] (numpy, made once)."""
    return np.polynomial.legendre.leggauss(n)


@functools.lru_cache(maxsize=8)
def gauss_laguerre_nodes(n):
    """Gauss-Laguerre nodes and weights (numpy, made once)."""
    return np.polynomial.laguerre.laggauss(n)


def cumsum_blocked(x):
    """Cumulative sum along the last axis in XLA's order on the CPU: the sum
    within blocks of 16 values, plus the exclusive cumulative sum of
    the blocks' totals, made the same way. The JAX package's time grids and
    optical depths are cumulative sums of ~1e4 terms; summed in this order
    the port's land on the same bits, where a running sum drifts by ~1e-14
    (and moves the fetched coefficients by ~1e-12)."""
    n, block = x.shape[-1], 16
    if n <= block:
        return torch.cumsum(x, dim=-1)
    nb = -(-n // block)
    pad = torch.nn.functional.pad(x, (0, nb * block - n)).reshape(x.shape[:-1] + (nb, block))
    within = torch.cumsum(pad, dim=-1)
    totals = cumsum_blocked(within[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
    return (within + before[..., None]).reshape(x.shape[:-1] + (nb * block,))[..., :n]
