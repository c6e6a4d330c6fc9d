"""Composite Simpson quadrature (cosmoprimo_tpu/ops/quadrature.py::simpson)."""

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
