"""Natural cubic splines (cosmoprimo_tpu/ops/spline.py).

Same semantics as scipy.interpolate.CubicSpline(bc_type='natural'). The JAX
package solves the tridiagonal system with associative scans, a form chosen
for TPU parallelism. Here the system is solved by one LU factorisation of
the (n-2, n-2) matrix, which depends on the knots only, applied to every
value column at once: the knots are a small static grid (119 nodes on the
distance table) and the columns are the batch.
"""

import torch


def natural_cubic_coeffs(x, f):
    """Second derivatives M at the knots of the natural cubic spline through
    (x, f). ``x``: (n,) strictly increasing; ``f``: (n, ...).

    Returns ``M`` of shape ``f.shape`` with M[0] = M[-1] = 0.
    """
    n = x.shape[0]
    if n == 2:
        return torch.zeros_like(f)
    h = torch.diff(x)
    df = torch.diff(f, dim=0) / h.reshape((n - 1,) + (1,) * (f.dim() - 1))
    # interior rows: h[i-1]/6 M[i-1] + (h[i-1]+h[i])/3 M[i] + h[i]/6 M[i+1] = df[i] - df[i-1]
    rhs = (df[1:] - df[:-1]).reshape(n - 2, -1)
    off = h[1:-1] / 6.0
    T = torch.diag((h[:-1] + h[1:]) / 3.0) + torch.diag(off, 1) + torch.diag(off, -1)
    Mi = torch.linalg.solve_ex(T, rhs)[0].reshape((n - 2,) + f.shape[1:])
    zero = f.new_zeros((1,) + f.shape[1:])
    return torch.cat([zero, Mi, zero], dim=0)


def cubic_eval(x, f, M, t, nu=0):
    """Evaluate the cubic spline defined by knots ``x`` (n,), values ``f``
    (n, ...) and second derivatives ``M`` at query points ``t`` (m,).

    ``nu`` = 0, 1 or 2 for the spline or its derivatives. Out-of-range
    queries extrapolate with the edge polynomials (mask outside for NaN).
    Returns shape (m,) + f.shape[1:].
    """
    n = x.shape[0]
    i = torch.clamp(torch.searchsorted(x, t, right=True) - 1, 0, n - 2)
    xi = x[i]
    xi1 = x[i + 1]
    bshape = (-1,) + (1,) * (f.dim() - 1)
    h_ = (xi1 - xi).reshape(bshape)
    dl = (t - xi).reshape(bshape)      # distance from left knot
    dr = (xi1 - t).reshape(bshape)     # distance from right knot
    fi, fi1 = f[i], f[i + 1]
    Mi, Mi1 = M[i], M[i + 1]
    if nu == 0:
        return (Mi * dr**3 / (6 * h_) + Mi1 * dl**3 / (6 * h_)
                + (fi / h_ - Mi * h_ / 6) * dr + (fi1 / h_ - Mi1 * h_ / 6) * dl)
    if nu == 1:
        return (-Mi * dr**2 / (2 * h_) + Mi1 * dl**2 / (2 * h_)
                - (fi / h_ - Mi * h_ / 6) + (fi1 / h_ - Mi1 * h_ / 6))
    if nu == 2:
        return (Mi * dr + Mi1 * dl) / h_
    raise ValueError('nu must be 0, 1 or 2')


class Interpolator1D(object):
    """Natural cubic interpolator along axis 0 of ``fun`` (n, ...), with
    optional log10 transforms of x and/or fun, and NaN outside the knot
    range unless ``extrap``. Tensors live on ``fun``'s device."""

    def __init__(self, x, fun, k=3, interp_x='lin', interp_fun='lin', extrap=False, assume_sorted=False):
        if k != 3:
            raise NotImplementedError('only cubic (k=3) interpolation is ported')
        self.interp_x = str(interp_x)
        self.interp_fun = str(interp_fun)
        fun = torch.as_tensor(fun, dtype=torch.float64)
        x = torch.as_tensor(x, dtype=torch.float64, device=fun.device)
        self.shape = fun.shape[1:]
        if not assume_sorted:
            ix = torch.argsort(x)
            x, fun = x[ix], fun[ix]
        self.xmin, self.xmax = x[0], x[-1]
        if self.interp_x == 'log':
            x = torch.log10(x)
        if self.interp_fun == 'log':
            fun = torch.log10(fun)
        self.extrap = bool(extrap)
        fun = fun.reshape(x.shape[0], -1)
        self._kx = x
        self._kf = fun
        self._kM = natural_cubic_coeffs(x, fun)

    def __call__(self, x, dx=0):
        x = torch.as_tensor(x, dtype=torch.float64, device=self._kx.device)
        toret_shape = x.shape + self.shape
        x = x.reshape(-1)
        mask = (x >= self.xmin) & (x <= self.xmax)
        tx = torch.log10(x) if self.interp_x == 'log' else x
        tmp = cubic_eval(self._kx, self._kf, self._kM, tx, nu=dx)
        if self.interp_fun == 'log':
            tmp = 10**tmp
        if not self.extrap:
            tmp = torch.where(mask.reshape((-1,) + (1,) * (tmp.dim() - 1)), tmp, torch.nan)
        return tmp.reshape(toret_shape)
