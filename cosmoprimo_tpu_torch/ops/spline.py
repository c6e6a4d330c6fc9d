"""Natural cubic and linear splines (cosmoprimo_tpu/ops/spline.py).

Same semantics as scipy.interpolate.CubicSpline(bc_type='natural'). Two
layouts:

- shared knots, knots first: :func:`natural_cubic_coeffs`, what
  :class:`Interpolator1D` and :class:`Interpolator2D` use (the knots are a
  small static grid, the columns are the batch);
- knots per row, knots last: :func:`natural_cubic_coeffs_rows` and
  :func:`cubic_eval_rows`, for knots that differ by cosmology (the BAO
  peak positions rescaled by each cosmology's sound horizon).

On CUDA tensors both solve their tridiagonal systems with the hand-written
kernel of ``csrc/spline_solve.cu`` (:mod:`.spline_kernel`), one Thomas pass
a system, through :class:`_NaturalSpline` (reverse and forward mode, vmap);
the shared-knot case is the per-row case with the knots broadcast. On CPU
tensors they take the plain versions: one LU factorisation of the (n-2,
n-2) matrix applied to every column (shared knots), and
:func:`tridiagonal_solve`, log-depth scans over the knot axis as in the JAX
package (knots per row).

Also the batched linear :func:`interp`.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from . import spline_kernel


def natural_cubic_coeffs(x, f):
    """Second derivatives M at the knots of the natural cubic spline through
    (x, f). ``x``: (n,) strictly increasing; ``f``: (n, ...).

    Returns ``M`` of shape ``f.shape`` with M[0] = M[-1] = 0. On CUDA
    tensors the kernel solves it, as :func:`natural_cubic_coeffs_rows` on
    the view ``f.movedim(0, -1)``; on CPU tensors :func:`_coeffs_plain`.
    """
    n = x.shape[0]
    if n == 2:
        return torch.zeros_like(f)
    if x.is_cuda or f.is_cuda:
        return natural_cubic_coeffs_rows(x, f.movedim(0, -1)).movedim(-1, 0)
    with tracing.span('cosmoprimo.spline_build'):
        return _coeffs_plain(x, f)


def _coeffs_plain(x, f):
    """The plain version of :func:`natural_cubic_coeffs`: one LU of the
    (n-2, n-2) matrix applied to every column."""
    n = x.shape[0]
    h = torch.diff(x)
    df = torch.diff(f, dim=0) / h.reshape((n - 1,) + (1,) * (f.dim() - 1))
    # interior rows: h[i-1]/6 M[i-1] + (h[i-1]+h[i])/3 M[i] + h[i]/6 M[i+1] = df[i] - df[i-1]
    rhs = (df[1:] - df[:-1]).reshape(n - 2, -1)
    off = h[1:-1] / 6.0
    T = torch.diag((h[:-1] + h[1:]) / 3.0) + torch.diag(off, 1) + torch.diag(off, -1)
    Mi = torch.linalg.solve_ex(T, rhs)[0].reshape((n - 2,) + f.shape[1:])
    zero = f.new_zeros((1,) + f.shape[1:])
    return torch.cat([zero, Mi, zero], dim=0)


def linear_eval(x, f, t, nu=0):
    """Piecewise-linear interpolation with edge extrapolation, the shape
    conventions of :func:`cubic_eval`."""
    n = x.shape[0]
    i = torch.clamp(torch.searchsorted(x, t, right=True) - 1, 0, n - 2)
    bshape = (-1,) + (1,) * (f.dim() - 1)
    h = (x[i + 1] - x[i]).reshape(bshape)
    if nu == 0:
        w = (t - x[i]).reshape(bshape) / h
        return f[i] * (1 - w) + f[i + 1] * w
    if nu == 1:
        return (f[i + 1] - f[i]) / h
    return f.new_zeros((t.shape[0],) + f.shape[1:])


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


def check_bounds(mask):
    """Raise ValueError unless every entry of the boolean tensor ``mask``
    (the queries inside the interpolation range) holds. Reads it on the
    host."""
    if not bool(mask.all()):
        raise ValueError('input outside of interpolation range')


class Interpolator1D(object):
    """Interpolator along axis 0 of ``fun`` (n, ...), natural cubic for
    ``k`` = 3 and linear otherwise (as the JAX package), with optional log10
    transforms of x and/or fun, and NaN outside the knot range unless
    ``extrap``. Tensors live on ``fun``'s device."""

    def __init__(self, x, fun, k=3, interp_x='lin', interp_fun='lin', extrap=False, assume_sorted=False):
        self.k = int(k)
        self.interp_x = str(interp_x)
        self.interp_fun = str(interp_fun)
        fun = torch.as_tensor(fun, dtype=torch.float64)
        x = torch.as_tensor(x, dtype=torch.float64, device=fun.device)
        self.shape = fun.shape[1:]
        if not assume_sorted:
            ix = torch.argsort(x)
            x, fun = x[ix], fun[ix]
        self.xmin, self.xmax = x[0], x[-1]
        self._x, self._fun = x, fun
        if self.interp_x == 'log':
            x = torch.log10(x)
        if self.interp_fun == 'log':
            fun = torch.log10(fun)
        self.extrap = bool(extrap)
        fun = fun.reshape(x.shape[0], -1)
        self._kx = x
        self._kf = fun
        self._kM = natural_cubic_coeffs(x, fun) if self.k == 3 else None

    @property
    def x(self):
        """The sorted knots, before any log transform."""
        return self._x

    @property
    def fun(self):
        """The values at :attr:`x`, before any log transform."""
        return self._fun

    def __call__(self, x, dx=0, bounds_error=False):
        """The interpolant (or its ``dx``-th derivative) at ``x``: x.shape +
        the trailing shape of ``fun``. With ``bounds_error``, an ``x`` outside
        the knots raises ValueError; that check reads the mask on the host,
        so it waits for the device."""
        x = torch.as_tensor(x, dtype=torch.float64, device=self._kx.device)
        toret_shape = x.shape + self.shape
        x = x.reshape(-1)
        mask = (x >= self.xmin) & (x <= self.xmax)
        if bounds_error:
            check_bounds(mask)
        tx = torch.log10(x) if self.interp_x == 'log' else x
        if self.k == 3:
            tmp = cubic_eval(self._kx, self._kf, self._kM, tx, nu=dx)
        else:
            tmp = linear_eval(self._kx, self._kf, tx, nu=dx)
        if self.interp_fun == 'log':
            tmp = 10**tmp
        if not self.extrap:
            tmp = torch.where(mask.reshape((-1,) + (1,) * (tmp.dim() - 1)), tmp, torch.nan)
        return tmp.reshape(toret_shape)

    def columns(self, x):
        """Each column of ``fun`` at its own abscissae (cubic only): ``x``
        broadcasts against the columns' shape + (m,), and so does the result
        (the value of :meth:`__call__` at those points, for that column)."""
        if self.k != 3:
            raise NotImplementedError('columns() evaluates the cubic interpolator only')
        x = torch.as_tensor(x, dtype=torch.float64, device=self._kx.device)
        shape = self.shape + x.shape[-1:]
        x = x.expand(shape).reshape(-1, shape[-1])           # (columns, m)
        tx = torch.log10(x) if self.interp_x == 'log' else x
        tmp = cubic_eval_rows(self._kx, self._kf.T, self._kM.T, tx.contiguous())
        if self.interp_fun == 'log':
            tmp = 10**tmp
        if not self.extrap:
            tmp = torch.where((x >= self.xmin) & (x <= self.xmax), tmp, torch.nan)
        return tmp.reshape(shape)


def interp(x, xp, fp):
    """Linear interpolation along the last axis with ``jnp.interp``
    semantics (clamped to the end values outside ``xp``), batched: ``x``
    (..., m), ``xp`` and ``fp`` (..., n), the leading axes broadcast, so
    ``xp`` may differ per cosmology. Returns (..., m)."""
    n = xp.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-1], xp.shape[:-1], fp.shape[:-1])
    x = x.expand(batch + x.shape[-1:]).contiguous()
    if xp.dim() == 1:
        i = torch.searchsorted(xp, x, right=True)
    else:
        i = torch.searchsorted(xp.expand(batch + (n,)).contiguous(), x, right=True)
    i = torch.clamp(i, 1, n - 1)
    xp, fp = xp.expand(batch + (n,)), fp.expand(batch + (n,))
    x0, x1 = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    f0, f1 = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = x1 - x0
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def _cell_cubic(h, dl, dr, f0, f1, m0, m1):
    """Value of the cubic on one knot cell: width ``h``, distances from the
    left/right knot ``dl``/``dr``, endpoint values ``f0``/``f1`` and endpoint
    second derivatives ``m0``/``m1``."""
    return (m0 * dr**3 / (6 * h) + m1 * dl**3 / (6 * h)
            + (f0 / h - m0 * h / 6) * dr + (f1 / h - m1 * h / 6) * dl)


class Interpolator2D(object):
    """Tensor-product interpolator on the grid (x, y) for ``fun``
    (nx, ny, ...), the trailing axes a batch, natural cubic along x (y) for
    ``kx`` (``ky``) = 3 and linear otherwise, with optional log10 transforms
    of x, y and fun, and NaN outside the grid unless ``extrap``. A linear
    direction has zero second derivatives, which reduce the cubic cell to
    the linear one.

    Every coefficient is solved at construction: ``My`` (second
    y-derivatives of the data), ``Mx`` (second x-derivatives) and ``Mxy``
    (the x-spline of ``My``). A call is then evaluation only: with
    ``grid=True`` the y-splines of (F, Mx) at the y-queries, then the
    x-spline of those at the x-queries, (nqx, nqy, ...); with ``grid=False``
    one bicubic cell per (x, y) pair, (nq, ...).
    """

    def __init__(self, x, y, fun, kx=3, ky=3, interp_x='lin', interp_y='lin', interp_fun='lin', extrap=False,
                 assume_sorted=False):
        self.interp_x, self.interp_y, self.interp_fun = str(interp_x), str(interp_y), str(interp_fun)
        fun = torch.as_tensor(fun, dtype=torch.float64)
        x = torch.as_tensor(x, dtype=torch.float64, device=fun.device)
        y = torch.as_tensor(y, dtype=torch.float64, device=fun.device)
        if not assume_sorted:
            ix, iy = torch.argsort(x), torch.argsort(y)
            x, y, fun = x[ix], y[iy], fun[ix][:, iy]
        self.xmin, self.xmax = x[0], x[-1]
        self.ymin, self.ymax = y[0], y[-1]
        if self.interp_x == 'log':
            x = torch.log10(x)
        if self.interp_y == 'log':
            y = torch.log10(y)
        if self.interp_fun == 'log':
            fun = torch.log10(fun)
        self.extrap = bool(extrap)
        self._tx, self._ty, self._tf = x, y, fun
        zeros = torch.zeros_like(fun)
        cubic_x, cubic_y = int(kx) == 3 and x.shape[0] > 2, int(ky) == 3 and y.shape[0] > 2
        self._My = natural_cubic_coeffs(y, fun.movedim(1, 0)).movedim(0, 1) if cubic_y else zeros
        self._Mx = natural_cubic_coeffs(x, fun) if cubic_x else zeros
        self._Mxy = natural_cubic_coeffs(x, self._My) if cubic_x and cubic_y else zeros

    def _eval_pairs(self, tx, ty):
        nx, ny = self._tx.shape[0], self._ty.shape[0]
        ix = torch.clamp(torch.searchsorted(self._tx, tx, right=True) - 1, 0, nx - 2)
        iy = torch.clamp(torch.searchsorted(self._ty, ty, right=True) - 1, 0, ny - 2)
        bshape = (-1,) + (1,) * (self._tf.dim() - 2)

        def b(t):
            return t.reshape(bshape)

        hx, hy = b(self._tx[ix + 1] - self._tx[ix]), b(self._ty[iy + 1] - self._ty[iy])
        dlx, drx = b(tx - self._tx[ix]), b(self._tx[ix + 1] - tx)
        dly, dry = b(ty - self._ty[iy]), b(self._ty[iy + 1] - ty)

        def row(i):
            g = _cell_cubic(hy, dly, dry, self._tf[i, iy], self._tf[i, iy + 1], self._My[i, iy], self._My[i, iy + 1])
            m = _cell_cubic(hy, dly, dry, self._Mx[i, iy], self._Mx[i, iy + 1], self._Mxy[i, iy], self._Mxy[i, iy + 1])
            return g, m

        g0, m0 = row(ix)
        g1, m1 = row(ix + 1)
        return _cell_cubic(hx, dlx, drx, g0, g1, m0, m1)

    def _eval_grid(self, tx, ty):
        gF = cubic_eval(self._ty, self._tf.movedim(1, 0), self._My.movedim(1, 0), ty)    # (nqy, nx, ...)
        gM = cubic_eval(self._ty, self._Mx.movedim(1, 0), self._Mxy.movedim(1, 0), ty)   # (nqy, nx, ...)
        return cubic_eval(self._tx, gF.movedim(0, 1), gM.movedim(0, 1), tx)              # (nqx, nqy, ...)

    def __call__(self, x, y, grid=True, bounds_error=False):
        """The interpolant on the grid x.shape + y.shape (``grid``) or at the
        pairs (x, y), then the trailing shape of ``fun``. ``bounds_error`` as
        :meth:`Interpolator1D.__call__`."""
        x = torch.as_tensor(x, dtype=torch.float64, device=self._tx.device)
        y = torch.as_tensor(y, dtype=torch.float64, device=self._tx.device)
        toret_shape = (x.shape + y.shape) if grid else x.shape
        x, y = x.reshape(-1), y.reshape(-1)
        mask_x = (x >= self.xmin) & (x <= self.xmax)
        mask_y = (y >= self.ymin) & (y <= self.ymax)
        mask = (mask_x[:, None] & mask_y) if grid else (mask_x & mask_y)
        if bounds_error:
            check_bounds(mask)
        tx = torch.log10(x) if self.interp_x == 'log' else x
        ty = torch.log10(y) if self.interp_y == 'log' else y
        tmp = self._eval_grid(tx, ty) if grid else self._eval_pairs(tx, ty)
        if self.interp_fun == 'log':
            tmp = 10**tmp
        if not self.extrap:
            tmp = torch.where(mask.reshape(mask.shape + (1,) * (tmp.dim() - mask.dim())), tmp, torch.nan)
        return tmp.reshape(toret_shape + tmp.shape[mask.dim():])


def _scan(elems, combine):
    """Inclusive scan over the last axis of the tuple of tensors ``elems``,
    ``combine(earlier, later)`` associative, by log-depth doubling."""
    elems = list(torch.broadcast_tensors(*elems))
    n = elems[0].shape[-1]
    d = 1
    while d < n:
        new = combine([e[..., :-d] for e in elems], [e[..., d:] for e in elems])
        elems = [torch.cat([e[..., :d], m], dim=-1) for e, m in zip(elems, new)]
        d *= 2
    return elems


def _mobius_combine(a, b):
    """b @ a for 2x2 matrices as 4-tuples, normalised by the largest entry:
    only the ratios of the cumulative products are used."""
    a00, a01, a10, a11 = a
    b00, b01, b10, b11 = b
    c = (b00 * a00 + b01 * a10, b00 * a01 + b01 * a11, b10 * a00 + b11 * a10, b10 * a01 + b11 * a11)
    norm = torch.maximum(torch.maximum(c[0].abs(), c[1].abs()), torch.maximum(c[2].abs(), c[3].abs()))
    norm = torch.where(norm == 0, 1.0, norm)
    return tuple(x / norm for x in c)


def _linear_combine(a, b):
    """Composition of the affine maps y -> a y + b: ``a`` first."""
    return b[0] * a[0], b[0] * a[1] + b[1]


def _linear_recurrence(a, b):
    """y_i = a_i y_{i-1} + b_i along the last axis, y_{-1} = 0."""
    return _scan((a, b), _linear_combine)[1]


def tridiagonal_solve(dl, d, du, b):
    """Solve the tridiagonal systems T y = b along the last axis, with
    sub-, main and super-diagonals ``dl`` (dl[..., 0] unused), ``d``, ``du``
    (du[..., -1] unused); all broadcast against ``b`` (..., n), so each row
    may have its own matrix.

    The JAX package's parallel form: the forward elimination
    w_i = du_i / (d_i - dl_i w_{i-1}) as a prefix of 2x2 (Mobius) products,
    then the two linear recurrences of the elimination and the back
    substitution, each a log-depth scan."""
    zero = torch.zeros_like(d[..., :1])
    P = _scan((torch.zeros_like(d), du, -dl, d), _mobius_combine)
    w = P[1] / P[3]
    denom = d - dl * torch.cat([zero, w[..., :-1]], dim=-1)
    g = _linear_recurrence(-dl / denom, b / denom)
    return _linear_recurrence(-w.flip(-1), g.flip(-1)).flip(-1)


def _diagonals(h):
    """Sub-, main and super-diagonals of the natural-spline matrix for the
    cell widths ``h`` (..., n - 1), as :func:`tridiagonal_solve` takes them."""
    zero = torch.zeros_like(h[..., :1])
    return (torch.cat([zero, h[..., 1:-1] / 6.0], dim=-1), (h[..., :-1] + h[..., 1:]) / 3.0,
            torch.cat([h[..., 1:-1] / 6.0, zero], dim=-1))


def _pad_ends(Mi):
    zero = torch.zeros_like(Mi[..., :1])
    return torch.cat([zero, Mi, zero], dim=-1)


def _coeffs_rows_plain(x, f):
    """The plain version of :func:`natural_cubic_coeffs_rows`."""
    h = torch.diff(x, dim=-1)
    df = torch.diff(f, dim=-1) / h
    rhs = df[..., 1:] - df[..., :-1]
    if x.shape[-1] == 3:
        return _pad_ends(rhs / ((h[..., :-1] + h[..., 1:]) / 3.0))
    return _pad_ends(tridiagonal_solve(*_diagonals(h), rhs))


def _solve(x, v, given):
    """M (..., n) with zero ends from the interior rows of the natural-spline
    system of knots ``x`` (..., n): right-hand side from the values ``v``
    (..., n), or ``v`` (..., n - 2) itself with ``given``. The kernel on
    CUDA tensors, the plain scans on CPU tensors."""
    if x.is_cuda or v.is_cuda:
        return spline_kernel.launch(x, v, given)
    if given:
        return _pad_ends(tridiagonal_solve(*_diagonals(torch.diff(x, dim=-1)), v))
    return _coeffs_rows_plain(x, v)


def _tangent_rhs(x, v, M, x_t, v_t, given):
    """The right-hand side whose solve is M's tangent: dM = T^-1 (dr - dT M),
    r the right-hand side (computed from the values, or ``v`` given) and T
    the matrix, for the tangents ``x_t`` and ``v_t`` (either may be None)."""
    if given:
        q = v_t if v_t is not None else 0.0
    else:
        h = torch.diff(x, dim=-1)
        ds = torch.diff(v_t, dim=-1) if v_t is not None else 0.0
        if x_t is not None:
            ds = ds - torch.diff(v, dim=-1) / h * torch.diff(x_t, dim=-1)
        ds = ds / h                                     # the slopes' tangent
        q = ds[..., 1:] - ds[..., :-1]
    if x_t is not None:
        dh = torch.diff(x_t, dim=-1)
        q = q - (dh[..., :-1] * (M[..., :-2] + 2.0 * M[..., 1:-1])
                 + dh[..., 1:] * (2.0 * M[..., 1:-1] + M[..., 2:])) / 6.0
    return q


def _adjoint(x, v, M, lam, given):
    """The gradients of <g, M> for ``x`` and ``v`` (broadcast shapes), with
    ``lam`` = T^-1 g (zero ends): the transpose of :func:`_tangent_rhs`."""
    h = torch.diff(x, dim=-1)
    g_h = -(lam[..., 1:] * (M[..., :-1] + 2.0 * M[..., 1:]) + lam[..., :-1] * (2.0 * M[..., :-1] + M[..., 1:])) / 6.0
    if given:
        g_v = lam[..., 1:-1]
    else:
        w = (lam[..., :-1] - lam[..., 1:]) / h
        g_v = F.pad(w, (1, 0)) - F.pad(w, (0, 1))
        g_h = g_h - torch.diff(v, dim=-1) / h * w
    return F.pad(g_h, (1, 0)) - F.pad(g_h, (0, 1)), g_v


def _vmapped(t, dim, nbatch):
    """``t`` with its vmapped axis ``dim`` first and, after it, as many
    leading axes as the broadcast batch (``nbatch``) + the knot axis."""
    if dim is None:
        return t
    t = t.movedim(dim, 0)
    return t[(slice(None),) + (None,) * (nbatch + 1 - (t.dim() - 1))]


class _NaturalSpline(torch.autograd.Function):
    """M = :func:`_solve` (x, v, given), differentiable in the knots and the
    values. The matrix T is symmetric, so the tangent (``jvp``) and the
    adjoint (``backward``) are each one more solve with a right-hand side
    given, dM = T^-1 (dr - dT M): on CUDA tensors one more launch of the
    kernel. ``vmap`` moves the vmapped axes in front of the batch: one
    launch."""

    @staticmethod
    def forward(x, v, given):
        return _solve(x, v, given)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, v, given = inputs
        ctx.given = given
        ctx.save_for_backward(x, v, output)
        ctx.save_for_forward(x, v, output)

    @staticmethod
    def backward(ctx, grad):
        x, v, M = ctx.saved_tensors
        lam = _NaturalSpline.apply(x, grad[..., 1:-1], True)
        g_x, g_v = _adjoint(x, v, M, lam, ctx.given)
        return (g_x.sum_to_size(x.shape) if ctx.needs_input_grad[0] else None,
                g_v.sum_to_size(v.shape) if ctx.needs_input_grad[1] else None, None)

    @staticmethod
    def jvp(ctx, x_t, v_t, _):
        x, v, M = ctx.saved_tensors
        return _NaturalSpline.apply(x, _tangent_rhs(x, v, M, x_t, v_t, ctx.given), True)

    @staticmethod
    def vmap(info, in_dims, x, v, given):
        x_dim, v_dim = in_dims[:2]

        def logical(t, dim):
            return t.shape[:-1] if dim is None else t.shape[:dim] + t.shape[dim + 1:-1]

        nbatch = len(torch.broadcast_shapes(logical(x, x_dim), logical(v, v_dim)))
        return _NaturalSpline.apply(_vmapped(x, x_dim, nbatch), _vmapped(v, v_dim, nbatch), given), 0


def natural_cubic_coeffs_rows(x, f):
    """Second derivatives M (..., n) of the natural cubic splines through
    (x, f) with the knots on the LAST axis: ``x`` (..., n) strictly
    increasing along it, broadcasting against ``f`` (..., n).

    On CUDA tensors (float64, one device, else it raises) the kernel solves
    them (from 4 knots), differentiable in ``x`` and ``f``; on CPU tensors
    the plain version."""
    n = x.shape[-1]
    if n == 2:
        return torch.zeros_like(f + x)
    with tracing.span('cosmoprimo.spline_build'):
        if x.is_cuda or f.is_cuda:
            spline_kernel.check(x, f)
            if n > 3:
                return _NaturalSpline.apply(x, f, False)
        return _coeffs_rows_plain(x, f)


def cubic_eval_rows(x, f, M, t):
    """The natural cubic splines of knots ``x``, values ``f`` and second
    derivatives ``M`` (..., n), knots on the last axis, at ``t`` (..., m):
    leading axes broadcast, so the knots, the values or the queries may be
    shared between rows. Out-of-range queries extrapolate with the edge
    cubic. Returns (..., m)."""
    n = x.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-1], f.shape[:-1], M.shape[:-1], t.shape[:-1])
    if x.dim() == 1:
        i = torch.searchsorted(x, t, right=True)
    else:
        xs = x.expand(torch.broadcast_shapes(x.shape[:-1], t.shape[:-1]) + (n,)).contiguous()
        i = torch.searchsorted(xs, t.expand(xs.shape[:-1] + t.shape[-1:]).contiguous(), right=True)
    i = torch.clamp(i - 1, 0, n - 2).expand(batch + t.shape[-1:])

    def take(a, j):
        return torch.gather(a.expand(batch + (n,)), -1, j)

    x0, x1 = take(x, i), take(x, i + 1)
    return _cell_cubic(x1 - x0, t - x0, x1 - t, take(f, i), take(f, i + 1), take(M, i), take(M, i + 1))
