"""Fixed-grid Runge-Kutta integration, cumulative quadrature and the linear
2nd-order solvers on a fixed grid (cosmoprimo_tpu/ops/odeint.py::odeint,
cumquad_rk4, linear_ode2_magnus, linear_ode2_rk4_prefix)."""

import numpy as np
import torch


def odeint(fun, y0, t, args=(), method='rk4'):
    """Integrate dy/dt = fun(y, t, *args) on the fixed 1D grid ``t``
    (increasing or decreasing) with 'rk1', 'rk2' or 'rk4', returning y at
    every grid point, y(t[0]) = y0: shape t.shape + y0.shape. ``y0`` is a
    scalar or a tensor (any leading batch axes are carried through ``fun``);
    ``fun`` gets ``t`` as a 0-d tensor. One step per interval, in order."""
    if method not in ('rk1', 'rk2', 'rk4'):
        raise ValueError(f'unknown method {method}')
    t = torch.as_tensor(t, dtype=torch.float64)
    y = torch.as_tensor(y0, dtype=torch.float64, device=t.device)

    def func(y, tt):
        return fun(y, tt, *args)

    def step(y, t_last, h):
        k1 = func(y, t_last)
        if method == 'rk1':
            return y + h * k1
        k2 = func(y + h * k1 / 2, t_last + h / 2)
        if method == 'rk2':
            return y + h * k2
        k3 = func(y + h * k2 / 2, t_last + h / 2)
        k4 = func(y + h * k3, t_last + h)
        return y + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    ys = [y]
    for i in range(1, t.shape[0]):
        y = step(y, t[i - 1], t[i] - t[i - 1])
        ys.append(y)
    return torch.stack(ys)


def cumquad_rk4(fun, y0, t, args=()):
    """Cumulative integral y(t) = y0 + int fun(t') dt' on the fixed 1D grid
    ``t``, for integrands that do not depend on y: the RK4 step on such an
    integrand is Simpson's rule with the midpoint, so this is one vectorised
    evaluation and a cumulative sum.

    ``fun(None, t, *args)`` returns values with the grid on the LAST axis
    (leading axes are the batch), and so does the result.
    """
    def func(tt):
        return fun(None, tt, *args)

    mid = (t[:-1] + t[1:]) / 2.0
    f_ends = func(t)
    f_mid = func(mid)
    h = torch.diff(t)
    inc = h / 6.0 * (f_ends[..., :-1] + 4.0 * f_mid + f_ends[..., 1:])
    zero = torch.zeros(inc.shape[:-1] + (1,), dtype=inc.dtype, device=inc.device)
    return y0 + torch.cat([zero, torch.cumsum(inc, dim=-1)], dim=-1)


def linear_ode2_magnus(coeffs_fun, y0, t):
    """Solve the linear 2nd-order ODE y'' = s(t) y + f(t) y' on the fixed 1D
    grid ``t`` (n,), returning (..., n, 2) with columns (y, y').

    ``coeffs_fun(t)`` returns (s, f) with the grid on the last axis and the
    batch on the leading ones. As a first-order system Y' = A(t) Y with
    A = [[0, 1], [s, f]], each interval's propagator is the exponential of
    the 4th-order two-point Gauss-Legendre Magnus expansion
    Omega = h/2 (A1 + A2) + sqrt(3) h^2 / 12 [A2, A1], in closed form for a
    2x2 matrix. The cumulative products P_i ... P_1 come from a log-depth
    doubling scan (Hillis-Steele: ceil(log2(n - 1)) rounds, each one
    batched product over every interval), where the JAX package uses
    ``jax.lax.associative_scan``; a product is combined as ``b @ a`` with
    ``a`` the earlier interval, as there.
    """
    h = torch.diff(t)                                     # (n-1,)
    mid = (t[:-1] + t[1:]) / 2.0
    off = h * (np.sqrt(3.0) / 6.0)
    s1, f1 = coeffs_fun(mid - off)
    s2, f2 = coeffs_fun(mid + off)

    # the 2x2 matrices as four component arrays, intervals on the last axis
    # Omega componentwise: [A2, A1] = [[ds, df], [f2 s1 - f1 s2, -ds]]
    ch = np.sqrt(3.0) * h ** 2 / 12.0
    ds, df = s1 - s2, f1 - f2
    o00 = ch * ds
    o01 = h + ch * df
    o10 = h / 2.0 * (s1 + s2) + ch * (f2 * s1 - f1 * s2)
    o11 = h / 2.0 * (f1 + f2) - ch * ds

    # closed-form expm of a 2x2 matrix: with B = Omega - (tr/2) I traceless,
    # B^2 = -det(B) I = q^2 I, so expm = e^{tr/2} (c0 I + c1 B) where
    # (c0, c1) = (cosh q, sinh(q)/q) for q^2 > 0 and (cos p, sin(p)/p) for
    # q^2 = -p^2 < 0, with the series 1 + q^2/6 near 0
    tr2 = (o00 + o11) / 2.0
    b00 = o00 - tr2                                       # b11 = -b00
    q2 = o01 * o10 + b00 ** 2                             # = -det(B)
    q = torch.sqrt(torch.abs(q2))
    qs = torch.where(q > 1e-8, q, 1.0)
    c0 = torch.where(q2 >= 0, torch.cosh(q), torch.cos(q))
    c1 = torch.where(q > 1e-8, torch.where(q2 >= 0, torch.sinh(qs) / qs, torch.sin(qs) / qs), 1.0 + q2 / 6.0)
    e = torch.exp(tr2)
    return _propagate((e * (c0 + c1 * b00), e * c1 * o01, e * c1 * o10, e * (c0 - c1 * b00)), y0)


def _mmul(x, y):
    """Product x @ y of 2x2 matrices given as 4-tuples (00, 01, 10, 11)."""
    x00, x01, x10, x11 = x
    y00, y01, y10, y11 = y
    return (x00 * y00 + x01 * y10, x00 * y01 + x01 * y11, x10 * y00 + x11 * y10, x10 * y01 + x11 * y11)


def _propagate(P, y0):
    """(..., n, 2): y0, then the inclusive prefix products P_i @ ... @ P_1 of
    the interval propagators ``P`` (a 4-tuple, intervals on the last axis)
    applied to ``y0``. The products come from a log-depth doubling scan
    (Hillis-Steele: at offset d, every i >= d takes cum_i @ cum_{i-d}), where
    the JAX package uses ``jax.lax.associative_scan``."""
    cum = list(torch.broadcast_tensors(*P))
    n = cum[0].shape[-1]
    d = 1
    while d < n:
        new = _mmul([c[..., d:] for c in cum], [c[..., :-d] for c in cum])
        cum = [torch.cat([c[..., :d], m], dim=-1) for c, m in zip(cum, new)]
        d *= 2
    y0 = torch.as_tensor(y0, dtype=cum[0].dtype, device=cum[0].device)
    ys = torch.stack([cum[0] * y0[0] + cum[1] * y0[1], cum[2] * y0[0] + cum[3] * y0[1]], dim=-1)
    first = y0.expand(ys.shape[:-2] + (1, 2))
    return torch.cat([first, ys], dim=-2)


def linear_ode2_rk4_prefix(coeffs_fun, y0, t):
    """Fixed-grid rk4 for the linear 2nd-order ODE y'' = s(t) y + f(t) y' on
    the 1D grid ``t`` (n,), returning (..., n, 2) with columns (y, y').

    ``coeffs_fun(t)`` returns (s, f) with the grid on the last axis. On the
    linear system Y' = A(t) Y, A = [[0, 1], [s, f]], one rk4 step is the
    linear map R = I + h/6 (K1 + 2 K2 + 2 K3 + K4) with K1 = A1,
    K2 = A2 (I + h/2 K1), K3 = A2 (I + h/2 K2), K4 = A3 (I + h K3), built for
    every interval at once and composed by :func:`_propagate`: the rk4
    recurrence up to the order of the products."""
    h = torch.diff(t)
    s_end, f_end = coeffs_fun(t)
    s_mid, f_mid = coeffs_fun((t[:-1] + t[1:]) / 2.0)

    def iplus(x, c):                                      # I + c x
        x00, x01, x10, x11 = x
        return (1.0 + c * x00, c * x01, c * x10, 1.0 + c * x11)

    A1 = (0.0, 1.0, s_end[..., :-1], f_end[..., :-1])
    A2 = (0.0, 1.0, s_mid, f_mid)
    A3 = (0.0, 1.0, s_end[..., 1:], f_end[..., 1:])
    K2 = _mmul(A2, iplus(A1, h / 2.0))
    K3 = _mmul(A2, iplus(K2, h / 2.0))
    K4 = _mmul(A3, iplus(K3, h))
    Ksum = tuple(k1 + 2.0 * k2 + 2.0 * k3 + k4 for k1, k2, k3, k4 in zip(A1, K2, K3, K4))
    return _propagate(iplus(Ksum, h / 6.0), y0)
