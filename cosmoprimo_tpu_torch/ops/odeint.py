"""Cumulative quadrature on a fixed grid (cosmoprimo_tpu/ops/odeint.py::cumquad_rk4)."""

import torch


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
