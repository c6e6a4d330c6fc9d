"""Sine and cosine integrals (cosmoprimo_tpu/ops/special.py::sici), for the
NFW Fourier profiles of models/hmcode.py.

The Chebyshev coefficient sets are fitted once, when this module is
imported, from a numpy Si/Ci (series for x <= 4, continued fraction of
E1(ix) beyond), a copy of the JAX package's host code; :func:`sici` is
then pure float64 arithmetic on tensors, differentiable, on any device.
"""

import numpy as np
import torch

_EULER_GAMMA = 0.5772156649015328606


def _sici_numpy(x):
    """Host (numpy) Si/Ci — series for x <= 4, complex continued fraction of
    E1(ix) beyond — used only to fit the Chebyshev sets at import."""
    x = np.asarray(x, dtype=np.float64)
    si = np.empty_like(x)
    ci = np.empty_like(x)
    small = x <= 4.0
    xs = x[small]
    term = xs.copy()
    ssum = term.copy()
    cterm = np.ones_like(xs)
    cin = np.zeros_like(xs)
    for k in range(1, 24):
        term = term * (-xs * xs) * (2 * k - 1) / ((2 * k + 1) ** 2 * (2 * k))
        ssum += term
        cterm = cterm * (-xs * xs) / ((2 * k - 1) * (2 * k))
        cin += cterm / (2 * k)
    si[small] = ssum
    with np.errstate(divide='ignore'):
        ci[small] = _EULER_GAMMA + np.log(np.where(xs > 0, xs, 1.0)) + cin
    xl = x[~small]
    z = 1j * xl
    b = z + 1.0
    c = np.full_like(z, 1e30)
    d = 1.0 / b
    f = d.copy()
    for i in range(1, 64):
        a = -1.0 * i * i
        b = b + 2.0
        d = 1.0 / (a * d + b)
        c = b + a / c
        f = f * (c * d)
    e1 = np.exp(-z) * f
    si[~small] = np.pi / 2 + e1.imag
    ci[~small] = -e1.real
    return si, ci


def _chebfit(x, y, deg, lo, hi):
    t = (2.0 * x - (hi + lo)) / (hi - lo)
    return np.polynomial.chebyshev.chebfit(t, y, deg)


# Chebyshev coefficient sets (degree 20, ~1e-13 absolute):
# - Si(x) and Cin(x) on x in [0, 4]
# - x f(x) and x^2 g(x) on u = 4/x in [0.04, 1] (x in [4, 100]), where
#   Si = pi/2 - f cos - g sin, Ci = f sin - g cos; beyond x = 100 the
#   asymptotic series of f, g is exact to f64.
_SICI_DEG = 20
_xs_fit = np.linspace(1e-9, 4.0, 1601)
_si_fit, _ci_fit = _sici_numpy(_xs_fit)
_C_SI_S = _chebfit(_xs_fit, _si_fit, _SICI_DEG, 0.0, 4.0)
_C_CIN_S = _chebfit(_xs_fit, _ci_fit - (_EULER_GAMMA + np.log(_xs_fit)), _SICI_DEG, 0.0, 4.0)
_u_fit = np.linspace(0.04, 1.0, 2001)
_xl_fit = 4.0 / _u_fit
_si_l, _ci_l = _sici_numpy(_xl_fit)
_f_fit = np.cos(_xl_fit) * (np.pi / 2 - _si_l) + np.sin(_xl_fit) * _ci_l
_g_fit = np.sin(_xl_fit) * (np.pi / 2 - _si_l) - np.cos(_xl_fit) * _ci_l
_C_XF = _chebfit(_u_fit, _xl_fit * _f_fit, _SICI_DEG, 0.04, 1.0)
_C_XG = _chebfit(_u_fit, _xl_fit ** 2 * _g_fit, _SICI_DEG, 0.04, 1.0)
del _xs_fit, _si_fit, _ci_fit, _u_fit, _xl_fit, _si_l, _ci_l, _f_fit, _g_fit


def _clenshaw(t, coeffs):
    """Chebyshev series at ``t`` by the Clenshaw recurrence, unrolled."""
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    t2 = 2.0 * t
    for c in coeffs[:0:-1]:
        b1, b2 = t2 * b1 - b2 + float(c), b1
    return t * b1 - b2 + float(coeffs[0])


def sici(x):
    r"""Sine and cosine integrals Si(x), Ci(x) for a float64 tensor x > 0;
    matches ``scipy.special.sici`` to ~1e-13.

    Degree-20 Chebyshev fits of (Si, Cin) on [0, 4] and of the smooth
    auxiliaries (x f, x^2 g) on [4, 100], the exact asymptotic series
    beyond: no table lookups, no data-dependent control flow.
    """
    small = x <= 4.0
    mid = (x > 4.0) & (x <= 100.0)

    # [0, 4]
    xs = torch.where(small, x, 4.0)
    ts = (2.0 * xs - 4.0) / 4.0
    si_s = _clenshaw(ts, _C_SI_S)
    ci_s = _EULER_GAMMA + torch.log(torch.where(x > 0, xs, 1.0)) + _clenshaw(ts, _C_CIN_S)

    # (4, 100]: Chebyshev in u = 4/x; beyond: asymptotic series
    xl = torch.where(small, 8.0, x)
    u = 4.0 / xl
    tl = (2.0 * torch.clamp(u, 0.04, 1.0) - 1.04) / 0.96
    xf_c = _clenshaw(tl, _C_XF)
    xg_c = _clenshaw(tl, _C_XG)
    inv2 = 1.0 / (xl * xl)
    xf_a = 1.0 + inv2 * (-2.0 + inv2 * (24.0 + inv2 * (-720.0 + inv2 * 40320.0)))
    xg_a = 1.0 + inv2 * (-6.0 + inv2 * (120.0 + inv2 * (-5040.0 + inv2 * 362880.0)))
    xf = torch.where(mid, xf_c, xf_a)
    xg = torch.where(mid, xg_c, xg_a)
    f = xf / xl
    g = xg * inv2
    cx, sx = torch.cos(xl), torch.sin(xl)
    si_l = np.pi / 2 - f * cx - g * sx
    ci_l = f * sx - g * cx

    return torch.where(small, si_s, si_l), torch.where(small, ci_s, ci_l)
