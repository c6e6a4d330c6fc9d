"""Special functions (cosmoprimo_tpu/ops/special.py): ``loggamma`` and
``gamma`` of complex128 (or real) tensors, and the sine and cosine integrals
``sici`` for the NFW Fourier profiles of models/hmcode.py.

``loggamma`` is the Lanczos approximation (g = 607/128, 15 terms) with the
reflection formula on Re(z) < 1/2, continued on the principal branch as
scipy's: tensor arithmetic on any device, no host round trip.

The Chebyshev coefficient sets of ``sici`` are fitted once, when this module
is imported, from a numpy Si/Ci (series for x <= 4, continued fraction of
E1(ix) beyond), a copy of the JAX package's host code; :func:`sici` is
then pure float64 arithmetic on tensors, differentiable, on any device.
"""

import numpy as np
import torch

__all__ = ['loggamma', 'gamma', 'sici']

# Lanczos coefficients, g = 607/128, n = 15 (Boost / Godfrey): relative error
# below ~1e-15 over the right half-plane
_LANCZOS_G = 607.0 / 128.0
_LANCZOS_COEFFS = (
    0.99999999999999709182,
    57.156235665862923517,
    -59.597960355475491248,
    14.136097974741747174,
    -0.49191381609762019978,
    0.33994649984811888699e-4,
    0.46523628927048575665e-4,
    -0.98374475304879564677e-4,
    0.15808870322491248884e-3,
    -0.21026444172410488319e-3,
    0.21743961811521264320e-3,
    -0.16431810653676389022e-3,
    0.84418223983852743293e-4,
    -0.26190838401581408670e-4,
    0.36899182659531622704e-5,
)
_LOG_SQRT_2PI = 0.5 * np.log(2.0 * np.pi)


def _loggamma_right(z):
    """Lanczos log-gamma for Re(z) >= 1/2."""
    zm1 = z - 1.0
    series = torch.full_like(z, _LANCZOS_COEFFS[0])
    for i in range(1, len(_LANCZOS_COEFFS)):
        series = series + _LANCZOS_COEFFS[i] / (zm1 + i)
    t = zm1 + _LANCZOS_G + 0.5
    return _LOG_SQRT_2PI + (zm1 + 0.5) * torch.log(t) - t + torch.log(series)


def _logsinpi(z):
    """log(sin(pi z)), continued so that the reflection formula gives
    scipy's principal branch of loggamma (continuous off the real axis,
    conjugate-symmetric): sin(pi z) = (-1)^n sin(pi (z - n)), n = floor(Re z),
    with the (-1)^n unwound as -i pi n sign(Im z); for |Im z| >= 20 the
    asymptotic form, where sin(pi z) would overflow."""
    y = z.imag
    n = torch.floor(z.real)
    zr = z - n
    small = torch.abs(y) < 20.0
    direct = torch.log(torch.sin(np.pi * torch.where(small, zr, torch.full_like(zr, 0.5))))
    sgn = torch.where(y >= 0, torch.ones_like(y), -torch.ones_like(y))
    asym = -1j * np.pi * zr * sgn - np.log(2.0) + 1j * sgn * (np.pi / 2)
    return torch.where(small, direct, asym) - 1j * np.pi * n * sgn


def _loggamma_complex(z):
    reflect = z.real < 0.5
    lg_right = _loggamma_right(torch.where(reflect, 1.0 - z, z))   # Re >= 1/2 on both branches
    zr = torch.where(reflect, z, torch.full_like(z, 0.25))          # a harmless value where unused
    return torch.where(reflect, np.log(np.pi) - _logsinpi(zr) - lg_right, lg_right)


def _complex_tensor(z):
    z = torch.as_tensor(z)
    return z.to(torch.complex128) if not z.is_complex() else z


def loggamma(z):
    r"""Principal branch of :math:`\log \Gamma(z)`, complex128, for a complex
    or real tensor (or array) ``z`` on any device; matches
    ``scipy.special.loggamma`` to ~1e-13 away from the poles."""
    return _loggamma_complex(_complex_tensor(z))


def gamma(z):
    r""":math:`\Gamma(z)` through :func:`loggamma`: complex for a complex
    ``z``, float64 for a real one."""
    z = torch.as_tensor(z)
    if z.is_complex():
        return torch.exp(_loggamma_complex(z))
    return torch.exp(_loggamma_complex(z.to(torch.complex128))).real


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
