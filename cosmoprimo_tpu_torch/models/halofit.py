"""Halofit (Takahashi 2012, arXiv:1208.2701) non-linear matter power
spectrum with the Bird et al. 2012 massive-neutrino corrections
(cosmoprimo_tpu/models/halofit.py), batch-first.

Tables are z-major: a linear P(k, z) table is (..., nz, nk), k last, the
batch of cosmologies on the leading axes; it is the transpose of the JAX
package's per-cosmology (nk, nz). Per-z quantities are (..., nz), and a
per-cosmology scalar is a float or a batch tensor.

- sigma^2(R, z) = int dlnk Delta^2_L(k, z) e^{-k^2 R^2} on the whole
  (R, z) grid is one matmul against the static (nk, nR) Gaussian window,
  trapezoid weights folded in;
- the non-linear scale sigma(R_sigma) = 1 comes from 12 fixed Newton steps
  on the natural cubic spline of ln sigma^2(ln R), inside the one bracketed
  spline piece: no data-dependent control flow, so the transform batches
  and differentiates (reverse and forward mode);
- n_eff and C are the analytic first and second derivatives of that spline
  at the root.
"""

import functools

import numpy as np
import torch

from ..interpolator import PowerSpectrumInterpolator2D
from ..ops import batch_scalar, natural_cubic_coeffs, trapezoid_weights


def _matmul_static(a, m):
    """``a`` (..., n) times a static (n, p) matrix ``m`` as one 2D product,
    (prod(...), n) @ (n, p): a batched product of (1, n) rows would run as
    a batched matrix-vector kernel."""
    return (a.reshape(-1, a.shape[-1]) @ m).reshape(a.shape[:-1] + m.shape[-1:])


@functools.lru_cache(maxsize=None)
def _geomspace(lo, hi, num, device):
    """A static geometric grid on ``device``, copied there once."""
    return torch.from_numpy(np.geomspace(lo, hi, num=num)).to(device)


def sigma_gauss2(k, pk_t, R):
    """Gaussian-filtered variance sigma^2(R, z) = int dlnk Delta^2_L e^{-k^2R^2}.

    ``k``: (nk,), ``pk_t``: (..., nz, nk) linear P(k, z), ``R``: (nR,).
    Returns (..., nz, nR), as one matmul.
    """
    w = trapezoid_weights(torch.log(k))
    delta2_t = k ** 3 * pk_t / (2 * np.pi ** 2)                  # (..., nz, nk)
    window = torch.exp(-(k[None, :] * R[:, None]) ** 2) * w[None, :]  # (nR, nk)
    return _matmul_static(delta2_t, window.T)


def _nonlinear_scale(lnR, lnsig2, niter=12):
    """Root, slope and curvature of y(x) = ln sigma^2(ln R) at y = 0.

    ``lnR``: (nR,) increasing; ``lnsig2``: (nR, ...), decreasing in R (the
    knots on axis 0, as the splines of ops/spline.py take them). Returns
    (lnR_sigma, neff, C), each (...), with n_eff = -3 - y'(x*) and
    C = -y''(x*) (Smith et al. 2003). Fixed-depth Newton on the cubic
    piece of the bracket.
    """
    y = lnsig2
    M = natural_cubic_coeffs(lnR, y)
    # bracket: last index where y > 0 (y decreasing); the clamp keeps the
    # fully linear and fully collapsed columns inside the grid (the caller
    # masks them)
    i = torch.clamp(torch.sum(y > 0, dim=0) - 1, 0, lnR.shape[0] - 2)
    lo, hi = lnR[i], lnR[i + 1]

    def take(a, j):
        return torch.gather(a, 0, j.unsqueeze(0)).squeeze(0)

    y_lo, y_hi = take(y, i), take(y, i + 1)
    M_lo, M_hi = take(M, i), take(M, i + 1)
    h = hi - lo

    def piece(x, nu):
        dl, dr = x - lo, hi - x
        if nu == 0:
            return (M_lo * dr ** 3 / (6 * h) + M_hi * dl ** 3 / (6 * h)
                    + (y_lo / h - M_lo * h / 6) * dr + (y_hi / h - M_hi * h / 6) * dl)
        if nu == 1:
            return (-M_lo * dr ** 2 / (2 * h) + M_hi * dl ** 2 / (2 * h)
                    - (y_lo / h - M_lo * h / 6) + (y_hi / h - M_hi * h / 6))
        return (M_lo * dr + M_hi * dl) / h

    # secant initial guess inside the bracket
    x = lo + h * y_lo / torch.where(y_lo == y_hi, 1.0, y_lo - y_hi)
    for _ in range(niter):
        df = piece(x, 1)
        step = piece(x, 0) / torch.where(df == 0, 1.0, df)
        x = torch.minimum(torch.maximum(x - step, lo), hi)
    neff = -3.0 - piece(x, 1)
    C = -piece(x, 2)
    return x, neff, C


def halofit(k, pk_t, Omega_mz, Omega_dez, wz, fnu=0.0, Omega_m0=None, nR=128, Rrange=(1e-3, 1e3)):
    """Non-linear P(k, z) from the linear one (Takahashi 2012 eqs. 1-26 and
    the Bird 2012 neutrino corrections, as CAMB's halofit_takahashi).

    ``k``: (nk,) in h/Mpc; ``pk_t``: (..., nz, nk) linear power in
    (Mpc/h)^3; ``Omega_mz``, ``Omega_dez``, ``wz``: (..., nz) background
    quantities at the table redshifts; ``fnu``: Omega_ncdm / Omega_m today;
    ``Omega_m0``: Omega_m today (default: ``Omega_mz`` at the first z), used
    by the neutrino correction only. Returns (..., nz, nk).
    """
    if Omega_m0 is None:
        Omega_m0 = Omega_mz[..., 0]
    wz = wz.expand(Omega_mz.shape) if isinstance(wz, torch.Tensor) else wz

    R = _geomspace(float(Rrange[0]), float(Rrange[1]), nR, k.device)
    sig2 = sigma_gauss2(k, pk_t, R)                                  # (..., nz, nR)
    lnsig2 = torch.log(torch.clamp(sig2, min=1e-300))
    lnR_sigma, neff, C = _nonlinear_scale(torch.log(R), lnsig2.movedim(-1, 0))
    ksigma = torch.exp(-lnR_sigma)                                   # 1/R_sigma, (..., nz)
    # no non-linear scale on the grid (sigma^2 < 1 even at R_min): serve the
    # linear spectrum for that z (CAMB's 'no collapse' branch)
    collapsed = lnsig2[..., 0] > 0.0

    n, n2, n3, n4 = neff, neff ** 2, neff ** 3, neff ** 4
    w1 = 1.0 + wz
    fnu_z = batch_scalar(fnu)
    an = 10 ** (1.5222 + 2.8553 * n + 2.3706 * n2 + 0.9903 * n3 + 0.2250 * n4
                - 0.6038 * C + 0.1749 * Omega_dez * w1)
    bn = 10 ** (-0.5642 + 0.5864 * n + 0.5716 * n2 - 1.5474 * C + 0.2279 * Omega_dez * w1)
    cn = 10 ** (0.3698 + 2.0404 * n + 0.8161 * n2 + 0.5869 * C)
    gamma = 0.1971 - 0.0843 * n + 0.8460 * C
    alpha = torch.abs(6.0835 + 1.3373 * n - 0.1959 * n2 - 5.5274 * C)
    beta = (2.0379 - 0.7354 * n + 0.3157 * n2 + 1.2490 * n3 + 0.3980 * n4 - 0.1682 * C
            + fnu_z * (1.081 + 0.395 * n2))
    nu_h = 10 ** (5.2105 + 3.6902 * n)
    f1 = Omega_mz ** -0.0307
    f2 = Omega_mz ** -0.0585
    f3 = Omega_mz ** 0.0743

    def col(a):
        return a[..., None]

    fnu_zk = batch_scalar(fnu, 2)
    k3 = k ** 3
    delta2_lin = k3 * pk_t / (2 * np.pi ** 2)                        # (..., nz, nk)
    y = k / col(ksigma)
    fy = y / 4.0 + y ** 2 / 8.0

    # two-halo (quasi-linear) term, with the Bird 2012 small-scale linear boost
    delta2_q_lin = delta2_lin * (1.0 + fnu_zk * 47.48 * k ** 2 / (1.0 + 1.5 * k ** 2))
    delta2_q = delta2_lin * ((1.0 + delta2_q_lin) ** col(beta) / (1.0 + col(alpha) * delta2_q_lin)) * torch.exp(-fy)

    # one-halo term
    delta2_hp = (col(an) * y ** (3.0 * col(f1))
                 / (1.0 + col(bn) * y ** col(f2) + (col(cn * f3) * y) ** (3.0 - col(gamma))))
    delta2_h = delta2_hp / (1.0 + col(nu_h) / y ** 2)
    delta2_h = delta2_h * (1.0 + fnu_zk * (0.977 - 18.015 * (batch_scalar(Omega_m0, 2) - 0.3)))

    delta2_nl = delta2_q + delta2_h
    pk_nl_t = delta2_nl * (2 * np.pi ** 2) / k3
    return torch.where(col(collapsed), pk_nl_t, pk_t)


def _grids(pk2d):
    """The static (k, z) grids of ``pk2d`` as tensors on its device."""
    return tuple(torch.from_numpy(np.atleast_1d(grid)).to(pk2d.device) for grid in (pk2d.k, pk2d.z))


def halofit_pk_interpolator(pk2d, background, w0=-1.0, wa=0.0, fnu=0.0, **kwargs):
    """Non-linear PowerSpectrumInterpolator2D (a table on the grids of
    ``pk2d``) from the linear one ``pk2d``; ``background`` gives Omega_m(z)
    and Omega_de(z); ``w0``, ``wa``: CPL dark energy; ``fnu``: neutrino
    mass fraction."""
    k, z = _grids(pk2d)
    pk_lin = pk2d(k, z, grid=True)                                # (..., nk, nz)
    wz = batch_scalar(w0) + batch_scalar(wa) * z / (1.0 + z)
    pk_nl = halofit(k, pk_lin.transpose(-1, -2), background.Omega_m(z), background.Omega_de(z), wz, fnu=fnu,
                    Omega_m0=background.Omega_m(0.0))
    if z.shape[0] == 1:  # single-z table: flat in z
        kwargs.setdefault('growth_factor_sq', torch.ones_like)
    return PowerSpectrumInterpolator2D(pk2d.k, pk2d.z, pk_nl.transpose(-1, -2), extrap_kmin=pk2d.extrap_kmin,
                                       extrap_kmax=pk2d.extrap_kmax, **kwargs)
