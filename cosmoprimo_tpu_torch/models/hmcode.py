"""HMcode-2020 (Mead et al. 2021, arXiv:2009.01858) non-linear matter power
spectrum (cosmoprimo_tpu/models/hmcode.py), batch-first.

Layouts as in models/halofit.py: P(k, z) tables are z-major (..., nz, nk),
per-z quantities (..., nz), the (R, z) blocks (..., nz, nR), the one-halo
profile tensor (..., nz, nk1h, nR); per-cosmology scalars are floats or
batch tensors. The splines in ln R take the knots on axis 0, so those
blocks are moved there for the solve and back after.

Physics (paper sections 2-3, fitted parameters from its Table 2):

- sigma^2(R, z) of the cold field with a tophat window, one matmul against
  the static (nk, nR) window;
- Sheth & Tormen (1999) mass function on a static ln R grid, with
  nu(R) = delta_c / sigma(R) and dnu/dlnR from the same spline;
- NFW profile in Fourier space through ops/special.sici, Bullock
  concentration from the formation redshift g(z_f) sigma(f M) = delta_c
  with the Dolag dark-energy correction, and the eta bloating exponent;
- two-halo term: the de-wiggled linear spectrum (EH98 no-wiggle shape,
  Gaussian smoothing of the ratio in ln k, damped by exp(-k^2 sigma_v^2))
  with the fitted damping f (k/kd)^nd / (1 + (k/kd)^nd);
- one-halo term damped by (k/k*)^4 / (1 + (k/k*)^4);
- transition Delta^2 = (D2h^alpha + D1h^alpha)^(1/alpha).

Collapse thresholds: the Mead (2017) fits (``collapse='mead2017'``, the
HMcode-2020 default) or Nakamura & Suto (1997) / Bryan & Norman (1998)
(``collapse='ns97'``), both with the HMcode-2020 neutrino multipliers.
Baryonic feedback (``logT_AGN``, ``non_linear='mead2020_feedback'``): the
T_AGN response of Mead et al. 2021 section 5, Table 5, with halo bloating off.
"""

import functools

import numpy as np
import torch

from ..constants import rho_crit_over_Msunph_per_Mpcph3
from ..interpolator import PowerSpectrumInterpolator2D, kernel_tophat2
from ..ops import (batch_scalar, cubic_eval, interp, linear_ode2_magnus, natural_cubic_coeffs, sici,
                   trapezoid_weights)
from .halofit import _geomspace, _grids, _matmul_static, _nonlinear_scale

#: The ``non_linear`` names that select HMcode-2020; the last adds feedback
HMCODE_NAMES = ('mead', 'hmcode', 'mead2020', 'hmcode2020', 'mead2020_feedback')

# Sheth & Tormen (1999) mass function parameters; A normalizes
# int f(nu) dnu = 1
_ST_p = 0.3
_ST_q = 0.707
_ST_A = 0.21615998645

# HMcode-2020 fitted parameters (Mead et al. 2021, Table 2)
_KSTAR_A, _KSTAR_P = 0.05618, -1.013    # one-halo damping k* [h/Mpc]
_F2H_A, _F2H_P = 0.2696, 0.9403         # two-halo damping amplitude
_KD_A, _KD_P = 0.05699, -1.089          # two-halo damping scale [h/Mpc]
_ND = 2.853                             # two-halo damping power
_B_MIN = 5.196                          # minimum Bullock concentration
_ETA_A, _ETA_P = 0.1281, -0.3644        # halo bloating exponent
_ALPHA_A, _ALPHA_B = 1.875, 1.603       # transition smoothing alpha
_FORM_FRAC = 0.01                       # Bullock formation mass fraction

# HMcode-2020 baryonic feedback (Mead et al. 2021, section 5, Table 5):
# every parameter is linear in theta = log10(T_AGN / K) - 7.8, with
# redshift dependence x(z) = x0 * 10^(z * xz)
_FB_B0, _FB_B_T = 3.44, -0.496          # concentration amplitude B(theta)
_FB_BZ0, _FB_BZ_T = -0.0671, -0.0371    # its 10^(z *) exponent
_FB_F0, _FB_F_T = 2.01e-2, -0.30e-2     # stellar halo mass fraction f*
_FB_FZ0, _FB_FZ_T = 0.409, 0.0224
_FB_MB0, _FB_MB_T = 13.87, 1.81         # log10 M_b [Msun/h] gas retention
_FB_MBZ0, _FB_MBZ_T = -0.108, 0.195
_FB_BETA = 2.0                          # gas-fraction transition power

# ideal (EdS) spherical-collapse values
_DC0 = (3.0 / 20.0) * (12.0 * np.pi) ** (2.0 / 3.0)
_DV0 = 18.0 * np.pi ** 2


def sigma_tophat2(k, pk_t, R):
    """Tophat variance sigma^2(R, z) = int dlnk Delta^2_L(k, z) W^2(kR):
    ``k`` (nk,), ``pk_t`` (..., nz, nk), ``R`` (nR,) -> (..., nz, nR); one
    matmul."""
    w = trapezoid_weights(torch.log(k))
    delta2_t = k ** 3 * pk_t / (2 * np.pi ** 2)
    window = kernel_tophat2(k[None, :] * R[:, None]) * w[None, :]   # (nR, nk)
    return _matmul_static(delta2_t, window.T)


def sigma_v2(k, pk_t):
    """1D displacement variance sigma_v^2 = (1/3) int dlnk Delta^2(k)/k^2:
    ``pk_t`` (..., nz, nk) -> (..., nz)."""
    w = trapezoid_weights(torch.log(k))
    delta2_t = k ** 3 * pk_t / (2 * np.pi ** 2)
    return (w * delta2_t / k ** 2).sum(dim=-1) / 3.0


def eh_nowiggle_shape(k_h, h, omega_m, omega_b, theta_cmb):
    """EH98 zero-baryon transfer shape (eqs. 26-31), the smooth reference of
    the de-wiggling: ``k_h`` (nk,) in h/Mpc, per-cosmology parameters ->
    (..., nk). Its normalization cancels in the smoothed ratio."""
    k = k_h * batch_scalar(h)  # 1/Mpc
    omega_m, omega_b, theta_cmb = batch_scalar(omega_m), batch_scalar(omega_b), batch_scalar(theta_cmb)
    frac_b = omega_b / omega_m
    s = 44.5 * torch.log(9.83 / omega_m) / torch.sqrt(1.0 + 10.0 * omega_b ** 0.75)  # Mpc
    alpha_gamma = (1.0 - 0.328 * torch.log(431.0 * omega_m) * frac_b
                   + 0.38 * torch.log(22.3 * omega_m) * frac_b ** 2)
    gamma_eff = omega_m * (alpha_gamma + (1 - alpha_gamma) / (1 + (0.43 * k * s) ** 4))
    q = k * theta_cmb ** 2 / gamma_eff
    L0 = torch.log(2 * np.e + 1.8 * q)
    C0 = 14.2 + 731.0 / (1 + 62.5 * q)
    return L0 / (L0 + C0 * q ** 2)


def dewiggle(k, pk_t, h, omega_m, omega_b, theta_cmb, ns, smooth_sigma=0.25):
    """No-wiggle linear spectrum (HMcode-2020 appendix A): Gaussian smoothing,
    of width ``smooth_sigma`` in ln k, of the ratio P / P_EHnw, times P_EHnw.
    ``pk_t`` (..., nz, nk) -> (..., nz, nk); the smoothing is one matmul
    against the static kernel."""
    lnk = torch.log(k)
    pk_eh = eh_nowiggle_shape(k, h, omega_m, omega_b, theta_cmb) ** 2 * k ** batch_scalar(ns)  # (..., nk)
    ratio_t = pk_t / pk_eh[..., None, :]
    # normalized Gaussian kernel matrix over the (static) ln k grid
    d = lnk[:, None] - lnk[None, :]
    G = torch.exp(-0.5 * (d / smooth_sigma) ** 2)
    G = G / G.sum(dim=1, keepdim=True)
    return _matmul_static(ratio_t, G.T) * pk_eh[..., None, :]


def nfw_window(krs, c):
    """Normalized NFW Fourier profile u(k | c) with y = k r_s (kr_v / c):

    u = [sin y (Si((1+c)y) - Si(y)) - sin(cy)/((1+c)y)
         + cos y (Ci((1+c)y) - Ci(y))] / [ln(1+c) - c/(1+c)];

    u -> 1 as k -> 0. All operands broadcast.
    """
    y = torch.clamp(krs, min=1e-8)
    si_y, ci_y = sici(y)
    si_cy, ci_cy = sici((1.0 + c) * y)
    norm = torch.log(1.0 + c) - c / (1.0 + c)
    return (torch.sin(y) * (si_cy - si_y) - torch.sin(c * y) / ((1.0 + c) * y)
            + torch.cos(y) * (ci_cy - ci_y)) / norm


def delta_c(Omega_mz, fnu=0.0):
    """Linear collapse threshold (Nakamura & Suto 1997) with the HMcode-2020
    neutrino multiplier (``collapse='ns97'``)."""
    return _DC0 * (1.0 + 0.0123 * torch.log10(Omega_mz)) * (1.0 + 0.262 * batch_scalar(fnu))


def Delta_v(Omega_mz, fnu=0.0):
    """Virial overdensity with respect to the mean matter density (Bryan &
    Norman 1998, flat) with the HMcode-2020 neutrino multiplier
    (``collapse='ns97'``)."""
    x = Omega_mz - 1.0
    return (18 * np.pi ** 2 + 82.0 * x - 39.0 * x ** 2) / Omega_mz * (1.0 + 0.916 * batch_scalar(fnu))


def _f_mead(x, y, p):
    """Mead (2017) Appendix-A basis f(x, y) = p0 + p1 (1-x) + p2 (1-x)^2
    + p3 (1-y), with x = g(a)/a and y = G(a)/a (both 1 in EdS)."""
    return p[0] + p[1] * (1.0 - x) + p[2] * (1.0 - x) ** 2 + p[3] * (1.0 - y)


def delta_c_mead(Omega_mz, g_ratio, G_ratio, fnu=0.0):
    """Linear collapse threshold of Mead (2017, arXiv:1606.05345, Table 2),
    the HMcode-2020 default, with the neutrino multiplier. ``g_ratio`` =
    g(a)/a, g normalized to g -> a early; ``G_ratio`` = G(a)/a with
    G(a) = int_0^a g dln a'."""
    lg = torch.log10(Omega_mz)
    f1 = _f_mead(g_ratio, G_ratio, (-0.0069, -0.0208, 0.0312, 0.0021))
    f2 = _f_mead(g_ratio, G_ratio, (0.0001, -0.0647, -0.0417, 0.0646))
    return _DC0 * (1.0 + f1 * lg + f2) * (1.0 + 0.262 * batch_scalar(fnu))


def Delta_v_mead(Omega_mz, g_ratio, G_ratio, fnu=0.0):
    """Virial overdensity of Mead (2017, Table 2), the HMcode-2020 default,
    with the neutrino multiplier; arguments as :func:`delta_c_mead`."""
    lg = torch.log10(Omega_mz)
    f1 = _f_mead(g_ratio, G_ratio, (-0.79, -10.17, 2.51, 6.51))
    f2 = _f_mead(g_ratio, G_ratio, (-1.89, 0.38, 18.8, -15.87))
    return _DV0 * (1.0 + f1 * lg + f2 * lg ** 2) * (1.0 + 0.916 * batch_scalar(fnu))


def mead_growth_ratios(z, Omega_m0, Omega_k0=0.0, w0=-1.0, wa=0.0, na=64, a_init=1e-4):
    """(g(a)/a, G(a)/a) at redshifts ``z`` (nz,) in the Mead (2017)
    convention, each (..., nz) for per-cosmology parameters of batch shape
    (...).

    The fits are calibrated on the radiation-free linear growth of matter,
    CPL dark energy and curvature, normalized to g -> a early; so g is
    solved from its own ODE in eta = ln a, through u = D/a:
    u'' = (1.5 Omega_m + f - 1) u + (f - 2) u' with f = -1 - addot,
    u(a_init) = 1, by the Magnus solver (ops/odeint.py). G(a) =
    int_0^a g dln a' is the cumulative trapezoid with the Euler-Maclaurin
    h^2/12 end correction (g' = a (u + u') from the same solution), closed
    below the grid by the matter-domination limit.
    """
    Ode0 = 1.0 - Omega_m0 - Omega_k0
    Omega_m0, Omega_k0, Ode0, w0, wa = (batch_scalar(v) for v in (Omega_m0, Omega_k0, Ode0, w0, wa))

    def coeffs(eta):
        a = torch.exp(eta)
        de = a ** (-3.0 * (1.0 + w0 + wa)) * torch.exp(-3.0 * wa * (1.0 - a))
        Esq = Omega_m0 * a ** -3 + Omega_k0 * a ** -2 + Ode0 * de
        Om = Omega_m0 * a ** -3 / Esq
        Ok = Omega_k0 * a ** -2 / Esq
        Ode = Ode0 * de / Esq
        w = w0 + wa * (1.0 - a)
        addot = -0.5 * (1.0 - Ok + 3.0 * w * Ode)   # no radiation term
        f = -1.0 - addot
        return 1.5 * Om + f - 1.0, f - 2.0

    eta_np = np.linspace(np.log(a_init), 0.0, na)
    eta = _linspace_log(a_init, na, z.device)
    sol = linear_ode2_magnus(coeffs, [1.0, 0.0], eta)   # (..., na, 2)
    a_tab = torch.exp(eta)
    u, up = sol[..., 0], sol[..., 1]
    g_tab = a_tab * u                                   # g(a) -> a early
    gp = a_tab * (u + up)                               # dg/deta
    h = eta_np[1] - eta_np[0]
    dG = 0.5 * (g_tab[..., 1:] + g_tab[..., :-1]) * h
    cumtrapz = torch.cat([torch.zeros_like(dG[..., :1]), torch.cumsum(dG, dim=-1)], dim=-1)
    G_tab = g_tab[..., :1] + cumtrapz - h ** 2 / 12.0 * (gp - gp[..., :1])
    az = 1.0 / (1.0 + z)
    # interpolate the slowly varying ratios u = g/a and G/a
    return interp(az, a_tab, u), interp(az, a_tab, G_tab / a_tab)


@functools.lru_cache(maxsize=None)
def _subgrid(nk, nk1h, device):
    """Indices of the one-halo k-subgrid, a static index tensor on ``device``."""
    return torch.from_numpy(np.unique(np.round(np.linspace(0, nk - 1, nk1h)).astype(np.int64))).to(device)


@functools.lru_cache(maxsize=None)
def _linspace_log(a_init, na, device):
    return torch.from_numpy(np.linspace(np.log(a_init), 0.0, na)).to(device)


def _st_f(nu):
    """Sheth-Tormen multiplicity f(nu), normalized to unit integral."""
    qnu2 = _ST_q * nu ** 2
    return _ST_A * (1.0 + qnu2 ** (-_ST_p)) * np.sqrt(2.0 * _ST_q / np.pi) * torch.exp(-qnu2 / 2.0)


def hmcode2020(k, pk_cb, pk_m, Omega_mz, fnu, omega_m, omega_b, h, theta_cmb, ns,
               growth_a, growth_g, growth_z, dolag_ratio=1.0, z=None,
               collapse='mead2017', logT_AGN=None, Omega_k0=0.0, w0=-1.0, wa=0.0,
               nR=64, Rrange=(5e-4, 5e1), nk_one_halo=32):
    """HMcode-2020 non-linear P(k, z), (..., nz, nk).

    ``k``: (nk,) in h/Mpc, log-spaced. ``pk_cb``, ``pk_m``: (..., nz, nk)
    linear cold and total-matter power in (Mpc/h)^3 (equal when f_nu = 0).
    ``Omega_mz``: (..., nz). ``fnu``, ``omega_m``, ``omega_b``, ``h``,
    ``theta_cmb``, ``ns``, ``dolag_ratio``, ``Omega_k0``, ``w0``, ``wa``:
    per-cosmology scalars. ``growth_a``: (na,) static, increasing;
    ``growth_g``: (..., na), the growth factor g(a), g(1) = 1, there;
    ``growth_z``: (..., nz) the growth factor at the table redshifts.
    ``z``: (nz,) table redshifts, needed by ``collapse='mead2017'`` (else
    ``'ns97'`` is used) and by the feedback. ``logT_AGN``: None for the
    dark-matter-only spectrum, else log10(T_AGN / K) of the
    mead2020_feedback response (published central value 7.8).
    """
    nk = k.shape[0]
    R = _geomspace(float(Rrange[0]), float(Rrange[1]), nR, k.device)
    lnR = torch.log(R)
    sig2 = sigma_tophat2(k, pk_cb, R)                     # (..., nz, nR)
    lnsig2 = torch.log(torch.clamp(sig2, min=1e-300))
    lnsig2_k = lnsig2.movedim(-1, 0)                      # (nR, ..., nz): knots first
    M2 = natural_cubic_coeffs(lnR, lnsig2_k)

    def spline(t, nu=0):                                  # (nt,) -> (..., nz, nt)
        return cubic_eval(lnR, lnsig2_k, M2, t, nu=nu).movedim(0, -1)

    if collapse == 'mead2017' and z is not None:
        g_ratio, G_ratio = mead_growth_ratios(z, omega_m / h ** 2, Omega_k0=Omega_k0, w0=w0, wa=wa)
        dc = delta_c_mead(Omega_mz, g_ratio, G_ratio, fnu)   # (..., nz)
        Dv = Delta_v_mead(Omega_mz, g_ratio, G_ratio, fnu)
    else:
        dc = delta_c(Omega_mz, fnu)
        Dv = Delta_v(Omega_mz, fnu)

    def col(a):
        return a[..., None]

    # sigma8_cb(z) for the fitted-parameter relations
    ln_s8sq = spline(torch.log(torch.full((1,), 8.0, dtype=k.dtype, device=k.device)))[..., 0]
    sigma8z = torch.exp(0.5 * ln_s8sq)

    # effective index at the collapse scale (same definition as halofit)
    _, neff, _ = _nonlinear_scale(lnR, lnsig2_k - 2.0 * torch.log(dc))

    kstar = _KSTAR_A * sigma8z ** _KSTAR_P
    f2h = _F2H_A * sigma8z ** _F2H_P
    kd = _KD_A * sigma8z ** _KD_P
    # halo bloating is part of the dark-matter-only calibration; the baryon
    # response recipe runs with eta = 0
    eta = _ETA_A * sigma8z ** _ETA_P if logT_AGN is None else torch.zeros_like(sigma8z)
    alpha = _ALPHA_A * _ALPHA_B ** neff

    # ---- two-halo: de-wiggled, damped linear total-matter spectrum
    pk_dw_base = dewiggle(k, pk_m, h, omega_m, omega_b, theta_cmb, ns)
    sv2 = sigma_v2(k, pk_m)                               # (..., nz)
    pk_dw = pk_dw_base + torch.exp(-(k ** 2) * col(sv2)) * (pk_m - pk_dw_base)
    kkd = (k / col(kd)) ** _ND
    k3 = k ** 3
    delta2_2h = (k3 / (2 * np.pi ** 2)) * pk_dw * (1.0 - col(f2h) * kkd / (1.0 + kkd))

    # ---- one-halo ingredients on the (z, R) grid
    sig = torch.sqrt(sig2)
    nu = col(dc) / sig                                    # (..., nz, nR)
    dlnsig2 = spline(lnR, nu=1)                           # dln sigma^2/dlnR
    dnu_dlnR = -0.5 * nu * dlnsig2                        # > 0
    # Bullock formation redshift: g(zf) = g(z) * dc / sigma(f^(1/3) R, z)
    sigf = torch.exp(0.5 * spline(lnR + np.log(_FORM_FRAC) / 3.0))
    g_needed = col(growth_z) * col(dc) / sigf             # (..., nz, nR)
    af = interp(g_needed, growth_g[..., None, :], growth_a)
    a_z = interp(growth_z, growth_g, growth_a)            # (..., nz)
    af = torch.minimum(af, col(a_z))                      # zf >= z
    if logT_AGN is None:
        B = _B_MIN
    else:
        if z is None:
            raise ValueError('mead2020_feedback needs the table redshifts: pass z=')
        theta = logT_AGN - 7.8
        B = col((_FB_B0 + _FB_B_T * theta) * 10.0 ** (z * (_FB_BZ0 + _FB_BZ_T * theta)))
    conc = B * (1.0 / af) * col(a_z) * batch_scalar(dolag_ratio, 2)  # B (1+zf)/(1+z)

    # halo scale radii: rv = R / Dv^(1/3), rs = rv / c
    rv = R / col(Dv) ** (1.0 / 3.0)                       # (..., nz, nR)
    # the one-halo term is smooth in k: the profile tensor runs on a coarse
    # k-subgrid and ln P_1h is splined back to the full grid
    isub = _subgrid(nk, min(nk_one_halo, nk), k.device)
    ksub = k[isub]
    # bloated profile argument: y = (nu^eta k) rv / c
    rvc = nu ** col(eta) * rv / conc                      # (..., nz, nR)
    krs = ksub[:, None] * rvc[..., None, :]               # (..., nz, nk1h, nR)
    u = nfw_window(krs, conc[..., None, :])

    # halo window in units of M/rho: (1 - f_nu) u for the matter-only
    # spectrum; with feedback CDM and bound gas trace NFW, stars are a
    # point mass and expelled gas leaves: (f_c + f_g(M)) u + f*
    if logT_AGN is None:
        win = (1.0 - batch_scalar(fnu, 3)) * u
    else:
        fb = omega_b / omega_m
        fstar = torch.minimum((_FB_F0 + _FB_F_T * theta) * 10.0 ** (z * (_FB_FZ0 + _FB_FZ_T * theta)),
                              torch.as_tensor(batch_scalar(fb), dtype=z.dtype, device=z.device))  # (..., nz)
        Mb = 10.0 ** (_FB_MB0 + _FB_MB_T * theta + z * (_FB_MBZ0 + _FB_MBZ_T * theta))  # (nz,) Msun/h
        # Lagrangian halo mass at comoving mean matter density, Msun/h
        M = (4.0 * np.pi / 3.0) * batch_scalar(rho_crit_over_Msunph_per_Mpcph3 * 1e10 * omega_m / h ** 2) * R ** 3
        fg = col(batch_scalar(fb) - fstar) / (1.0 + (col(Mb) / M[..., None, :]) ** _FB_BETA)  # (..., nz, nR)
        fc = 1.0 - fb - fnu
        win = (batch_scalar(fc, 2) + fg)[..., None, :] * u + fstar[..., None, None]

    # one-halo integral over lnR: P_1h = int dlnR dnu/dlnR f(nu) (M/rho) win^2
    dlnR = lnR[1] - lnR[0]
    w_int = dnu_dlnR * _st_f(nu) * (4.0 * np.pi / 3.0) * R ** 3 * dlnR          # (..., nz, nR)
    pk_1h_sub = (win ** 2 @ w_int[..., None])[..., 0]                            # (..., nz, nk1h)
    if isub.shape[0] < nk:
        lnk = torch.log(k)
        ln_p1h = torch.log(torch.clamp(pk_1h_sub, min=1e-300)).movedim(-1, 0)    # (nk1h, ..., nz)
        Mk = natural_cubic_coeffs(lnk[isub], ln_p1h)
        pk_1h = torch.exp(cubic_eval(lnk[isub], ln_p1h, Mk, lnk)).movedim(0, -1)  # (..., nz, nk)
    else:
        pk_1h = pk_1h_sub
    kks = (k / col(kstar)) ** 4
    delta2_1h = (k3 / (2 * np.pi ** 2)) * pk_1h * kks / (1.0 + kks)

    # ---- smoothed transition
    delta2 = (torch.clamp(delta2_2h, min=0.0) ** col(alpha) + delta2_1h ** col(alpha)) ** (1.0 / col(alpha))
    return delta2 * (2 * np.pi ** 2) / k3


def hmcode_pk_interpolator(pk2d_m, background, cosmo_params, pk2d_cb=None, **kwargs):
    """Non-linear HMcode-2020 PowerSpectrumInterpolator2D (a table on the
    grids of ``pk2d_m``) from the linear ones.

    ``background``: the section giving Omega_m(z) and the growth factor;
    ``cosmo_params``: dict of omega_m, omega_b, h, theta_cmb, n_s, fnu,
    Omega_k, w0_fld, wa_fld and optionally ``dolag_ratio``, ``collapse``
    and ``logT_AGN``. Without ``dolag_ratio``, the Dolag et al. (2004)
    correction (g_DE / g_LCDM)(z = 100) ** 1.5 is computed against the
    LambdaCDM analog of the background, built from its engine with
    w0 = -1 and wa = 0; it is exactly 1 for LambdaCDM.
    """
    k, z = _grids(pk2d_m)
    pk_m = pk2d_m(k, z, grid=True).transpose(-1, -2)             # (..., nz, nk)
    pk_cb = pk2d_cb(k, z, grid=True).transpose(-1, -2) if pk2d_cb is not None else pk_m
    a_grid = _geomspace(1e-3, 1.0, 128, k.device)
    growth_g = background.growth_factor(1.0 / a_grid - 1.0)
    growth_z = background.growth_factor(z)
    dolag_ratio = cosmo_params.get('dolag_ratio')
    if dolag_ratio is None:
        engine = background.engine
        lcdm = engine.clone(w0_fld=torch.full_like(engine['w0_fld'], -1.0),
                            wa_fld=torch.zeros_like(engine['wa_fld'])).get_background()
        zinf = 100.0
        dolag_ratio = (background.growth_factor(zinf) / lcdm.growth_factor(zinf)) ** 1.5
    pk_nl = hmcode2020(
        k, pk_cb, pk_m, background.Omega_m(z), fnu=cosmo_params.get('fnu', 0.0),
        omega_m=cosmo_params['omega_m'], omega_b=cosmo_params['omega_b'], h=cosmo_params['h'],
        theta_cmb=cosmo_params.get('theta_cmb', 1.0), ns=cosmo_params.get('n_s', 0.96),
        growth_a=a_grid, growth_g=growth_g, growth_z=growth_z, dolag_ratio=dolag_ratio, z=z,
        collapse=cosmo_params.get('collapse', 'mead2017'), logT_AGN=cosmo_params.get('logT_AGN'),
        Omega_k0=cosmo_params.get('Omega_k', 0.0), w0=cosmo_params.get('w0_fld', -1.0),
        wa=cosmo_params.get('wa_fld', 0.0))
    if z.shape[0] == 1:  # single-z table: flat in z
        kwargs.setdefault('growth_factor_sq', torch.ones_like)
    return PowerSpectrumInterpolator2D(pk2d_m.k, pk2d_m.z, pk_nl.transpose(-1, -2), extrap_kmin=pk2d_m.extrap_kmin,
                                       extrap_kmax=pk2d_m.extrap_kmax, **kwargs)
