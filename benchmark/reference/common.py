"""Plain NumPy/SciPy physics shared by the benchmark's references.

An implementation of the published formulae, written for this benchmark and
kept apart from the program under test: it imports neither ``jax`` nor
``cosmoprimo_tpu`` nor ``cosmoprimo_tpu_torch``, and it takes nothing the
program made. Every function works on one batch of cosmologies at a time,
the batch on axis 0, in the precision ``dtype`` (float64 is the reference;
float32 is the control that has to fail the comparison). Constants are
Python floats, so that they take the precision of the arrays they meet.

What it follows (the conventions of cosmoprimo, which the program ports):

- the background: photons, massless neutrinos (N_ur from N_eff), massive
  neutrinos (frozen Fermi-Dirac, 100-point Gauss-Laguerre, tabulated on a
  fixed z grid and splined), cold matter and a cosmological constant closing
  a flat universe; the comoving radial distance as the cumulative Simpson
  rule with midpoints on a fixed z grid, splined;
- Eisenstein & Hu (1998, astro-ph/9709112) eqs. 2-24 with the drag redshift
  of Hu & Sugiyama (1996, eq. E1), the no-wiggle form eqs. 28-31, and the
  growth of Carroll, Press & Turner (1992, eq. 29), unnormalised, as the
  EH98 engine's growth factor;
- FFTLog (Hamilton 2000) with the low-ringing output grid, the input padded
  to twice its length with zeros;
- natural cubic splines (scipy's ``CubicSpline(bc_type='natural')``).
"""

import math

import numpy as np
from scipy.interpolate import CubicSpline
from scipy.special import loggamma

# CODATA 2018 and IAU 2015 values, SI
C = 299792458.0
G = 6.6743e-11
KB = 1.380649e-23
SIGMA_SB = 5.670374419184429e-08
PARSEC = 3.085677581491367e+16
EV = 1.602176634e-19
MPC = 1e6 * PARSEC
MSUN = 1.98847e30
RHO_CRIT_KG = 3.0 * (1e5 / MPC) ** 2 / (8 * math.pi * G)          # kg/m^3 per h^2
RHO_CRIT_MSUN = RHO_CRIT_KG / (1e10 * MSUN) * MPC ** 3             # 1e10 Msun/h / (Mpc/h)^3
# CLASS conventions
T_CMB = 2.7255
T_NCDM_OVER_CMB = 0.71611
N_EFF = 3.044
K_PIVOT = 0.05                                                      # 1/Mpc
C_KMS = C / 1e3

# fixed z grids of the tabulated background quantities
Z_NCDM = np.concatenate([np.linspace(0.0, 1.0, 20)[:-1], 1.0 / np.geomspace(1e-8, 0.5, 100)[::-1] - 1.0])
Z_CHI = np.concatenate([np.linspace(0.0, 0.3, 20)[:-1], 1.0 / np.geomspace(1e-4, 1.0 / 1.3, 100)[::-1] - 1.0])


def natural_spline(x, y, axis=0):
    """The natural cubic spline through (x, y) along ``axis``, extrapolated
    with its edge cubics."""
    return CubicSpline(x, y, axis=axis, bc_type='natural', extrapolate=True)


def ncdm_momenta(T_eff, m, z, out, dtype):
    """Energy density ('rho') or pressure ('p') of one massive-neutrino
    species of mass ``m`` (n,) eV and temperature ``T_eff`` K today, at
    ``z`` (nz,): (n, nz) in 1e10 Msun / Mpc^3 (physical)."""
    q, w = (a.astype(dtype) for a in np.polynomial.laguerre.laggauss(100))
    T_a = T_eff * (1.0 + z.astype(dtype))
    over_T = EV / (KB * T_a)
    eps = np.sqrt(q ** 2 + ((m[:, None] * over_T) ** 2)[..., None])
    fd = 1.0 / (1.0 + np.exp(-q))             # Laguerre weights carry e^-q
    integ = q ** 2 * eps * fd if out == 'rho' else (1.0 / 3.0) * q ** 4 / eps * fd
    prefactor = 7.0 / 8.0 * 4.0 / C ** 3 * SIGMA_SB / (7.0 * math.pi ** 4 / 120.0) / (1e10 * MSUN) * MPC ** 3
    return prefactor * T_a ** 4 * np.sum(integ * w, axis=-1)


class Background:
    """Flat LCDM background of a batch: ``omega_cdm``, ``omega_b``, ``h``
    (n,), massive species ``m_ncdm`` (a list of (n,) masses in eV) and
    ``N_eff``."""

    def __init__(self, omega_cdm, omega_b, h, m_ncdm=(), N_eff=N_EFF, dtype=np.float64):
        self.dtype = dtype
        self.h = np.asarray(h, dtype)
        self.omega_cdm, self.omega_b = np.asarray(omega_cdm, dtype), np.asarray(omega_b, dtype)
        h2 = self.h ** 2
        self.Omega_cdm, self.Omega_b = self.omega_cdm / h2, self.omega_b / h2
        self.m_ncdm = [np.asarray(m, dtype) for m in m_ncdm]
        N_ur = N_eff - len(self.m_ncdm) * T_NCDM_OVER_CMB ** 4 * (4.0 / 11.0) ** (-4.0 / 3.0)
        rho_g = T_CMB ** 4 * 4.0 / C ** 3 * SIGMA_SB
        self.Omega_g = rho_g / (h2 * RHO_CRIT_KG)
        self.Omega_ur = N_ur * 7.0 / 8.0 * (4.0 / 11.0) ** (4.0 / 3.0) * rho_g / (h2 * RHO_CRIT_KG)
        zero = np.zeros(1, dtype)
        self.Omega_ncdm = sum((self._ncdm(m, zero, 'rho')[:, 0] for m in self.m_ncdm), 0.0) / RHO_CRIT_MSUN
        self.Omega_pncdm = 3.0 * sum((self._ncdm(m, zero, 'p')[:, 0] for m in self.m_ncdm), 0.0) / RHO_CRIT_MSUN
        self.Omega_m = self.Omega_b + self.Omega_cdm + self.Omega_ncdm - self.Omega_pncdm
        self.Omega_de = 1.0 - (self.Omega_cdm + self.Omega_b + self.Omega_g + self.Omega_ur + self.Omega_ncdm)
        # the massive species' density and pressure, tabulated and splined in z
        z = Z_NCDM.astype(dtype)
        self._tables = {out: [natural_spline(z, self._ncdm(m, z, out), axis=1) for m in self.m_ncdm]
                        for out in ('rho', 'p')}

    def _ncdm(self, m, z, out):
        """Comoving density or pressure of one species, 1e10 Msun/h / (Mpc/h)^3."""
        value = ncdm_momenta(T_CMB * T_NCDM_OVER_CMB, m, z, out, self.dtype)
        return value / (1.0 + z) ** 3 / self.h[:, None] ** 2

    def _ncdm_tot(self, out, z):
        z = np.asarray(z, self.dtype)
        total = np.zeros((self.h.shape[0], z.shape[0]), self.dtype)
        for spline in self._tables[out]:
            total = total + spline(z).astype(self.dtype)
        return total

    def _densities(self, z):
        """(rho_m, rho_tot) at ``z``, comoving, (n, nz)."""
        z = np.asarray(z, self.dtype)
        rc = RHO_CRIT_MSUN
        rho_cb = (self.Omega_cdm + self.Omega_b)[:, None] * rc * np.ones_like(z)
        rho_ncdm, p_ncdm = self._ncdm_tot('rho', z), self._ncdm_tot('p', z)
        rho_r = (self.Omega_g + self.Omega_ur)[:, None] * (1.0 + z) * rc
        rho_de = self.Omega_de[:, None] * (1.0 + z) ** -3.0 * rc
        return rho_cb + rho_ncdm - 3.0 * p_ncdm, rho_cb + rho_ncdm + rho_r + rho_de

    def efunc(self, z):
        """H(z) / H0: (n, nz)."""
        z = np.asarray(z, self.dtype)
        _, rho_tot = self._densities(z)
        return np.sqrt(rho_tot * (1.0 + z) ** 3 / RHO_CRIT_MSUN)

    def Omega_m_z(self, z):
        rho_m, rho_tot = self._densities(z)
        return rho_m / rho_tot

    def Omega_de_z(self, z):
        z = np.asarray(z, self.dtype)
        _, rho_tot = self._densities(z)
        return self.Omega_de[:, None] * (1.0 + z) ** -3.0 * RHO_CRIT_MSUN / rho_tot

    def growth(self, z):
        """Carroll, Press & Turner (1992) eq. 29, unnormalised: (n, nz)."""
        z = np.asarray(z, self.dtype)
        Om, Ode = self.Omega_m_z(z), self.Omega_de_z(z)
        return 1.0 / (1.0 + z) * 5.0 * Om / 2.0 / (Om ** (4.0 / 7.0) - Ode + (1.0 + Om / 2.0) * (1.0 + Ode / 70.0))

    def comoving_radial_distance(self, z):
        """Mpc/h at ``z`` (nz,): (n, nz). The cumulative Simpson rule with
        midpoints on Z_CHI, splined."""
        zc = Z_CHI.astype(self.dtype)
        mid = (zc[:-1] + zc[1:]) / 2.0
        f_ends = C_KMS / (100.0 * self.efunc(zc))
        f_mid = C_KMS / (100.0 * self.efunc(mid))
        inc = np.diff(zc) / 6.0 * (f_ends[:, :-1] + 4.0 * f_mid + f_ends[:, 1:])
        chi = np.concatenate([np.zeros_like(inc[:, :1]), np.cumsum(inc, axis=-1)], axis=-1)
        return natural_spline(zc, chi, axis=1)(np.asarray(z, self.dtype)).astype(self.dtype)


class EH98:
    """Eisenstein & Hu (1998) transfer functions of a batch: the physical
    densities ``omega_cdm``, ``omega_b`` and ``h`` (n,), T_cmb = T_CMB. The
    matter density of the fit is cdm + baryons."""

    def __init__(self, omega_cdm, omega_b, h, dtype=np.float64):
        self.h = np.asarray(h, dtype)
        ob = np.asarray(omega_b, dtype)
        om = np.asarray(omega_cdm, dtype) + ob
        th = T_CMB / 2.7
        self.omega_m, self.frac_b, self.theta_cmb = om, ob / om, th
        fb = self.frac_b
        z_eq = 2.5e4 * om * th ** -4 - 1.0                                       # eq. 2
        self.k_eq = 0.0746 * om * th ** -2                                        # eq. 3, 1/Mpc
        b1 = 0.313 * om ** -0.419 * (1.0 + 0.607 * om ** 0.674)                  # HS96 eq. E1
        b2 = 0.238 * om ** 0.223
        self.z_drag = 1345.0 * om ** 0.251 / (1.0 + 0.659 * om ** 0.828) * (1.0 + b1 * ob ** b2)
        r_drag = 31.5 * ob * th ** -4 * (1000.0 / (1.0 + self.z_drag))         # eq. 5
        r_eq = 31.5 * ob * th ** -4 * (1000.0 / (1.0 + z_eq))
        self.rs_drag = (2.0 / (3.0 * self.k_eq) * np.sqrt(6.0 / r_eq)            # eq. 6, Mpc
                        * np.log((np.sqrt(1.0 + r_drag) + np.sqrt(r_drag + r_eq)) / (1.0 + np.sqrt(r_eq))))
        self.k_silk = 1.6 * ob ** 0.52 * om ** 0.73 * (1.0 + (10.4 * om) ** -0.95)   # eq. 7
        a1 = (46.9 * om) ** 0.670 * (1.0 + (32.1 * om) ** -0.532)               # eq. 11
        a2 = (12.0 * om) ** 0.424 * (1.0 + (45.0 * om) ** -0.582)
        self.alpha_c = a1 ** -fb * a2 ** -(fb ** 3)
        bc1 = 0.944 / (1.0 + (458.0 * om) ** -0.708)                             # eq. 12
        bc2 = 0.395 * om ** -0.0266
        self.beta_c = 1.0 / (1.0 + bc1 * ((1.0 - fb) ** bc2) - 1.0)
        y = (1.0 + z_eq) / (1.0 + self.z_drag)                                   # eqs. 14-15
        Gy = y * (-6.0 * np.sqrt(1.0 + y) + (2.0 + 3.0 * y) * np.log((np.sqrt(1.0 + y) + 1.0) / (np.sqrt(1.0 + y) - 1.0)))
        self.alpha_b = 2.07 * self.k_eq * self.rs_drag * (1.0 + r_drag) ** -0.75 * Gy
        self.beta_node = 8.41 * om ** 0.435                                       # eq. 23
        self.beta_b = 0.5 + fb + (3.0 - 2.0 * fb) * np.sqrt((17.2 * om) ** 2 + 1.0)   # eq. 24
        self.alpha_gamma = (1.0 - 0.328 * np.log(431.0 * om) * fb                  # eq. 31
                            + 0.38 * np.log(22.3 * om) * fb ** 2)

    def _col(self, name):
        return getattr(self, name)[:, None]

    def transfer(self, k):
        """The wiggly matter transfer function at ``k`` (nk,) h/Mpc: (n, nk)."""
        k = k[None, :] * self.h[:, None]                                          # 1/Mpc
        k_eq, rs, alpha_c, beta_c = (self._col(n) for n in ('k_eq', 'rs_drag', 'alpha_c', 'beta_c'))
        q = k / (13.41 * k_eq)
        ks = k * rs
        ln_beta = np.log(math.e + 1.8 * beta_c * q)
        ln_nobeta = np.log(math.e + 1.8 * q)
        C_alpha = 14.2 / alpha_c + 386.0 / (1.0 + 69.9 * q ** 1.08)
        C_noalpha = 14.2 + 386.0 / (1.0 + 69.9 * q ** 1.08)

        def T0(a, b):
            return a / (a + b * q ** 2)

        f = 1.0 / (1.0 + (ks / 5.4) ** 4)                                         # eqs. 17-18
        T_c = f * T0(ln_beta, C_noalpha) + (1.0 - f) * T0(ln_beta, C_alpha)
        s_tilde = rs * (1.0 + (self._col('beta_node') / ks) ** 3) ** (-1.0 / 3.0)   # eqs. 21-22
        T_b1 = T0(ln_nobeta, C_noalpha) / (1.0 + (ks / 5.2) ** 2)
        T_b2 = self._col('alpha_b') / (1.0 + (self._col('beta_b') / ks) ** 3) * np.exp(-(k / self._col('k_silk')) ** 1.4)
        x = k * s_tilde
        T_b = np.sin(x) / x * (T_b1 + T_b2)
        fb = self._col('frac_b')
        return fb * T_b + (1.0 - fb) * T_c                                        # eq. 16

    def transfer_nowiggle(self, k):
        """The zero-baryon transfer function (eqs. 28-31): (n, nk)."""
        k = k[None, :] * self.h[:, None]
        ks = k * self._col('rs_drag')
        ag, om = self._col('alpha_gamma'), self._col('omega_m')
        gamma_eff = om * (ag + (1.0 - ag) / (1.0 + (0.43 * ks) ** 4))
        q = k * self.theta_cmb ** 2 / gamma_eff
        L0 = np.log(2.0 * math.e + 1.8 * q)
        C0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
        return L0 / (L0 + C0 * q ** 2)


def linear_pk(transfer, background, A_s, n_s, k):
    """The linear matter P(k) in (Mpc/h)^3 at unit growth, from the transfer
    function (n, nk) at ``k`` (nk,) h/Mpc: curvature -> potential -> density."""
    h = background.h[:, None]
    kk = k[None, :]
    potential_to_density = (3.0 * background.Omega_m[:, None] * 100.0 ** 2 / (2.0 * C_KMS ** 2 * kk ** 2)) ** -2.0
    curvature_to_potential = 9.0 / 25.0 * 2.0 * math.pi ** 2 / kk ** 3 / h ** 3
    primordial = h ** 3 * A_s[:, None] * (kk / (K_PIVOT / h)) ** (n_s[:, None] - 1.0)
    return transfer ** 2 * potential_to_density * curvature_to_potential * primordial


def tophat2(x):
    """The squared 3D tophat window W^2(x), its Maclaurin series below 0.1."""
    x2 = x ** 2
    low = 1.0 + x2 * (-1.0 / 10.0 + x2 * (1.0 / 280.0 + x2 * (-1.0 / 15120.0 + x2 * (1.0 / 1330560.0
                                                                                  + x2 * (-1.0 / 172972800.0)))))
    safe = np.where(x < 0.1, 1.0, x).astype(x.dtype)
    high = 3.0 * (np.sin(safe) - safe * np.cos(safe)) / safe ** 3
    return np.where(x < 0.1, low, high) ** 2


def simpson_avg(y, x):
    """Composite Simpson rule along the last axis for a 1D grid ``x``; for an
    even number of samples the mean of Simpson on the first N-1 samples plus
    a trapezoid on the last interval, and of the mirror of that (the classic
    'avg' rule)."""
    n = y.shape[-1]

    def basic(start, stop):
        h = np.diff(x)
        h0, h1 = h[start:stop:2], h[start + 1:stop + 1:2]
        y0, y1, y2 = y[..., start:stop:2], y[..., start + 1:stop + 1:2], y[..., start + 2:stop + 2:2]
        hsum, hprod, ratio = h0 + h1, h0 * h1, h0 / h1
        return np.sum(hsum / 6.0 * (y0 * (2.0 - 1.0 / ratio) + y1 * hsum * hsum / hprod + y2 * (2.0 - ratio)), axis=-1)

    if n % 2:
        return basic(0, n - 2)
    first = basic(0, n - 3) + 0.5 * (x[-1] - x[-2]) * (y[..., -1] + y[..., -2])
    last = basic(1, n - 2) + 0.5 * (x[1] - x[0]) * (y[..., 1] + y[..., 0])
    return (first + last) / 2.0


class PowerToCorrelation:
    """FFTLog xi(s) = 1/(2 pi^2) int dk k^2 P(k) j_0(ks) on the log grid ``k``
    (Hamilton 2000): the Mellin coefficients of j_0 at q = 1.5, the
    low-ringing output grid, the input zero-padded to the next power of two
    at least twice its length, centred."""

    def __init__(self, k, dtype=np.float64):
        k = np.asarray(k, np.float64)
        size = k.size
        self.dtype = dtype
        q = 1.5
        delta = math.log(k[-1] / k[0]) / (size - 1)
        n = 2 ** (2 * size - 1).bit_length()
        npad = n - size
        self.n, self.left, self.size = n, npad // 2, size

        def mellin(z):   # of the spherical Bessel j_0
            return np.exp(math.log(2.0) * (z - 1.5) + loggamma(0.5 * z) - loggamma(0.5 * (3.0 - z)))

        lnxy = delta / math.pi * np.angle(mellin(q + 1j * math.pi / delta))
        self.s = np.exp(lnxy - delta) / k[::-1]

        def padded(x, left, right):
            lo = x[0] * (x[1] / x[0]) ** np.arange(-left, 0)
            hi = x[-1] / (x[-2] / x[-1]) ** np.arange(1, right + 1)
            return np.concatenate([lo, x, hi])

        kp = padded(k, npad // 2, npad - npad // 2)
        sp = padded(self.s, npad - npad // 2, npad // 2)
        m = np.arange(n // 2 + 1)
        u = mellin(q + 2j * math.pi / n / delta * m) * np.exp(-2j * math.pi * lnxy / n / delta * m)
        cdtype = np.complex64 if dtype == np.float32 else np.complex128
        self.u = u.astype(cdtype)
        self.pre = (kp ** -q * kp ** 3 / (2.0 * math.pi) ** 1.5).astype(dtype)
        self.post = (sp ** -q).astype(dtype)
        self.s_out_left = npad - npad // 2

    def __call__(self, pk):
        """xi of the rows ``pk`` (..., nk): (..., ns)."""
        pk = np.asarray(pk, self.dtype)
        f = np.zeros(pk.shape[:-1] + (self.n,), self.dtype)
        f[..., self.left:self.left + self.size] = pk
        t = np.fft.irfft(np.conj(np.fft.rfft(f * self.pre, axis=-1) * self.u), n=self.n, axis=-1) * self.post
        return t[..., self.s_out_left:self.s_out_left + self.size].astype(self.dtype)


def linspace_rows(start, stop, num):
    """``num`` points from ``start`` to ``stop`` (n,) for each row: (n, num),
    the last point ``stop`` exactly."""
    t = np.arange(num) / max(num - 1, 1)
    out = start[:, None] * (1.0 - t) + stop[:, None] * t
    if num > 1:
        out[:, -1] = stop
    return out
