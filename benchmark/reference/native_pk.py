"""Plain reference of the ``native_pk`` configuration: the linear P(k, z) of
total matter and of cold dark matter plus baryons, from a batch of flat
LCDM cosmologies with one massive neutrino, by a direct integration of the
Einstein-Boltzmann equations, on the emulator's (k, z) grid; and the
recombination scalars z_star, z_drag and rs_drag.

Plain PyTorch in eager mode: no CUDA graph, no step loop, no kernel. It
imports neither ``jax`` nor ``cosmoprimo_tpu`` nor ``cosmoprimo_tpu_torch``
and takes nothing the program made. The background and the recombination
scan (a few rows, small operations) run on the CPU; the perturbations'
lanes run on the card where one is present, else on the CPU. All in the
precision ``dtype`` (float64 is the reference; float32 is the control that
has to fail the comparison).

What it integrates, and by which scheme (the scheme the program documents,
after CLASS, arXiv:1104.2932, and RECFAST):

- the background: photons, massless neutrinos (N_ur), one massive neutrino
  (frozen Fermi-Dirac; its density by 100-point Gauss-Laguerre quadrature,
  tabulated on a fixed z grid and splined in z), cold matter, baryons and a
  cosmological constant closing a flat universe;
- the recombination history on the static grid of 6144 steps uniform in
  ln a from a = 1e-8: hydrogen by the effective three-level atom (Peebles
  1968, the RECFAST 1.14 fudge), HeI by the singlet-channel ODE (Seager et
  al. 2000; Wong, Moss & Scott 2008), both Crank-Nicolson with three Newton
  steps (derivatives in closed form) after Saha while the Saha fraction
  exceeds 0.985 (hydrogen) or 0.99 (HeII); HeIII by Saha; the matter
  temperature Compton-coupled, Crank-Nicolson, on its attractor where the
  coupling exceeds 50 Hubble rates; the tanh reionization of CAMB with
  z_reio found by bisection for tau_reio; z_star and z_drag where the
  optical and drag depths cross 1 (linear in ln a against -ln tau, z > 50);
  rs_drag the sound horizon at z_drag (CAMB's integrand) by Gauss-Legendre
  quadrature in ln a;
- the perturbations, Ma & Bertschinger (1995, arXiv:astro-ph/9506072) in
  the conformal Newtonian gauge, each (cosmology, k) a lane: photon
  temperature and polarization to l = 11, massless neutrinos to l = 17, the
  massive neutrino in 5 Gauss-Laguerre momentum bins to l = 8, with the MB95
  closures; coefficient tables resampled on a uniform ln(eta) grid (rows
  1-9 stored as logarithms, linear between knots); per-lane step grids
  uniform in the integrated step density max(k/0.5, 1/(0.004 eta),
  kappa'/1.26 outside tight coupling); the adiabatic initial conditions of
  MB95 eq. 98 (comoving curvature R = 1); phase A (the full hierarchy) by
  RK4 from the start to k eta = 45 (not past the switch, as exact
  arithmetic decides), with, after each step, the exact (ETD) Thomson drag
  outside tight coupling, the first-order tight-coupling slaving where
  kappa' > max(120 aH, 50 k), phi pinned to the Poisson constraint where
  k > 2.5 aH and the massless neutrinos on their radiation-streaming values
  past k eta = 45; then the massive neutrino collapsed to a viscous fluid
  and phase B (radiation streaming) by RK4 to today, the neutrino fluid
  held on its quasi-static values (sigma = 0, delta' = theta' = 0) at the
  points of the steps that turn its fastest wave by more than 2 sqrt 2
  radians, past RK4's stability (a light neutrino at high k); the transfers read
  at each output redshift by linear blending inside the step that holds it,
  shifted to the CDM-comoving synchronous gauge;
- the power-law primordial spectrum (comoving curvature, k_pivot = 0.05
  /Mpc);
- the P(k, z) table splined as a natural bicubic in (log10 k, z) of
  log10 P, with two knots continuing each edge's power law to 1e-7 and
  1e2 h/Mpc, evaluated on the emulator's grid.

Departures from the program, all below the comparison's limits: rs_drag is Gauss-Legendre where the program
takes Romberg's rule with a stopping tolerance of 1e-7, whose last
extrapolation lands far inside it (the two agree to ~1e-13 on massless,
light and heavy rows alike); z_reio is bisected to the last bit where the
program stops at 1e-8; cumulative sums are torch's running sums where the
program sums in blocks of 16; the bicubic is evaluated z first, then k,
with its own tridiagonal solves. Departures from the program's general
scheme, exact for this configuration: space is flat (every curvature
factor is 1), and dark energy is a cosmological constant, whose
perturbations vanish identically, so the state carries no fluid. Departures
from the physics, kept because the program makes them: a row with a
massless neutrino keeps that species in the background of the
recombination history but drops it from the perturbations' background and
hierarchy, as the program's massless setting does; the perturbations'
massive-neutrino background is the 5-point quadrature of the hierarchy.
In float32 the exponentials' clips, the floors of the logarithms and the
nudges just inside today's time are those that float32 can hold.
"""

import math

import numpy as np
import torch

# CODATA 2018 and IAU 2015 values, SI
C = 299792458.0
G_NEWTON = 6.6743e-11
KB = 1.380649e-23
SIGMA_SB = 5.670374419184429e-08
PARSEC = 3.085677581491367e+16
EV = 1.602176634e-19
MPC = 1e6 * PARSEC
RHO_CRIT_KG = 3.0 * (1e5 / MPC) ** 2 / (8 * math.pi * G_NEWTON)      # kg/m^3 per h^2
C_KMS = C / 1e3
KB_EV = 8.617333262e-5                                                  # eV/K

# atomic data (RECFAST)
SIGMA_T = 6.6524587321e-29          # m^2
M_E = 9.1093837015e-31              # kg
M_H = 1.6737236e-27                 # kg
NOT4 = 3.9715                       # m_He / m_H
H_PLANCK = 6.62607015e-34           # J s
A_RAD = 4.0 * SIGMA_SB / C
LAMBDA_LYA = 1215.668e-10           # m
LAMBDA_2S1S = 8.2245809             # 1/s
B1_H = 1.57809e5                    # K
B2_H = B1_H / 4.0
E_ALPHA = B1_H - B2_H
CHI_HEI = 2.853157e5
CHI_HEII = 6.31515e5
HCK = 1.43877688e-2                 # m K
L_HE_2S, L_HE_2P, L_HE_ION = 1.66277434e7, 1.71134891e7, 1.98310772e7   # 1/m
CHI_HE_2S = (L_HE_ION - L_HE_2S) * HCK
E_HE_2S = L_HE_2S * HCK
E_HE_2P2S = (L_HE_2P - L_HE_2S) * HCK
LAMBDA_HE_2P = 1.0 / L_HE_2P
LAMBDA_HE_2S1S = 51.3
FUDGE = 1.14
LNG_CONST = 2.0 * math.pi * M_E * KB / H_PLANCK ** 2      # (2 pi m_e k T / h^2) = LNG_CONST T

# the solver's settings
N_THERMO = 6144                     # recombination steps, uniform in ln a over [1e-8, 1]
LMAX_G, LMAX_POL, LMAX_UR, LMAX_NC, NQ = 11, 11, 17, 8, 5
TCA_AH, TCA_K, RSA_KETA, PIN_KAH = 120.0, 50.0, 45.0, 2.5
ALPHA_K, BETA_ETA, KAPPA_SAFE = 0.5, 0.004, 0.45
CHUNK = 64                          # steps whose coefficients are made in one vectorised pass


def steps_for_kmax(kmax):
    """The step and table budget (steps of phase A, of phase B, table
    knots) of a largest k [h/Mpc]."""
    if kmax <= 0.9:
        return 2560, 1280, 4096
    if kmax <= 3.6:
        return 8192, 4096, 8192
    return 10240, 6144, 8192


def emulator_k():
    """The emulator's k grid [h/Mpc]: 20, 40, 60, 80, 100 points per decade
    from 1e-5 to 1, 120 from 1 to 10 inclusive, and 1e-6, 1e2 at the ends."""
    parts = [[1e-6]] + [np.logspace(d, d + 1, n, endpoint=False) for d, n in zip(range(-5, 0), (20, 40, 60, 80, 100))]
    return np.concatenate(parts + [np.logspace(0, 1, 120), [1e2]])


def emulator_z():
    """The emulator's 30 redshifts, uniform in sqrt(z) over [0, 10]."""
    return np.linspace(0.0, 10.0 ** 0.5, 30) ** 2


class Num:
    """The precision's guards: the exponent clip and the floor of a log."""

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, device
        self.clip = 300.0 if dtype == torch.float64 else 80.0
        self.tiny = 1e-300 if dtype == torch.float64 else 1e-37
        self.eps = float(torch.finfo(dtype).eps)

    def nudge(self, x):
        """A relative nudge ``x``, or 8 ulps where the precision cannot hold it."""
        return max(x, 8.0 * self.eps)

    def t(self, values):
        return torch.as_tensor(np.asarray(values, dtype=np.float64), dtype=self.dtype, device=self.device)

    def exp(self, x, lo=None, hi=None):
        return torch.exp(torch.clamp(x, -self.clip if lo is None else lo, self.clip if hi is None else hi))


def lin_interp(x, xp, fp):
    """Linear interpolation along the last axis, clamped to the end values;
    ``x`` (..., m), ``xp`` and ``fp`` (..., n) broadcast on the leading axes."""
    batch = torch.broadcast_shapes(x.shape[:-1], xp.shape[:-1], fp.shape[:-1])
    x = x.expand(batch + x.shape[-1:]).contiguous()
    xp = xp.expand(batch + xp.shape[-1:]).contiguous()
    fp = fp.expand(batch + fp.shape[-1:])
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[-1] - 1)
    x0, x1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    f0, f1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = x1 - x0
    flat = dx == 0
    f = torch.where(flat, f0, f0 + (x - x0) / torch.where(flat, 1.0, dx) * (f1 - f0))
    return torch.where(x < xp[..., :1], fp[..., :1], torch.where(x > xp[..., -1:], fp[..., -1:], f))


def cumtrapz(f, dx):
    """Cumulative trapezoid along the last axis from 0 (``dx`` a step or steps)."""
    seg = 0.5 * (f[..., 1:] + f[..., :-1]) * dx
    return torch.cat([torch.zeros_like(f[..., :1]), torch.cumsum(seg, -1)], -1)


def slope(f, h):
    """Centred differences along the last axis, one-sided at the edges, over ``h``."""
    return torch.cat([f[..., 1:2] - f[..., :1], 0.5 * (f[..., 2:] - f[..., :-2]), f[..., -1:] - f[..., -2:-1]], -1) / h


# ---- background ----------------------------------------------------------

class Background:
    """The background of each row: E(z), omega of each species (per h^2
    units of the critical density), the massive neutrino's tabulated and
    splined in z."""

    def __init__(self, p, num):
        self.p, self.num = p, num
        self.omega_g = p['T_cmb'] ** 4 * 4.0 / C ** 3 * SIGMA_SB / RHO_CRIT_KG
        self.omega_ur = p['N_ur'] * 7.0 / 8.0 * (4.0 / 11.0) ** (4.0 / 3.0) * self.omega_g
        self.T_nu = p['T_ncdm_over_cmb'] * p['T_cmb']                  # K today
        q, w = np.polynomial.laguerre.laggauss(100)
        self.q, self.w = num.t(q), num.t(w)
        self.omega_nc0 = self.omega_ncdm(torch.ones_like(p['h'])[:, None])[:, 0]
        self.omega_de = p['h'] ** 2 - (p['omega_cdm'] + p['omega_b'] + self.omega_g + self.omega_ur + self.omega_nc0)
        # the comoving density tabulated on a fixed z grid (19 points to z = 1, then 100 uniform in ln a
        # to a = 1e-8), splined in z
        z_nc = np.concatenate([np.linspace(0.0, 1.0, 20)[:-1], 1.0 / np.geomspace(1e-8, 0.5, 100)[::-1] - 1.0])
        self.z_nc = num.t(z_nc)
        table = self.omega_ncdm(1.0 / (1.0 + self.z_nc.expand(len(p['h']), -1))).T           # (n, B)
        self.nc_table = (table, natural_second_derivatives(self.z_nc, table))

    def omega_ncdm(self, a):
        """The massive neutrino's physical density at ``a`` (B, n), in units
        of the critical density per h^2, times a^3 (comoving)."""
        x = (a * (self.p['m_ncdm'] / (KB_EV * self.T_nu))[:, None])[..., None]           # m a / T(a)
        q = self.q
        integral = torch.sum(self.w * q ** 2 * torch.sqrt(q ** 2 + x ** 2) / (1.0 + torch.exp(-q)), -1)
        norm = 7.0 / 8.0 * self.p['T_ncdm_over_cmb'][:, None] ** 4 * self.omega_g[:, None] / (7.0 * math.pi ** 4 / 120)
        return norm * integral / a

    def efunc(self, a):
        """E = H / H0 at ``a`` (B, n), the massive neutrino from its table."""
        h2 = self.p['h'][:, None] ** 2
        nc = spline_eval_rows(self.z_nc, *self.nc_table, 1.0 / a - 1.0)
        rho = ((self.p['omega_cdm'] + self.p['omega_b'])[:, None] / a ** 3
               + (self.omega_g + self.omega_ur)[:, None] / a ** 4 + nc / a ** 3 + self.omega_de[:, None])
        return torch.sqrt(rho / h2)

    def sound_horizon(self, z):
        """The comoving sound horizon at ``z`` (B,), in Mpc/h: the integral
        of c da / (a^2 H sqrt(3 (1 + R))) from a = 1e-8, R = 3 omega_b a /
        (4 omega_g), by 64 panels of 16-point Gauss-Legendre in ln a."""
        x, w = np.polynomial.legendre.leggauss(16)
        edges = np.linspace(0.0, 1.0, 65)
        half = (edges[1:, None] - edges[:-1, None]) / 2
        t = self.num.t(((edges[:-1, None] + edges[1:, None]) / 2 + half * x).ravel())
        wt = self.num.t((half * w).ravel())
        lo, hi = math.log(1e-8), -torch.log1p(z)
        lna = lo + (hi[:, None] - lo) * t
        a = torch.exp(lna)
        R = 0.75 * a * (self.p['omega_b'] / self.omega_g)[:, None]
        f = C_KMS / (a * 100.0 * self.efunc(a)) / torch.sqrt(3.0 * (1.0 + R))          # da/a integrand
        return torch.sum(f * wt, -1) * (hi - lo)


# ---- recombination -------------------------------------------------------

def recombination(p, bg, num):
    """The ionization history on the static ln a grid and the scalars:
    a dict of tables (B, N_THERMO + 1) and z_star, z_drag (B,)."""
    lna = num.t(np.linspace(math.log(1e-8), 0.0, N_THERMO + 1))
    dlna = float(np.linspace(math.log(1e-8), 0.0, N_THERMO + 1)[1] - math.log(1e-8))
    a = torch.exp(lna)
    z = 1.0 / a - 1.0
    N_eff = p['N_ur'] + p['T_ncdm_over_cmb'] ** 4 * (4.0 / 11.0) ** (-4.0 / 3.0)
    Y = 0.2467 + 0.30 * (p['omega_b'] - 0.02237) + 0.013 * (N_eff - 3.044)
    f_He = (Y / (NOT4 * (1.0 - Y)))[:, None]
    n_H0 = ((1.0 - Y) * p['omega_b'] * RHO_CRIT_KG / M_H)[:, None]
    n_H = n_H0 / a ** 3                                                   # (B, G)
    Tg = p['T_cmb'][:, None] / a
    H_s = 100.0 * p['h'][:, None] * bg.efunc(a.expand(n_H.shape)) * 1e3 / MPC    # 1/s

    def lng(T):
        return 1.5 * torch.log(LNG_CONST * T)

    def saha(T, chi, n):
        """(2 pi m_e k T / h^2)^(3/2) exp(-chi / T) / n_H."""
        return num.exp(lng(T) - chi / T - torch.log(n))

    # Saha: HeIII, then HeII with all hydrogen ionised, then hydrogen with the helium electrons
    S3 = saha(Tg, CHI_HEII, n_H)
    b3 = 1.0 + f_He + S3
    v3 = 2.0 * S3 / (b3 + torch.sqrt(b3 * b3 + 4.0 * f_He * S3))
    S2 = 4.0 * saha(Tg, CHI_HEI, n_H)
    b2 = 1.0 + S2
    u2 = 2.0 * S2 / (b2 + torch.sqrt(b2 * b2 + 4.0 * f_He * S2))
    he3 = v3 > 1e-6
    S1 = saha(Tg, B1_H, n_H)

    def saha_h(S, he_e):
        bb = he_e + S
        return 2.0 * S / (bb + torch.sqrt(bb * bb + 4.0 * S))

    xH_saha_tab = saha_h(S1, f_He * torch.where(he3, 1.0 + v3, u2))
    he_e_saha = torch.where(he3, f_He * (1.0 + v3), torch.full_like(v3, -1.0))       # -1: no Saha value
    he_saha = torch.where(u2 > 0.99, f_He * u2, torch.full_like(u2, -1.0))
    K_lya = LAMBDA_LYA ** 3 / (8.0 * math.pi * H_s)
    K_he = LAMBDA_HE_2P ** 3 / (8.0 * math.pi * H_s) * n_H
    A_compton = 8.0 * SIGMA_T * A_RAD * Tg ** 4 / (3.0 * M_E * C * H_s)

    def temperature(T_m, xe0, xe1, i0, i):
        """T' = -2 T + A (T_g - T) over the step, Crank-Nicolson; on its
        attractor where the Compton coupling A exceeds 50."""
        A0 = A_compton[:, i0] * xe0 / (1.0 + fHe + xe0)
        A1 = A_compton[:, i] * xe1 / (1.0 + fHe + xe1)
        T_cn = (T_m * (1.0 - h * (2.0 + A0)) + h * (A0 * Tg[:, i0] + A1 * Tg[:, i])) / (1.0 + h * (2.0 + A1))
        return torch.where(A1 > 50.0, Tg[:, i] * (1.0 - 1.0 / torch.clamp(A1, min=2.0)), T_cn)

    def alpha_B(T):
        t = T / 1e4
        return FUDGE * 4.309e-19 * t ** -0.6166 / (1.0 + 0.6703 * t ** 0.53)

    def alpha_He(T):
        s1, s2 = torch.sqrt(T / 10.0 ** 5.114), torch.sqrt(T / 3.0)
        return 10.0 ** -16.744 / (s2 * (1.0 + s2) ** 0.289 * (1.0 + s1) ** 1.711)

    h = 0.5 * dlna
    fHe = f_He[:, 0]
    x_H, x_He, T_m = xH_saha_tab[:, 0], fHe * u2[:, 0], Tg[:, 0]
    out_xH, out_xHe, out_T = [x_H], [x_He], [T_m]
    # the steps on which every row takes both Saha values: the ODEs' results
    # would be discarded there, so they are not solved
    he_e_both = torch.where(he_e_saha >= 0.0, he_e_saha, he_saha)
    xH_both = saha_h(S1, he_e_both)
    saha_only = ((he_saha >= 0.0) & (xH_both > 0.985)).all(0).tolist()
    for i in range(1, N_THERMO + 1):
        i0 = i - 1
        he_e0 = torch.where(he_e_saha[:, i0] >= 0.0, he_e_saha[:, i0], x_He)
        if saha_only[i]:
            x_He1, he_e1, x_H1 = he_saha[:, i], he_e_both[:, i], xH_both[:, i]
            T_m = temperature(T_m, x_H + he_e0, x_H1 + he_e1, i0, i)
            x_H, x_He = x_H1, x_He1
            out_xH.append(x_H)
            out_xHe.append(x_He)
            out_T.append(T_m)
            continue
        aB, aHe = alpha_B(T_m), alpha_He(T_m)
        lt = lng(T_m)
        beta2 = aB * num.exp(lt - B2_H / T_m)
        betaHe = 4.0 * aHe * num.exp(lt - CHI_HE_2S / T_m)
        down_h = beta2 * torch.exp(-E_ALPHA / T_m)                 # n = 2 photoionisation from the ground state's view
        down_he = betaHe * num.exp(-E_HE_2S / T_m, hi=0.0)
        e2p2s = -E_HE_2P2S / T_m

        def he_rate(x, j, deriv):
            room = fHe - x
            KN = K_he[:, j] * torch.clamp(room, min=0.0)
            arg = e2p2s - torch.log(torch.clamp(KN, min=num.tiny))
            inv = num.exp(arg)
            den = LAMBDA_HE_2S1S + betaHe + inv
            Cf = (LAMBDA_HE_2S1S + inv) / den
            net = down_he * room - aHe * n_H[:, j] * (x_H + x) * x
            f = Cf * net / H_s[:, j]
            if not deriv:
                return f
            live = (KN > num.tiny) & (arg.abs() < num.clip)
            dinv = torch.where(live, inv * K_he[:, j] / torch.clamp(KN, min=num.tiny), 0.0)
            dnet = -down_he - aHe * n_H[:, j] * (x_H + 2.0 * x)
            return f, (betaHe * dinv / den ** 2 * net + Cf * dnet) / H_s[:, j]

        def h_rate(x, j, he_e, deriv):
            n1s = torch.clamp(1.0 - x, min=0.0) * n_H[:, j]
            K = K_lya[:, j]
            den = 1.0 + K * (LAMBDA_2S1S + beta2) * n1s
            Cf = (1.0 + K * LAMBDA_2S1S * n1s) / den
            net = down_h * (1.0 - x) - aB * n_H[:, j] * (x + he_e) * x
            f = Cf * net / H_s[:, j]
            if not deriv:
                return f
            dC = K * beta2 * n_H[:, j] * (x < 1.0) / den ** 2
            dnet = -down_h - aB * n_H[:, j] * (2.0 * x + he_e)
            return f, (dC * net + Cf * dnet) / H_s[:, j]

        def crank_nicolson(x0, f0, rate):
            x = x0 + dlna * f0
            for _ in range(3):
                f, df = rate(x)
                x = x - (x - x0 - h * (f0 + f)) / (1.0 - h * df)
            return x

        xhe_cn = crank_nicolson(x_He, he_rate(x_He, i0, False), lambda x: he_rate(x, i, True))
        x_He1 = torch.where(he_saha[:, i] >= 0.0, he_saha[:, i], torch.clamp(xhe_cn, 0.0, None).clamp(max=fHe))
        he_e1 = torch.where(he_e_saha[:, i] >= 0.0, he_e_saha[:, i], x_He1)
        xh_cn = crank_nicolson(x_H, h_rate(x_H, i0, he_e0, False), lambda x: h_rate(x, i, he_e1, True))
        xs = saha_h(S1[:, i], he_e1)
        x_H1 = torch.where(xs > 0.985, xs, torch.clamp(xh_cn, 0.0, 1.0))
        T_m = temperature(T_m, x_H + he_e0, x_H1 + he_e1, i0, i)
        x_H, x_He = x_H1, x_He1
        out_xH.append(x_H)
        out_xHe.append(x_He)
        out_T.append(T_m)
    x_H, x_He, T_m = (torch.stack(v, -1) for v in (out_xH, out_xHe, out_T))
    x_e_rec = x_H + torch.where(he3, f_He * (1.0 + v3), x_He)

    # reionisation: tanh in (1 + z)^1.5 for H and HeII, HeII -> HeIII at z = 3.5
    W_He = 0.5 * (1.0 + torch.tanh((3.5 - z) / 0.5))
    width = p['reionization_width'][:, None]

    def with_reio(zre):
        y_re = (1.0 + zre[:, None]) ** 1.5
        dy = 1.5 * torch.sqrt(1.0 + zre[:, None]) * width
        W = 0.5 * (1.0 + torch.tanh((y_re - (1.0 + z) ** 1.5) / dy))
        return x_e_rec + torch.clamp(1.0 + f_He - x_e_rec, min=0.0) * W + f_He * W_He

    def dtau(x_e):                                        # d tau / d ln a
        return x_e * n_H * SIGMA_T * C / H_s

    def total(f):
        return torch.sum(0.5 * (f[:, 1:] + f[:, :-1]), -1) * dlna

    lo, hi = torch.full_like(p['h'], 1.0), torch.full_like(p['h'], 40.0)
    for _ in range(64 if num.dtype == torch.float64 else 32):
        mid = 0.5 * (lo + hi)
        above = total(dtau(with_reio(mid) - x_e_rec)) > p['tau_reio']
        lo, hi = torch.where(above, lo, mid), torch.where(above, mid, hi)
    x_e = with_reio(0.5 * (lo + hi))

    def depth_from_today(f):
        seg = 0.5 * (f[:, 1:] + f[:, :-1]) * dlna
        return torch.cat([seg.flip(-1).cumsum(-1).flip(-1), torch.zeros_like(seg[:, :1])], -1)

    tau = depth_from_today(dtau(x_e))
    omega_g = bg.omega_g[:, None]
    R = 3.0 * p['omega_b'][:, None] / (4.0 * omega_g) * a
    tau_drag = depth_from_today(dtau(x_e) / R)
    early = int(np.sum(np.linspace(math.log(1e-8), 0.0, N_THERMO + 1) <= math.log(1.0 / 51.0)))

    def crossing(table):
        lna_x = lin_interp(torch.zeros_like(p['h'])[:, None], -torch.log(table[:, :early]), lna[:early])[:, 0]
        return torch.exp(-lna_x) - 1.0

    kappa_prime = x_e * n_H * SIGMA_T * MPC * a
    return {'lna': lna, 'x_e': x_e, 'T_m': T_m, 'kappa_prime': kappa_prime, 'f_He': f_He, 'n_H0': n_H0,
            'z_star': crossing(tau), 'z_drag': crossing(tau_drag)}


# ---- the perturbations' tables -------------------------------------------

def ncdm_momenta(num):
    """The 5 Gauss-Laguerre momenta q, the Fermi-Dirac weights w e^q f0 and
    dln f0 / dln q, rescaled so that the quadrature holds int q^4 f0' dq =
    -4 int q^3 f0 dq exactly."""
    q, w = np.polynomial.laguerre.laggauss(NQ)
    f0 = 1.0 / (np.exp(q) + 1.0)
    w_fd = w * np.exp(q) * f0
    dlnf0 = -q / (1.0 + np.exp(-q))
    dlnf0 = dlnf0 * (-4.0 * np.sum(w_fd * q ** 3) / np.sum(w_fd * q ** 3 * dlnf0))
    return num.t(q), num.t(w_fd), num.t(dlnf0)


LOG_ROWS = ('Hc', 'kp', 'cb2', 'fg', 'fur', 'fc', 'fb', 'fnc', 'fde')
LIN_ROWS = ('lna', 'w_nc', 'dw_nc')


class Tables:
    """The coefficients of each row on a uniform ln(eta) grid of ``m_tab``
    knots, and what the lanes need of the background."""

    def __init__(self, p, rec, pert, num, m_tab):
        self.num = num
        h = p['h'][:, None]
        omega_g = (p['T_cmb'] ** 4 * 4.0 / C ** 3 * SIGMA_SB / RHO_CRIT_KG)[:, None]
        omega_ur = p['N_ur'][:, None] * 7.0 / 8.0 * (4.0 / 11.0) ** (4.0 / 3.0) * omega_g
        omega_b, omega_c = p['omega_b'][:, None], p['omega_cdm'][:, None]
        lna_np = np.linspace(math.log(1e-9), 0.0, 2 * m_tab + 1)
        dlna = float(lna_np[1] - lna_np[0])
        lna = num.t(lna_np)
        a = torch.exp(lna)
        q, w_fd, dlnf0 = ncdm_momenta(num)
        self.q, self.w_fd, self.dlnf0 = q, w_fd, dlnf0
        am = pert['m_ncdm'] / (pert['T_ncdm_over_cmb'] * p['T_cmb'] * KB_EV)              # (B,)
        eps = torch.sqrt(q ** 2 + (a[None, :, None] * am[:, None, None]) ** 2)           # (B, n, NQ)
        I_rho = torch.sum(w_fd * q ** 2 * eps, -1)
        I_p = torch.sum(w_fd * q ** 4 / eps, -1) / 3.0
        massive = (am > 0)[:, None]
        omega_nc = pert['omega_ncdm'][:, None]
        om_g, om_ur = omega_g / a ** 4, omega_ur / a ** 4
        om_c, om_b = omega_c / a ** 3, omega_b / a ** 3
        om_nc = torch.where(massive, omega_nc * I_rho / I_rho[:, -1:] / a ** 4, 0.0)
        om_nc_p = torch.where(massive, omega_nc * I_p / I_rho[:, -1:] / a ** 4, 0.0)
        om_de = (h ** 2 - omega_g - omega_ur - omega_c - omega_b - torch.where(massive, omega_nc, 0.0)).expand_as(om_c)
        om = om_g + om_ur + om_c + om_b + om_nc + om_de
        Hc = a * 100.0 * torch.sqrt(om) / C_KMS                                          # conformal Hubble, 1/Mpc
        eta = cumtrapz(1.0 / Hc, dlna) + 1.0 / Hc[:, :1]

        # Thomson opacity and baryon temperature from the recombination
        # history, fully ionised below its start
        lna_th = rec['lna']
        early = lna < lna_th[0]
        f_He, n_H0 = rec['f_He'], rec['n_H0']
        kp = torch.where(early, (1.0 + 2.0 * f_He) * n_H0 * SIGMA_T * MPC / a ** 2,
                         lin_interp(lna, lna_th, rec['kappa_prime']))
        T_m = torch.where(early, p['T_cmb'][:, None] / a, lin_interp(lna, lna_th, rec['T_m']))
        mu = (1.0 + NOT4 * f_He) / (1.0 + f_He + lin_interp(lna, lna_th, rec['x_e']))
        cb2 = KB * T_m / (mu * M_H * C ** 2) * (1.0 - slope(torch.log(T_m), dlna) / 3.0)
        w_nc = torch.where(om_nc > 0, om_nc_p / torch.clamp(om_nc, min=num.tiny), 0.0)

        lneta_m = torch.log(eta)
        t = num.t(np.arange(m_tab) / (m_tab - 1))
        lneta = lneta_m[:, :1] * (1.0 - t) + lneta_m[:, -1:] * t
        lneta = torch.cat([lneta[:, :-1], lneta_m[:, -1:]], -1)

        def res(x):
            return lin_interp(lneta, lneta_m, x.expand_as(lneta_m))

        B = h.shape[0]
        rows = {'lna': res(lna), 'Hc': res(Hc), 'kp': res(kp), 'cb2': res(cb2), 'fg': res(om_g / om),
                'fur': res(om_ur / om), 'fc': res(om_c / om), 'fb': res(om_b / om), 'fnc': res(om_nc / om),
                'fde': res(om_de / om), 'w_nc': res(w_nc), 'dw_nc': res(slope(w_nc, dlna))}
        self.lin = rows
        self.stack = torch.stack([rows[n] for n in LIN_ROWS] + [torch.log(torch.clamp(rows[n], min=num.tiny))
                                                                for n in LOG_ROWS])     # (13, B, M)
        self.lneta, self.lneta0, self.dlneta = lneta, lneta[:, :1], lneta[:, 1:2] - lneta[:, :1]
        self.eta_m = torch.exp(lneta)
        self.eta0 = eta[:, -1:]
        self.eta_ini_min = eta[:, :1] * 1.05
        self.eta_rd = lin_interp(num.t([math.log(1e-7)]).expand(B, 1), lna.expand(B, -1), eta)
        self.am = am[:, None]
        self.B = B

    def fetch(self, eta):
        """The rows at per-lane ``eta`` (P, B, nk): linear on the ln(eta) grid
        between its knots, clamped at the ends; log-stored rows exponentiated."""
        x = (torch.log(eta) - self.lneta0) / self.dlneta
        M = self.stack.shape[-1]
        i = torch.clamp(x.to(torch.int64), 0, M - 2)
        w = torch.clamp(x - i, 0.0, 1.0)
        P, B, nk = eta.shape
        idx = i.permute(1, 0, 2).reshape(1, B, P * nk).expand(self.stack.shape[0], B, P * nk)
        lo = torch.gather(self.stack, 2, idx).reshape(-1, B, P, nk).permute(0, 2, 1, 3)
        hi = torch.gather(self.stack, 2, idx + 1).reshape(-1, B, P, nk).permute(0, 2, 1, 3)
        v = lo * (1.0 - w) + hi * w
        out = {n: v[j] for j, n in enumerate(LIN_ROWS)}
        out.update((n, torch.exp(v[len(LIN_ROWS) + j])) for j, n in enumerate(LOG_ROWS))
        return out


class Lanes:
    """The (B, nk) lanes: k [1/Mpc], the ladders' coefficients, the momenta."""

    def __init__(self, tab, k):
        num = tab.num
        self.k, self.k2 = k, k * k
        q, w_fd, dlnf0 = ncdm_momenta(num)
        self.q = q.reshape(-1, 1, 1)
        self.w2 = (w_fd * q ** 2).reshape(-1, 1, 1)
        self.w3, self.w4 = self.w2 * self.q, self.w2 * self.q ** 2
        self.dlnf0 = dlnf0.reshape(-1, 1, 1)
        self.am = tab.am
        self.eta_rsa = RSA_KETA / k

        def ladder(L):
            """dX_l = pre / (2l + 1) (l X_{l-1} - (l + 1) X_{l+1}) with
            X_{L+1} = (2L + 1) / (pre eta) X_L - X_{L-1} folded into row L."""
            l = np.arange(L + 1, dtype=np.float64)
            down, up = l / (2 * l + 1), (l + 1) / (2 * l + 1)
            down[L], up[L] = 1.0, 0.0
            return down, up

        dg, ug = ladder(LMAX_G)
        dp, up_ = ladder(LMAX_POL)
        du, uu = ladder(LMAX_UR)
        # rows F_g2 .. F_gL, G_0 .. G_L, F_ur0 .. F_urL: one ladder in k
        self.down = num.t(np.concatenate([dg[2:], dp, du])).reshape(-1, 1, 1) * k
        self.up = num.t(np.concatenate([ug[2:], up_, uu])).reshape(-1, 1, 1) * k
        self.down[0] = 0.0          # F_g1 is not a row: it enters through theta_g
        dn, un = ladder(LMAX_NC)
        self.down_nc, self.up_nc = num.t(dn).reshape(-1, 1, 1), num.t(un).reshape(-1, 1, 1)


# state rows
PHI, DC, TC, DB, TB, DG, TG = range(7)
FG = 7                              # F_g2 .. F_gL
GP = FG + LMAX_G - 1                # G_0 .. G_L
UR = GP + LMAX_POL + 1              # F_ur0 .. F_urL
NC = UR + LMAX_UR + 1               # Psi_{q, l}, q-major
N_STATE = NC + NQ * (LMAX_NC + 1)
PHOT = slice(FG, UR)


def coefficients_a(tab, ln, eta):
    """Phase A's coefficients at ``eta`` (P, B, nk)."""
    c = tab.fetch(eta)
    k, k2 = ln.k, ln.k2
    Hc, kp, fg, fur, fb, fnc = c['Hc'], c['kp'], c['fg'], c['fur'], c['fb'], c['fnc']
    a = torch.exp(c['lna'])
    eps = torch.sqrt(ln.q ** 2 + (a[:, None] * ln.am) ** 2)                  # (P, NQ, B, nk)
    W0, W2 = ln.w2 * eps, ln.w4 / eps
    I_rho = W0.sum(1)
    tca = (kp > TCA_AH * Hc) & (kp > TCA_K * k)
    rsa = eta > ln.eta_rsa
    h2k2 = Hc * Hc / k2
    R = 4.0 / 3.0 * fg / fb
    w_tot = (fg + fur) / 3.0 + c['w_nc'] * fnc - c['fde']
    c.update(tca=tca, rsa=rsa, eps=eps, W0=W0, I_rho=I_rho,
             mpsi=4.5 * h2k2, g15=1.5 * h2k2, sg=torch.where(tca, 0.0, 2.0 / 3.0 * fg),
             su=torch.where(rsa, 0.0, 2.0 / 3.0 * fur), thu=torch.where(rsa, 0.0, fur * k),
             rfac=torch.where(rsa, 1.0 / (1.0 - 6.0 * h2k2 * fur), 1.0),
             S2w=fnc[:, None] * 2.0 / 3.0 * W2 / I_rho[:, None], T1w=fnc[:, None] * k * ln.w3 / I_rho[:, None],
             D0w=fnc[:, None] * W0 / I_rho[:, None],
             gtca=32.0 / 45.0 / kp, cb2k2=c['cb2'] * k2, R=R, inv1R=1.0 / (1.0 + R),
             sl1=2.0 * R / (1.0 + R) * Hc, sl2=R / (kp * (1.0 + R)),
             a_tb=-(Hc * Hc - 0.5 * Hc * Hc * (1.0 + 3.0 * w_tot)),
             qe=ln.q * k / eps, src1n=-(eps * k / (3.0 * ln.q)) * ln.dlnf0,
             pin=k > PIN_KAH * Hc, tqs=1.0 / (kp * (1.0 + R)), inv_eta=1.0 / eta)
    return c


def take(c, i):
    return {n: v[i] for n, v in c.items()}


def metric_a(y, ln, c):
    """psi, phi', the anisotropic stress and the momentum density of the
    constraints."""
    psi_nc = y[NC:].reshape((NQ, LMAX_NC + 1) + y.shape[1:])
    stress = c['sg'] * y[FG] + c['su'] * y[UR + 2] + (c['S2w'] * psi_nc[:, 2]).sum(0)
    theta = (c['fc'] * y[TC] + c['fb'] * y[TB] + 4.0 / 3.0 * c['fg'] * y[TG] + (c['T1w'] * psi_nc[:, 1]).sum(0)
             + c['thu'] * y[UR + 1])
    psi, phip = psi_phip(y[PHI], stress, theta, c)
    return psi, phip, stress, theta


def psi_phip(phi, stress, theta, c):
    psi = phi - c['mpsi'] * stress
    return psi, c['rfac'] * (c['g15'] * theta - c['Hc'] * psi)


def deriv_a(y, ln, c):
    """d/deta of phase A's state (N_STATE, B, nk)."""
    k, k2, Hc, kp, tca = ln.k, ln.k2, c['Hc'], c['kp'], c['tca']
    psi, phip, _, _ = metric_a(y, ln, c)
    dc, tc, db, tb, dg, tg = y[DC], y[TC], y[DB], y[TB], y[DG], y[TG]
    F2 = torch.where(tca, c['gtca'] * tg, y[FG])
    ddb, ddg = 3.0 * phip - tb, 4.0 * phip - 4.0 / 3.0 * tg
    dtb = c['cb2k2'] * db - Hc * tb + k2 * psi
    dtg = k2 * (0.25 * dg - 0.5 * F2) + k2 * psi
    slip = c['sl1'] * (tb - tg) + c['sl2'] * (c['a_tb'] * tb - 0.5 * Hc * k2 * dg - Hc * k2 * psi + c['cb2k2'] * ddb
                                             - 0.25 * k2 * ddg)
    dtb_tc = (dtb + c['R'] * (dtg + slip)) * c['inv1R']
    dtb, dtg = torch.where(tca, dtb_tc, dtb), torch.where(tca, dtb_tc - slip, dtg)

    # photons, polarization, massless neutrinos: free streaming, then the
    # scattering, the closures' diagonal and the sources
    lad = ln.down * y[FG - 1:NC - 1] - ln.up * y[FG + 1:NC + 1]
    lad[GP - 1 - FG] = lad[GP - 1 - FG] - (LMAX_G + 1) * c['inv_eta'] * y[GP - 1]
    lad[UR - 1 - FG] = lad[UR - 1 - FG] - (LMAX_POL + 1) * c['inv_eta'] * y[UR - 1]
    lad[NC - 1 - FG] = lad[NC - 1 - FG] - (LMAX_UR + 1) * c['inv_eta'] * y[NC - 1]
    phot = lad[:UR - FG] - kp * y[PHOT]
    G0, G2 = y[GP], y[GP + 2]
    Pi = F2 + G0 + G2
    phot[0] = phot[0] + 8.0 / 15.0 * tg + 0.1 * kp * (y[FG] + G0 + G2)
    phot[GP - FG] = phot[GP - FG] + 0.5 * kp * Pi
    phot[GP - FG + 2] = phot[GP - FG + 2] + 0.1 * kp * Pi
    ur = lad[UR - FG:]
    ur[0] = ur[0] + 4.0 * phip
    ur[1] = ur[1] + 4.0 / 3.0 * k * psi
    ur = torch.where(c['rsa'], 0.0, ur)

    # the massive neutrino: one ladder per momentum, pre = q k / eps
    psi_nc = y[NC:].reshape((NQ, LMAX_NC + 1) + y.shape[1:])
    below = torch.cat([torch.zeros_like(psi_nc[:, :1]), psi_nc[:, :-1]], 1)
    above = torch.cat([psi_nc[:, 1:], torch.zeros_like(psi_nc[:, :1])], 1)
    nc = (ln.down_nc * below - ln.up_nc * above) * c['qe'][:, None]
    nc[:, -1] = nc[:, -1] - (LMAX_NC + 1) * c['inv_eta'] * psi_nc[:, -1]
    nc[:, 0] = nc[:, 0] - phip * ln.dlnf0
    nc[:, 1] = nc[:, 1] + c['src1n'] * psi
    return torch.cat([torch.stack([phip, 3.0 * phip - tc, k2 * psi - Hc * tc, ddb, dtb, ddg, dtg]), phot, ur,
                      nc.reshape((-1,) + y.shape[1:])])


def project_a(y0, y1, ln, d, cm, c1):
    """After a phase-A step: the exact Thomson drag (outside tight
    coupling), the tight-coupling slaving, the Poisson pin, the massless
    neutrinos' streaming values."""
    k2 = ln.k2
    y1 = y1.clone()
    # drag: the slip theta_b - theta_g relaxes exactly over the step, the
    # drag-free invariant (theta_b + R theta_g) / (1 + R) is the RK4 one
    zeta = cm['kp'] * (1.0 + cm['R']) * d
    phi1 = torch.where(zeta > 1e-8, -torch.expm1(-zeta) / torch.where(zeta > 1e-8, zeta, 1.0), 1.0 - 0.5 * zeta)
    m = 0.5 * (y0 + y1)
    D = cm['cb2k2'] * m[DB] - cm['Hc'] * m[TB] - k2 * (0.25 * m[DG] - 0.5 * m[FG])
    S = (y0[TB] - y0[TG]) * torch.exp(-zeta) + d * phi1 * D
    V = (y1[TB] + cm['R'] * y1[TG]) * cm['inv1R']
    tca = c1['tca']
    y1[TB] = torch.where(tca, y1[TB], V + cm['R'] * cm['inv1R'] * S)
    y1[TG] = torch.where(tca, y1[TG], V - cm['inv1R'] * S)
    # tight coupling: theta_g from the quasi-static slip, F_2 = (32/45)
    # theta_g / kappa', G_0 = 5 F_2 / 4, G_2 = F_2 / 4, the rest 0
    D = c1['cb2k2'] * y1[DB] - c1['Hc'] * y1[TB] - k2 * (0.25 * y1[DG] - 0.5 * c1['gtca'] * y1[TG])
    y1[TG] = torch.where(tca, y1[TB] - D * c1['tqs'], y1[TG])
    F2 = c1['gtca'] * y1[TG]
    slaved = torch.zeros_like(y1[PHOT])
    slaved[0], slaved[GP - FG], slaved[GP - FG + 2] = F2, 1.25 * F2, 0.25 * F2
    y1[PHOT] = torch.where(tca, slaved, y1[PHOT])
    # the Poisson constraint pins phi where k > 2.5 aH
    psi, phip, stress, theta = metric_a(y1, ln, c1)
    rsa = c1['rsa']
    psi_nc = y1[NC:].reshape((NQ, LMAX_NC + 1) + y1.shape[1:])
    Delta = (c1['fg'] * y1[DG] + c1['fur'] * torch.where(rsa, -4.0 * psi, y1[UR]) + c1['fc'] * y1[DC]
             + c1['fb'] * y1[DB] + (c1['D0w'] * psi_nc[:, 0]).sum(0))
    Hc = c1['Hc']
    pinned = -1.5 * Hc * Hc / k2 * (Delta + 3.0 * Hc / k2 * (theta + torch.where(rsa, 4.0 * c1['fur'] * phip, 0.0)))
    y1[PHI] = torch.where(c1['pin'], pinned, y1[PHI])
    # streaming: delta_ur = -4 psi, theta_ur = 3 phi', F_ur,l>=2 = 0 (the pin moved phi alone)
    psi, phip = psi_phip(y1[PHI], stress, theta, c1)
    y1[UR] = torch.where(rsa, -4.0 * psi, y1[UR])
    y1[UR + 1] = torch.where(rsa, 4.0 * phip / ln.k, y1[UR + 1])
    y1[UR + 2:NC] = torch.where(rsa, 0.0, y1[UR + 2:NC])
    return y1


def coefficients_b(tab, ln, eta):
    """Phase B's coefficients at ``eta`` (P, B, nk)."""
    c = tab.fetch(eta)
    k2, Hc, w, fnc = ln.k2, c['Hc'], c['w_nc'], c['fnc']
    h2k2 = Hc * Hc / k2
    cg2 = w - c['dw_nc'] / (3.0 * (1.0 + w))
    c.update(b_sn=4.5 * h2k2 * fnc * (1.0 + w), g15=1.5 * h2k2, fno=fnc * (1.0 + w),
             den=1.0 - 6.0 * h2k2 * (c['fg'] + c['fur']), cb2k2=c['cb2'] * k2,
             kpR=c['kp'] * 4.0 / 3.0 * c['fg'] / c['fb'], cg2=cg2)
    return c


def deriv_b(y, ln, c):
    """d/deta of phase B's state (phi, dc, tc, db, tb, delta, theta and
    sigma of the massive neutrino): the radiation on its streaming values
    (delta = -4 psi, theta = 3 phi'), the massive neutrino a viscous fluid."""
    k2, Hc, w, cg2 = ln.k2, c['Hc'], c['w_nc'], c['cg2']
    phi, dc, tc, db, tb, dn, tn, sn = y
    psi, phip = metric_b(y, c)
    p3 = 3.0 * phip
    fluid = torch.stack([-(1.0 + w) * (tn - p3) - 3.0 * Hc * (cg2 - w) * dn,
                         -Hc * (1.0 - 3.0 * cg2) * tn + cg2 / (1.0 + w) * k2 * dn + k2 * psi - k2 * sn,
                         -3.0 * Hc * sn + 16.0 / 15.0 * cg2 / (1.0 + w) * tn])
    if 'frozen' in c:
        fluid = torch.where(c['frozen'], 0.0, fluid)
    return torch.cat([torch.stack([phip, p3 - tc, k2 * psi - Hc * tc, p3 - tb,
                                   -Hc * tb + c['cb2k2'] * db + k2 * psi + c['kpR'] * (p3 - tb)]), fluid])


def metric_b(y, c):
    """psi and phi' of phase B's state."""
    phi, dc, tc, db, tb, dn, tn, sn = y
    psi = phi - c['b_sn'] * sn
    return psi, (c['g15'] * (c['fc'] * tc + c['fb'] * tb + c['fno'] * tn) - c['Hc'] * psi) / c['den']


def unresolved_b(c, ln, d):
    """Where the step ``d`` turns the massive neutrino fluid's fastest wave
    (sound and shear: omega^2 = cg2 k^2 (1 + 16 / (15 (1 + w)))), at the
    coefficients ``c`` of a point on it, by more than 2 sqrt 2 radians,
    past what RK4 holds on the imaginary axis."""
    w = c['w_nc']
    omega2 = torch.clamp(c['cg2'], min=0.0) * ln.k2 * (1.0 + 16.0 / (15.0 * (1.0 + w)))
    return torch.sqrt(omega2) * d > 2.0 * math.sqrt(2.0)


def project_b(y0, y1, ln, d, cm, c1):
    """After a phase-B step in which the massive neutrino's waves are not
    resolved (``c1['frozen']``, set by :func:`rk4`): its fluid on the
    quasi-static values, theta' = 0 with sigma = 0 and delta' = 0."""
    frozen = c1['frozen']
    psi, phip = metric_b(y1, c1)
    w, cg2, Hc = c1['w_nc'], c1['cg2'], c1['Hc']
    dn = -(1.0 + w) * psi / torch.where(frozen, cg2, 1.0)
    y1 = y1.clone()
    y1[5] = torch.where(frozen, dn, y1[5])
    y1[6] = torch.where(frozen, 3.0 * phip - 3.0 * Hc * (cg2 - w) * dn / (1.0 + w), y1[6])
    y1[7] = torch.where(frozen, 0.0, y1[7])
    return y1


def rk4(deriv, coefficients, project, y, grid, tab, ln, harvest, rows, frozen=None):
    """Fixed-step RK4 over the lanes' grids ``grid`` (N + 1, B, nk), then
    ``project``; returns the end state and, at each harvest time (n_z, B,
    1), the rows ``rows`` blended linearly inside the step that holds it.
    ``frozen``: None, or a function (a point's coefficients, lanes, the
    step it lies on) of the lanes whose fluid is frozen there, given to
    ``deriv`` and ``project`` as 'frozen' (the start lies on the first
    step)."""
    n = grid.shape[0] - 1
    c0 = take(coefficients(tab, ln, grid[:1]), 0)
    if frozen is not None:
        c0['frozen'] = frozen(c0, ln, grid[1] - grid[0])
    ydot = deriv(y, ln, c0)
    out = y.new_zeros((harvest.shape[0], len(rows)) + y.shape[1:])
    for base in range(0, n, CHUNK):
        e = grid[base:min(base + CHUNK, n) + 1]
        mid = 0.5 * (e[:-1] + e[1:])
        c = coefficients(tab, ln, torch.cat([mid, e[1:]]))
        m = e.shape[0] - 1
        hits = ((e[:-1, None] <= harvest) & (e[1:, None] > harvest)).flatten(1).any(1).tolist()
        for j in range(m):
            cm, c1 = take(c, j), take(c, m + j)
            e0, e1 = e[j], e[j + 1]
            d = e1 - e0
            if frozen is not None:
                cm['frozen'], c1['frozen'] = frozen(cm, ln, d), frozen(c1, ln, d)
            k2 = deriv(y + 0.5 * d * ydot, ln, cm)
            k3 = deriv(y + 0.5 * d * k2, ln, cm)
            k4 = deriv(y + d * k3, ln, c1)
            y1 = y + d / 6.0 * (ydot + 2.0 * k2 + 2.0 * k3 + k4)
            y1 = project(y, y1, ln, d, cm, c1)
            if hits[j]:
                hit = (e0 <= harvest) & (e1 > harvest)                                  # (n_z, B, nk)
                wgt = torch.clamp((harvest - e0) / torch.where(d > 0, d, 1.0), 0.0, 1.0)
                ys, y1s = y[rows], y1[rows]
                out = out + torch.where(hit[:, None], ys + wgt[:, None] * (y1s - ys), 0.0)
            y, ydot = y1, deriv(y1, ln, c1)
    return y, out


def interp_lanes(x, xp, fp):
    """Linear interpolation per lane: ``x`` (B, nk, m), ``xp``, ``fp`` (B,
    nk or 1, M)."""
    B, nk, _ = x.shape
    return lin_interp(x, xp.expand(B, nk, xp.shape[-1]), fp.expand(B, nk, fp.shape[-1]))


def time_grids(tab, k, n_a, n_b):
    """The lanes' grids of phase A (from the start to k eta = 45) and phase B
    (from there to today), (N + 1, B, nk) each, uniform in the integrated
    step density; and the start times."""
    num = tab.num
    eta_m = tab.eta_m[:, None, :]                                             # (B, 1, M)
    Hc, kp = tab.lin['Hc'][:, None, :], tab.lin['kp'][:, None, :]
    kk = k[..., None]
    tca_off = (kp < TCA_AH * Hc) | (kp < TCA_K * kk)
    dens = torch.maximum(kk / ALPHA_K, 1.0 / (BETA_ETA * eta_m))
    dens = torch.maximum(dens, torch.where(tca_off, kp / (2.8 * KAPPA_SAFE), 0.0))
    s = cumtrapz(dens, torch.diff(eta_m, dim=-1))

    def grid(s, start, end, n):
        s0, s1 = interp_lanes(start[..., None], eta_m, s), interp_lanes(end[..., None], eta_m, s)
        return interp_lanes(s0 + (s1 - s0) * num.t(np.arange(n + 1) / n), s, eta_m)

    eta0 = tab.eta0
    eta_ini = torch.minimum(torch.maximum(0.03 / k, tab.eta_ini_min), tab.eta_rd)
    eta_dec = lin_interp(num.t([-math.log(901.0)]).expand(tab.B, 1), tab.lin['lna'], tab.eta_m)
    eta_end_a = torch.minimum(torch.maximum(RSA_KETA / k, eta_dec), eta0)
    grid_a = torch.cat([grid(s, eta_ini, eta_end_a, n_a)[..., :-1], eta_end_a[..., None]], -1)
    w = tab.lin['w_nc']
    cg2 = torch.clamp(w - tab.lin['dw_nc'] / (3.0 * (1.0 + w)), min=0.0)
    dens_b = torch.maximum(1.0 / (BETA_ETA * eta_m), kk * torch.sqrt(cg2)[:, None, :] / 2.4)
    s_b = cumtrapz(dens_b, torch.diff(eta_m, dim=-1))
    last = eta0 * (1.0 + num.nudge(1e-9))
    grid_b = torch.minimum(grid(s_b, eta_end_a, last.expand_as(eta_end_a), n_b), last[..., None])
    grid_b = torch.cat([eta_end_a[..., None], grid_b[..., 1:]], -1)
    return grid_a.permute(2, 0, 1), grid_b.permute(2, 0, 1), eta_ini


def initial_state(tab, ln, eta_ini):
    """MB95 eq. 98, adiabatic, comoving curvature R = 1 (C = 1/2)."""
    k = ln.k
    c = take(tab.fetch(eta_ini[None]), 0)
    Rnu = (c['fur'] + c['fnc']) / (c['fg'] + c['fur'] + c['fnc'])
    psi = 10.0 / (15.0 + 4.0 * Rnu)
    phi = (1.0 + 0.4 * Rnu) * psi
    dg = -2.0 * psi
    tau = 1.0 / c['Hc']                                   # the radiation era's conformal time
    th = 0.5 * k * k * tau * psi
    sig = (k * tau) ** 2 / 15.0 * psi
    y = torch.zeros((N_STATE,) + k.shape, dtype=k.dtype, device=k.device)
    y[PHI], y[DC], y[TC], y[DB], y[TB], y[DG], y[TG] = phi, 0.75 * dg, th, 0.75 * dg, th, dg, th
    y[UR], y[UR + 1], y[UR + 2] = dg, 4.0 * th / (3.0 * k), 2.0 * sig
    a = torch.exp(lin_interp(torch.log(eta_ini), tab.lneta, tab.lin['lna']))
    psi_nc = y[NC:].reshape((NQ, LMAX_NC + 1) + k.shape)
    eps = torch.sqrt(ln.q ** 2 + (a * ln.am) ** 2)
    psi_nc[:, 0] = -0.25 * dg * ln.dlnf0
    psi_nc[:, 1] = -(eps / (3.0 * ln.q * k)) * th * ln.dlnf0
    psi_nc[:, 2] = -0.5 * sig * ln.dlnf0
    return y


def transfers(p, pert, rec, k, z, n_steps, num):
    """delta_m and delta_cb (B, n_z, nk) in the CDM-comoving synchronous
    gauge at ``k`` (B, nk) [1/Mpc] and the redshifts ``z``."""
    n_a, n_b, m_tab = n_steps
    tab = Tables(p, rec, pert, num, m_tab)
    ln = Lanes(tab, k)
    grid_a, grid_b, eta_ini = time_grids(tab, k, n_a, n_b)
    y0 = initial_state(tab, ln, eta_ini)
    eta_t = torch.exp(lin_interp(-torch.log1p(num.t(z)).expand(tab.B, -1), tab.lin['lna'], tab.lneta))
    eta_t = torch.minimum(eta_t, tab.eta0 * (1.0 - num.nudge(1e-10)))           # (B, n_z)
    harvest = eta_t.T[:, :, None]
    rows_a = [PHI, DC, TC, DB, TB, DG, UR] + [NC + j * (LMAX_NC + 1) + l for j in range(NQ) for l in (0, 1)]
    yA, outA = rk4(deriv_a, coefficients_a, project_a, y0, grid_a, tab, ln, harvest, rows_a)

    # the massive neutrino's hierarchy collapsed to its fluid moments
    c = take(coefficients_a(tab, ln, grid_a[-1:]), 0)
    psi_nc = yA[NC:].reshape((NQ, LMAX_NC + 1) + k.shape)
    I_rho, opw = c['I_rho'], 1.0 + c['w_nc']
    yB = torch.stack([yA[PHI], yA[DC], yA[TC], yA[DB], yA[TB], (c['W0'] * psi_nc[:, 0]).sum(0) / I_rho,
                      k * (ln.w3 * psi_nc[:, 1]).sum(0) / I_rho / opw,
                      2.0 / 3.0 * (ln.w4 / c['eps'] * psi_nc[:, 2]).sum(0) / I_rho / opw])
    _, outB = rk4(deriv_b, coefficients_b, project_b, yB, grid_b, tab, ln, harvest, list(range(8)), unresolved_b)

    out = {'delta_m': [], 'delta_cb': []}
    for iz in range(eta_t.shape[1]):
        c = take(coefficients_b(tab, ln, eta_t[None, :, iz:iz + 1].expand(1, *k.shape)), 0)
        a = torch.exp(c['lna'])
        eps = torch.sqrt(ln.q ** 2 + (a * ln.am) ** 2)
        I_rho = (ln.w2 * eps).sum(0)
        opw = 1.0 + c['w_nc']
        yA, yB = outA[iz], outB[iz]
        psiA = yA[7:].reshape((NQ, 2) + k.shape)
        inA = eta_t[:, iz:iz + 1] < grid_a[-1]
        dc, tc, db = (torch.where(inA, yA[i], yB[i]) for i in (DC, TC, DB))
        dn = torch.where(inA, (ln.w2 * eps * psiA[:, 0]).sum(0) / I_rho, yB[5])
        shift = 3.0 * c['Hc'] * tc / ln.k2
        dc, db, dn = dc + shift, db + shift, dn + opw * shift
        fc, fb, fnc = c['fc'], c['fb'], c['fnc']
        out['delta_m'].append((fc * dc + fb * db + fnc * dn) / (fc + fb + fnc))
        out['delta_cb'].append((fc * dc + fb * db) / (fc + fb))
    return {name: torch.stack(v, 1) for name, v in out.items()}


# ---- the (k, z) table on the emulator's grid -----------------------------

def natural_second_derivatives(x, y):
    """The second derivatives at the knots ``x`` (n,) of the natural cubic
    spline through ``y`` (n, ...): the tridiagonal system, solved densely."""
    n = x.shape[0]
    h = x[1:] - x[:-1]
    A = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    A[0, 0] = A[-1, -1] = 1.0
    i = torch.arange(1, n - 1, device=x.device)
    A[i, i - 1], A[i, i], A[i, i + 1] = h[:-1] / 6.0, (h[:-1] + h[1:]) / 3.0, h[1:] / 6.0
    r = torch.zeros_like(y)
    r[1:-1] = ((y[2:] - y[1:-1]).movedim(0, -1) / h[1:] - (y[1:-1] - y[:-2]).movedim(0, -1) / h[:-1]).movedim(-1, 0)
    return torch.linalg.solve(A, r.reshape(n, -1)).reshape(y.shape)


def spline_eval_rows(x, y, M, xq):
    """The natural cubics of :func:`spline_eval`, one a column of ``y`` (n,
    B), each at its own row of ``xq`` (B, m): (B, m)."""
    xq = xq.expand(y.shape[1], -1).contiguous()
    i = torch.clamp(torch.searchsorted(x, xq, right=True) - 1, 0, x.shape[0] - 2)
    y, M = y.T, M.T
    h = x[i + 1] - x[i]
    a = (x[i + 1] - xq) / h
    b = 1.0 - a
    return (a * y.gather(1, i) + b * y.gather(1, i + 1)
            + ((a ** 3 - a) * M.gather(1, i) + (b ** 3 - b) * M.gather(1, i + 1)) * h * h / 6.0)


def spline_eval(x, y, M, xq):
    """The natural cubic (knots ``x``, values ``y`` (n, ...), second
    derivatives ``M``) at ``xq`` (m,), its edge cubics beyond: (m, ...)."""
    i = torch.clamp(torch.searchsorted(x, xq, right=True) - 1, 0, x.shape[0] - 2)
    h = (x[i + 1] - x[i]).reshape((-1,) + (1,) * (y.dim() - 1))
    a = (x[i + 1] - xq).reshape(h.shape) / h
    b = 1.0 - a
    return a * y[i] + b * y[i + 1] + ((a ** 3 - a) * M[i] + (b ** 3 - b) * M[i + 1]) * h * h / 6.0


def on_emulator_grid(k, z, pk, kq, zq, num):
    """P(k, z) (B, n_z, nk) on the grid ``k`` [h/Mpc], ``z``, at ``kq`` x
    ``zq``: (B, nkq, nzq). log10 P is a natural bicubic in (log10 k, z),
    each k edge continued by two knots on the power law of its last two
    knots: at 1e-7 (1e2) h/Mpc, or 1e-3 dex beyond the edge if that is
    further, and at a tenth of the way from the edge to it."""
    logk = torch.log10(num.t(k))
    logp = torch.log10(torch.clamp(pk, min=1e-250 if num.dtype == torch.float64 else num.tiny)).permute(2, 1, 0)
    lo = min(float(logk[0]) - 1e-3, math.log10(1e-7))
    hi = max(float(logk[-1]) + 1e-3, math.log10(1e2))
    lk = torch.cat([torch.stack([num.t(lo), logk[0] * 0.1 + lo * 0.9]), logk,
                    torch.stack([logk[-1] * 0.1 + hi * 0.9, num.t(hi)])])
    s_lo = (logp[1] - logp[0]) / (logk[1] - logk[0])
    s_hi = (logp[-1] - logp[-2]) / (logk[-1] - logk[-2])
    lp = torch.cat([torch.stack([logp[0] + s_lo * (lk[j] - logk[0]) for j in (0, 1)]), logp,
                    torch.stack([logp[-1] + s_hi * (lk[j] - logk[-1]) for j in (-2, -1)])])    # (nk + 4, n_z, B)
    zz = num.t(z)
    # along z at each k knot, then along log10 k
    at_z = spline_eval(zz, lp.movedim(1, 0), natural_second_derivatives(zz, lp.movedim(1, 0)), num.t(zq))
    at_z = at_z.movedim(0, 1)                                                           # (nk + 4, nzq, B)
    out = spline_eval(lk, at_z, natural_second_derivatives(lk, at_z), torch.log10(num.t(kq)))
    return (10.0 ** out).permute(2, 0, 1)


# ---- the configuration ---------------------------------------------------

@torch.inference_mode()       # no autograd records: a fifth less host time a call
def compute(params, config, dtype=np.float64):
    """``params``: (n,) arrays of the configuration's parameters (logA, n_s,
    h, omega_b, omega_cdm, m_ncdm [eV]). Returns pk_m and pk_cb (n, nkq *
    nzq), the emulator's tables (k major) flattened per row, and rs_drag
    [Mpc/h], z_drag and z_star (n,), in ``dtype``."""
    dt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    # the background and the recombination scan (a few rows, small operations) on the CPU, the
    # perturbations' lanes on the card where there is one
    host = Num(dt, torch.device('cpu'))
    num = Num(dt, torch.device('cuda') if torch.cuda.is_available() else torch.device('cpu'))
    fixed = config['fixed']
    n = len(params['h'])
    p = {name: host.t(params[name]) for name in ('logA', 'n_s', 'h', 'omega_b', 'omega_cdm', 'm_ncdm')}
    p.update((name, torch.full((n,), float(fixed[name]), dtype=dt)) for name in
             ('T_cmb', 'N_ur', 'T_ncdm_over_cmb', 'tau_reio', 'reionization_width', 'k_pivot'))
    bg = Background(p, host)
    rec = recombination(p, bg, host)
    scalars = {'z_star': rec['z_star'], 'z_drag': rec['z_drag'], 'rs_drag': bg.sound_horizon(rec['z_drag'])}
    p = {name: value.to(num.device) for name, value in p.items()}
    bg.omega_nc0 = bg.omega_nc0.to(num.device)
    rec = {name: value.to(num.device) for name, value in rec.items()}
    # the perturbations' neutrino: none in a row with a massless one
    massive = p['m_ncdm'] > 0
    pert = {'m_ncdm': torch.where(massive, p['m_ncdm'], 0.0), 'T_ncdm_over_cmb': p['T_ncdm_over_cmb'],
            'omega_ncdm': torch.where(massive, bg.omega_nc0, 0.0)}
    k_pk = np.geomspace(config['kmin_pk'], config['kmax_pk'], config['nk_pk'])
    z_pk = np.unique(np.concatenate([emulator_z(), [0.0]]))
    n_steps = tuple(config.get('n_steps', steps_for_kmax(config['kmax_pk'])))
    k = num.t(k_pk)[None] * p['h'][:, None]
    tr = transfers(p, pert, rec, k, z_pk, n_steps, num)
    A_s = torch.exp(p['logA']) * 1e-10
    prim = (2.0 * math.pi ** 2 / k ** 3 * A_s[:, None] * (k / p['k_pivot'][:, None]) ** (p['n_s'][:, None] - 1.0))
    h3 = p['h'][:, None, None] ** 3
    kq, zq = emulator_k(), emulator_z()
    out = {}
    for name, of in (('pk_m', 'delta_m'), ('pk_cb', 'delta_cb')):
        pk = prim[:, None] * tr[of] ** 2 * h3
        out[name] = on_emulator_grid(k_pk, z_pk, pk, kq, zq, num).reshape(n, -1)
    out.update(scalars)
    return {name: value.cpu().numpy() for name, value in out.items()}
