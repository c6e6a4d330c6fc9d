"""Recombination and reionization history (cosmoprimo_tpu/boltzmann/
thermodynamics.py), batched over cosmologies.

The effective three-level atom (Peebles 1968 with the RECFAST 1.14 case-B
fudge), the HeI singlet-channel ODE, Saha helium cascades and the
Compton-coupled matter temperature, on the static uniform ln(a) grid of the
JAX package, with a Crank-Nicolson/Newton step; then the tanh
reionization, the optical depths and the crossing redshifts. Tables are
batch + (N_GRID,), scalars the batch shape.

The HeI escape channel carries no extra multiplier (the JAX package's
default scale of 1; its environment knob is not carried). The Newton steps
take d/dx of the right-hand side in closed form where the JAX package takes
``jax.grad`` inside its scan; the closed form holds every
factor that depends on x and nothing else, so forward-mode AD flows through
the loop as it does through ``jax.jacfwd``. The scan's first steps (to
z > 8000, :func:`saha_steps`), where every output is the Saha value or the
temperature's attractor whatever the step carries, are made at once
(:func:`_saha_era`, the same values bit for bit); the rest runs through
:func:`~cosmoprimo_tpu_torch.ops.step_loop.step_loop` (a CUDA graph on the
card).
"""

import numpy as np
import torch

from .. import constants, tracing
from ..ops.quadrature import cumsum_blocked
from ..ops.roots import bisect
from ..ops.spline import interp
from ..ops.step_loop import CHUNK, step_loop

# ---- SI atomic constants (CODATA 2018 / RECFAST values), copied from the
# JAX package's module
sigma_thomson = 6.6524587321e-29        # m^2
m_electron = 9.1093837015e-31           # kg
m_hydrogen = 1.6737236e-27              # kg (RECFAST m_H)
not4 = 3.9715                           # m_He / m_H (RECFAST)
h_planck = 6.62607015e-34               # J s
a_radiation = 4.0 * constants.Stefan_Boltzmann / constants.c  # J m^-3 K^-4
lambda_lya = 1215.668e-10               # m, Lyman-alpha wavelength
lambda_2s1s = 8.2245809                 # 1/s, H 2s->1s two-photon rate
# ionization energies as temperatures [K] (RECFAST CB1, CDB, and He I/II)
B1_H = 1.57809e5                        # H ground state
B2_H = B1_H / 4.0                       # H n=2
E_alpha = B1_H - B2_H                   # Ly-alpha (exactly B1 - B2)
chi_HeI = 2.853157e5                    # He I first ionization (24.5874 eV)
chi_HeII = 6.31515e5                    # He II second ionization (54.4178 eV)
# HeI singlet-channel levels (RECFAST wavenumbers x hc/k -> temperatures)
_HCK = 1.43877688e-2                    # h c / k_B [m K]
L_He_2s = 1.66277434e7                  # 1/m, 2^1s excitation
L_He_2p = 1.71134891e7                  # 1/m, 2^1p excitation
chi_He_2s = (1.98310772e7 - L_He_2s) * _HCK   # ionization from 2^1s
E_He_2s = L_He_2s * _HCK                # 1^1s -> 2^1s excitation
E_He_2p2s = (L_He_2p - L_He_2s) * _HCK  # 2^1p - 2^1s split
lambda_He_2p = 1.0 / L_He_2p            # m, 58.4334 nm line
lambda_He_2s1s = 51.3                   # 1/s, He 2^1s->1^1s two-photon rate
_MPC = constants.megaparsec_over_m

# the static ln(a) grid: a in [1e-8, 1], 6144 intervals
N_GRID = 6145
LNA_GRID = np.linspace(np.log(1e-8), 0.0, N_GRID)
DLNA = float(LNA_GRID[1] - LNA_GRID[0])
# the scan's steps to z > SAHA_Z hold the Saha values and the matter
# temperature's attractor (see _saha_era)
SAHA_Z = 8000.0
# static index range with z > 50 (grid ordered early -> today)
_HIZ_SLICE = slice(0, int(np.sum(LNA_GRID <= np.log(1.0 / 51.0))))


def YHe_bbn(omega_b, N_eff=constants.NEFF):
    """Primordial helium mass fraction from standard BBN (local linear fit
    around the Planck point)."""
    return 0.2467 + 0.30 * (omega_b - 0.02237) + 0.013 * (N_eff - constants.NEFF)


def _lng(T):
    """1.5 ln(2 pi m_e k T / h^2)."""
    return 1.5 * torch.log(2.0 * np.pi * m_electron * constants.Boltzmann * T / h_planck ** 2)


def _saha_per_H(T, chi_K, n_H):
    """Saha right-hand side in electrons per hydrogen,
    (2 pi m_e k T / h^2)^{3/2} exp(-chi/T) / n_H, exponent clipped."""
    return torch.exp(torch.clamp(_lng(T) - chi_K / T - torch.log(n_H), -300.0, 300.0))


def saha_helium_III(T, n_H, f_He):
    """v = n_HeIII/n_He from Saha: (1 + f(1+v)) v / (1-v) = S."""
    S = _saha_per_H(T, chi_HeII, n_H)
    b = 1.0 + f_He + S
    return 2.0 * S / (b + torch.sqrt(b * b + 4.0 * f_He * S))


def saha_helium_II(T, n_H, f_He, x_H=1.0):
    """u = n_HeII/n_He from Saha (statistical factor 4)."""
    S = 4.0 * _saha_per_H(T, chi_HeI, n_H)
    b = x_H + S
    return 2.0 * S / (b + torch.sqrt(b * b + 4.0 * f_He * S))


def _saha_root(S, x_He_electrons):
    """x_H of x (x + x_He_e) / (1 - x) = S."""
    b = x_He_electrons + S
    return 2.0 * S / (b + torch.sqrt(b * b + 4.0 * S))


def saha_hydrogen(T, n_H, x_He_electrons=0.0):
    """x_H from Saha including the He electrons."""
    return _saha_root(_saha_per_H(T, B1_H, n_H), x_He_electrons)


def alpha_B(T_m, fudge=1.14):
    """Case-B recombination coefficient [m^3/s] (RECFAST fit) times the
    fudge."""
    t = T_m / 1e4
    return fudge * 1e-19 * 4.309 * t ** (-0.6166) / (1.0 + 0.6703 * t ** 0.5300)


def _beta2(T_m, fudge=1.14):
    """Photoionization rate from n = 2 [1/s] by detailed balance."""
    return alpha_B(T_m, fudge) * torch.exp(torch.clamp(_lng(T_m) - B2_H / T_m, -300.0, 300.0))


def alpha_HeI(T_m):
    """HeI singlet case-B recombination coefficient [m^3/s] (Verner &
    Ferland 1996 with the RECFAST parameters)."""
    s1 = torch.sqrt(T_m / 10.0 ** 5.114)
    s2 = torch.sqrt(T_m / 3.0)
    return 10.0 ** -16.744 / (s2 * (1.0 + s2) ** (1.0 - 0.711) * (1.0 + s1) ** (1.0 + 0.711))


def _beta_HeI(T_m):
    """HeI photoionization rate from 2^1s [1/s] by detailed balance."""
    return 4.0 * alpha_HeI(T_m) * torch.exp(torch.clamp(_lng(T_m) - chi_He_2s / T_m, -300.0, 300.0))


class ThermodynamicsResult(object):
    """Plain container for the history and the scalars: tables on the
    static ln(a) grid ``lna`` (x_e, x_e_rec, T_m [K], kappa_prime [1/Mpc],
    tau, tau_drag), batch + (N_GRID,); scalars z_star, z_drag,
    z_star_noreion, tau_reio, z_reio, YHe, f_He, n_H0, the batch shape."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


_grid_cache = {}


def _grid(device):
    """ln a on ``device``, copied there once."""
    if device not in _grid_cache:
        _grid_cache[device] = torch.from_numpy(LNA_GRID).to(device)
    return _grid_cache[device]


# the four Boltzmann factors of a step, exp(clip(c1 lng - c2 / T_m, lo, hi)):
# beta_HeI's, the HeI 2^1s excitation's, beta2's and Lyman-alpha's (unclipped),
# with the JAX package's bounds
_EXP_C1 = (1.0, 0.0, 1.0, 0.0)
_EXP_C2 = (chi_He_2s, E_He_2s, B2_H, E_alpha)
_EXP_LO = (-300.0, -300.0, -300.0, -np.inf)
_EXP_HI = (300.0, 0.0, 300.0, np.inf)


def _recombination_step(f_He, fudge):
    """The scan's step: (x_H, xhe, T_m) at grid point i - 1 to i, for
    :func:`step_loop`; the columns are those of :func:`compute_thermodynamics`.

    Each rate returns f = dx/dlna and, with ``deriv``, df/dx in closed form,
    where the Newton steps of the JAX package take ``jax.grad`` of the same
    expression. Every factor that depends on T_m alone is made once per
    step: T_m is the step's start value in both evaluations, as in the JAX
    package."""
    c1, c2, lo, hi = (torch.tensor(c, dtype=torch.float64, device=f_He.device)[:, None]
                      for c in (_EXP_C1, _EXP_C2, _EXP_LO, _EXP_HI))
    c = 0.5 * DLNA

    def newton(x0, f0, rate):
        base = x0 + c * f0
        x = x0 + DLNA * f0
        for _ in range(3):
            f, df = rate(x)
            x = x - (x - base - c * f) / (1.0 - c * df)
        return x

    def step(carry, cols, j):
        x_H, xhe, T_m = carry
        prev, cur = tuple(col[j] for col in cols), tuple(col[j + 1] for col in cols)
        expo = torch.exp(torch.clamp(c1 * _lng(T_m) - c2 / T_m, lo, hi))
        aHe, aB = alpha_HeI(T_m), alpha_B(T_m, fudge)
        bHe, b2 = 4.0 * aHe * expo[0], aB * expo[2]
        bexp_he, bexp_h = bHe * expo[1], b2 * expo[3]
        e2p2s = -E_He_2p2s / T_m
        L_bHe = lambda_He_2s1s + bHe
        # the factors of the current column, shared by the Newton steps
        aHn, aBn = aHe * cur[0], aB * cur[0]
        KLb2, Kb2 = cur[5] * (lambda_2s1s + b2), cur[5] * b2

        def he_rate(xhe, col, aHn, deriv=True):
            """dxHe/dlna, the RECFAST singlet-channel HeI ODE (Seager et al.
            2000; Wong, Moss & Scott 2008 eq. 2), and d/dxhe."""
            Hs, KHn = col[1], col[6]
            room = f_He - xhe
            KN = KHn * torch.clamp(room, min=0.0)
            KN_safe = torch.clamp(KN, min=1e-300)
            arg = e2p2s - torch.log(KN_safe)
            inv = torch.exp(torch.clamp(arg, -300.0, 300.0))
            den = L_bHe + inv
            C = (lambda_He_2s1s + inv) / den
            x_e = x_H + xhe
            net = bexp_he * room - aHn * x_e * xhe
            if not deriv:
                return C * net / Hs
            # ln(max(K n_He1s, 1e-300))' = -K n_H / (K n_He1s) inside both clips
            live = (KN > 1e-300) & (torch.abs(arg) < 300.0)
            dinv = inv * KHn / KN_safe * live
            dnet = -bexp_he - aHn * (x_e + xhe)
            return C * net / Hs, (bHe * dinv / (den * den) * net + C * dnet) / Hs

        def h_rate(x, col, xhe_e, aBn, KLb2, deriv=True):
            """dx_H/dlna, the Peebles ODE, and d/dx_H."""
            Hs = col[1]
            one_m = 1.0 - x
            n_1s = torch.clamp(one_m, min=0.0) * col[0]
            den = 1.0 + KLb2 * n_1s
            C = (1.0 + col[9] * n_1s) / den
            x_e = x + xhe_e
            net = bexp_h * one_m - aBn * x_e * x
            if not deriv:
                return C * net / Hs
            dnet = -bexp_h - aBn * (x_e + x)
            return C * net / Hs, (Kb2 * col[0] * (one_m > 0) / (den * den) * net + C * dnet) / Hs

        # HeI: Saha while u > 0.99, then the singlet-channel CN/Newton ODE
        f0 = he_rate(xhe, prev, aHe * prev[0], deriv=False)
        xhe_ode = newton(xhe, f0, lambda x: he_rate(x, cur, aHn))
        xhe_next = torch.where(cur[4] >= 0.0, cur[4], torch.clamp(torch.clamp(xhe_ode, min=0.0), max=f_He))
        xhe_e0 = torch.where(prev[3] >= 0.0, prev[3], xhe)
        xhe_e1 = torch.where(cur[3] >= 0.0, cur[3], xhe_next)

        # x_H: Saha -> ODE handoff at 0.985, then Crank-Nicolson with 3 Newton steps
        x_H_saha = _saha_root(cur[7], xhe_e1)
        f0 = h_rate(x_H, prev, xhe_e0, aB * prev[0], prev[5] * (lambda_2s1s + b2), deriv=False)
        x_ode = newton(x_H, f0, lambda x: h_rate(x, cur, xhe_e1, aBn, KLb2))
        x_next = torch.where(x_H_saha > 0.985, x_H_saha, torch.clamp(x_ode, 0.0, 1.0))

        # T_m: T' = -2T + A (T_g - T), CN exactly; attractor where A >> 1
        x_e0, x_e1 = x_H + xhe_e0, x_next + xhe_e1
        A0 = prev[8] * x_e0 / (1.0 + f_He + x_e0)
        A1 = cur[8] * x_e1 / (1.0 + f_He + x_e1)
        T_cn = (T_m * (1.0 - c * (2.0 + A0)) + c * (A0 * prev[2] + A1 * cur[2])) / (1.0 + c * (2.0 + A1))
        T_attract = cur[2] * (1.0 - 1.0 / torch.clamp(A1, min=2.0))
        T_next = torch.where(A1 > 50.0, T_attract, T_cn)
        return (x_next, xhe_next, T_next), (x_next, xhe_next, T_next)

    return step


def saha_steps():
    """The scan's first steps that :func:`_saha_era` makes at once: those
    to the grid points at z > SAHA_Z, in whole chunks of the step loop
    (3136 of the 6144)."""
    n = int(np.sum(LNA_GRID[1:] < -np.log1p(SAHA_Z)))
    return n - n % CHUNK


def _saha_era(f_He, cur):
    """The scan's steps to the grid points ``cur`` (the columns of
    :func:`compute_thermodynamics`, (n, B) each) where every lane holds the
    Saha values and the temperature's attractor: HeII Saha-bound (u > 0.99),
    x_H above the 0.985 handoff and the Compton coupling over 50 Hubble
    rates. There the step's outputs (x_H, xhe, T_m) take none of its carry,
    and they are made here at once by the step's own expressions, bit for
    bit. NaN where a lane is not in that regime, which the static
    SAHA_Z leaves to cosmologies far outside any fit."""
    xhe_next = cur[4]
    xhe_e1 = torch.where(cur[3] >= 0.0, cur[3], xhe_next)
    x_next = _saha_root(cur[7], xhe_e1)
    x_e1 = x_next + xhe_e1
    A1 = cur[8] * x_e1 / (1.0 + f_He + x_e1)
    T_next = cur[2] * (1.0 - 1.0 / torch.clamp(A1, min=2.0))
    held = (cur[4] >= 0.0) & (x_next > 0.985) & (A1 > 50.0)
    return tuple(torch.where(held, v, torch.nan) for v in (x_next, xhe_next, T_next))


def _batch(*values):
    """Broadcast per-cosmology values (tensors or floats) to one flat (B,)
    batch; returns the values and the batch shape."""
    device = next(v.device for v in values if isinstance(v, torch.Tensor))
    values = [torch.as_tensor(v, dtype=torch.float64, device=device) for v in values]
    shape = torch.broadcast_shapes(*(v.shape for v in values))
    return [v.expand(shape).reshape(-1) for v in values], shape


def compute_thermodynamics(omega_b, h, T_cmb, efunc_of_z, YHe=None, tau_reio=None, z_reio=None,
                           reionization_width=0.5, N_eff=constants.NEFF, fudge=1.14, graphs=True):
    """Ionization and temperature history and the derived scalars of a batch
    of cosmologies.

    ``omega_b``, ``h``, ``T_cmb`` (and ``YHe``, ``tau_reio``, ``z_reio``,
    ``reionization_width``, ``N_eff`` where given) are tensors of one batch
    shape, or floats. ``efunc_of_z(z)`` maps the (N_GRID,) redshift grid to
    E(z) = H(z)/H0, batch + (N_GRID,). Give ``tau_reio`` or ``z_reio``; with
    neither, tau_reio = 0.06. ``graphs``: replay the recombination scan from
    a CUDA graph on the card (see :func:`step_loop`). The call is the span
    ``cosmoprimo.thermodynamics``, which closes on the device
    (``tracing.span(..., sync=True)``)."""
    with tracing.span('cosmoprimo.thermodynamics', sync=True):
        return _compute_thermodynamics(omega_b, h, T_cmb, efunc_of_z, YHe, tau_reio, z_reio, reionization_width,
                                       N_eff, fudge, graphs)


def _compute_thermodynamics(omega_b, h, T_cmb, efunc_of_z, YHe, tau_reio, z_reio, reionization_width, N_eff, fudge,
                            graphs):
    (omega_b, h, T_cmb, width, N_eff), bshape = _batch(omega_b, h, T_cmb, reionization_width, N_eff)
    device = omega_b.device
    lna = _grid(device)
    a = torch.exp(lna)
    z = 1.0 / a - 1.0

    def flat(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device).expand(bshape).reshape(-1)

    Y = YHe_bbn(omega_b, N_eff) if YHe is None else flat(YHe)
    f_He = Y / (not4 * (1.0 - Y))

    # grid first, batch second: (N_GRID, B)
    rho_b0 = omega_b * constants.rho_crit_over_kgph_per_mph3
    n_H0 = (1.0 - Y) * rho_b0 / m_hydrogen
    n_H = n_H0 / a[:, None] ** 3
    T_gamma = T_cmb / a[:, None]
    E = efunc_of_z(z).reshape(-1, N_GRID).T
    H_s = 100.0 * h * E * 1e3 / _MPC

    v_HeIII = saha_helium_III(T_gamma, n_H, f_He)
    u_HeII = saha_helium_II(T_gamma, n_H, f_He)
    he3 = v_HeIII > 1e-6
    x_He_e_saha = f_He * torch.where(he3, 1.0 + v_HeIII, u_HeII)
    x_H_saha = saha_hydrogen(T_gamma, n_H, x_He_e_saha)

    # the scan's per-grid columns; -1 flags "no Saha override here"
    columns = (n_H, H_s, T_gamma,
               torch.where(he3, f_He * (1.0 + v_HeIII), -1.0),
               torch.where(u_HeII > 0.99, f_He * u_HeII, -1.0),
               lambda_lya ** 3 / (8.0 * np.pi * H_s),
               lambda_He_2p ** 3 / (8.0 * np.pi * H_s) * n_H,
               _saha_per_H(T_gamma, B1_H, n_H),
               8.0 * sigma_thomson * a_radiation * T_gamma ** 4 / (3.0 * m_electron * constants.c * H_s),
               lambda_lya ** 3 / (8.0 * np.pi * H_s) * lambda_2s1s)
    init = (x_H_saha[0], f_He * u_HeII[0], T_gamma[0])
    s0 = saha_steps()
    early = _saha_era(f_He, tuple(col[1:s0 + 1] for col in columns))
    _, late = step_loop(_recombination_step(f_He, fudge), tuple(t[-1] for t in early),
                        tuple(col[s0:] for col in columns), 'recombination', graphs=graphs)
    x_H_tab, xhe_tab, T_m_tab = (torch.cat([i[None], e, t]).T for i, e, t in zip(init, early, late))

    # batch first from here: (B, N_GRID)
    f = f_He[:, None]
    n_H, H_s = n_H.T, H_s.T
    x_e_rec = x_H_tab + torch.where(he3.T, f * (1.0 + v_HeIII.T), xhe_tab)

    # reionization: CAMB-style tanh in (1+z)^1.5 for H + HeII, plus HeII ->
    # HeIII at z = 3.5, width 0.5
    W_He2 = 0.5 * (1.0 + torch.tanh((3.5 - z) / 0.5))

    def x_e_with_reio(zre):
        y = (1.0 + z) ** 1.5
        y_re = (1.0 + zre[:, None]) ** 1.5
        dy = 1.5 * torch.sqrt(1.0 + zre[:, None]) * width[:, None]
        W = 0.5 * (1.0 + torch.tanh((y_re - y) / dy))
        return x_e_rec + torch.clamp(1.0 + f - x_e_rec, min=0.0) * W + f * W_He2

    def dtau_dlna(x_e):
        return x_e * n_H * sigma_thomson * constants.c / H_s

    def total(integrand):
        return torch.sum(0.5 * (integrand[:, 1:] + integrand[:, :-1]), dim=-1) * DLNA

    def cum_from_today(integrand):
        """int_{lna_i}^0 integrand d lna (reverse cumulative trapezoid)."""
        seg = 0.5 * (integrand[:, 1:] + integrand[:, :-1]) * DLNA
        return torch.cat([torch.flip(cumsum_blocked(torch.flip(seg, [-1])), [-1]),
                          seg.new_zeros(seg.shape[0], 1)], dim=-1)

    if z_reio is None:
        target = flat(0.06 if tau_reio is None else tau_reio)
        z_reio = bisect(lambda zre: total(dtau_dlna(x_e_with_reio(zre) - x_e_rec)) - target,
                        limits=(torch.full_like(target, 1.0), torch.full_like(target, 40.0)), xtol=1e-8,
                        method='bisection')
        tau_reio = target
    else:
        z_reio = flat(z_reio)
        tau_reio = None if tau_reio is None else flat(tau_reio)
    x_e_tab = x_e_with_reio(z_reio)
    if tau_reio is None:
        tau_reio = total(dtau_dlna(x_e_tab - x_e_rec))

    tau_tab = cum_from_today(dtau_dlna(x_e_tab))
    kappa_prime = x_e_tab * n_H * sigma_thomson * _MPC * a

    # drag depth: d tau_d = kappa'/R d eta, R = (3 omega_b / 4 omega_g) a
    omega_g = (T_cmb ** 4 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
               / constants.rho_crit_over_kgph_per_mph3)
    R = (3.0 * omega_b / (4.0 * omega_g))[:, None] * a
    tau_drag_tab = cum_from_today(dtau_dlna(x_e_tab) / R)

    # crossing redshifts on the static z > 50 slice: lna against -ln(tau)
    def crossing_z(tab, target):
        logt = torch.log(tab[:, _HIZ_SLICE])
        lna_cross = interp(-torch.log(target)[:, None], -logt, lna[_HIZ_SLICE])[:, 0]
        return 1.0 / torch.exp(lna_cross) - 1.0

    one = torch.ones_like(omega_b)
    z_star = crossing_z(tau_tab, one)
    z_drag = crossing_z(tau_drag_tab, one)
    z_star_noreion = crossing_z(tau_tab, 1.0 + tau_reio)

    def scalar(v):
        return v.reshape(bshape)

    def table(v):
        return v.reshape(bshape + (N_GRID,))

    return ThermodynamicsResult(
        lna=lna, z_grid=z, x_e=table(x_e_tab), x_e_rec=table(x_e_rec), T_m=table(T_m_tab),
        kappa_prime=table(kappa_prime), tau=table(tau_tab), tau_drag=table(tau_drag_tab),
        z_star=scalar(z_star), z_drag=scalar(z_drag), z_star_noreion=scalar(z_star_noreion),
        tau_reio=scalar(tau_reio), z_reio=scalar(z_reio), YHe=scalar(Y), f_He=scalar(f_He), n_H0=scalar(n_H0))
