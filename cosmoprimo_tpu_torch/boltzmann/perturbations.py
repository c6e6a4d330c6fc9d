"""Linear cosmological perturbations (cosmoprimo_tpu/boltzmann/
perturbations.py): the Ma & Bertschinger (1995) Einstein-Boltzmann system in
the conformal Newtonian gauge, batched over cosmologies.

Each cosmology b and mode k is a lane: the state is one (n_state, B, nk)
float64 tensor, every operation is elementwise over the lanes or a static
slice over the state axis. Each lane has its own fixed-length time grid (two
RK4 phases of static length), the stiff regimes are algebraic projections
(tight coupling, radiation streaming, Poisson pinning) blended per lane with
``torch.where``, and the outputs at the requested redshifts are harvested
inside the loops by per-step linear blending, as in the JAX package. In the
streaming phase the massive-neutrino fluid is pinned to its quasi-static
values on the steps that leave its waves unresolved (:func:`_ncdm_unresolved`:
a light neutrino at high k), where the JAX package's integration grows
without bound. The two phases run through
:func:`~cosmoprimo_tpu_torch.ops.step_loop.step_loop` (CUDA graphs on the
card); the same loop can emit rows of every step's end
state instead (the line-of-sight source taps of the CMB spectra,
:func:`compute_los_sources`, and the series of
:func:`compute_perturbation_series`).

Per-cosmology scalars of the tables (``tabs``) have shape (B, 1), so that
they broadcast against the (B, nk) lanes. The factors that depend on k and
the curvature only (the hierarchies' couplings) are made once per run in
:class:`Lanes`; those that depend on a(eta) only (the massive-neutrino
momenta) once per table fetch, and shared by the RK4 stages that use it.

Normalization: comoving curvature R = 1; transfers in the CDM-comoving
synchronous gauge, delta^syn_i = delta^N_i + 3 aH (1 + w_i) theta_c / k^2.
"""

import numpy as np
import torch

from .. import constants, tracing
from ..ops import cumsum_blocked, gauss_laguerre_nodes, interp, linspace_rows
from ..ops.step_loop import step_loop
from . import thermodynamics as _thermo

# hierarchy truncations, the JAX package's defaults
LMAX_G = 11       # photon temperature
LMAX_POL = 11     # photon polarization
LMAX_UR = 17      # massless neutrinos
LMAX_NCDM = 8     # massive neutrinos: Psi_0..Psi_LMAX_NCDM per q-bin
NQ_NCDM = 5       # Gauss-Laguerre momentum bins
# the closures, the first-order tight coupling and the streaming projections
# read multipoles 0..4 of the photons and 0..3 of the massless neutrinos
assert LMAX_G >= 4 and LMAX_POL >= 4 and LMAX_UR >= 3

N_STEPS_A = 10240  # full-hierarchy phase
N_STEPS_B = 6144   # streaming phase
M_TAB = 8192       # uniform-ln(eta) coefficient tables

ALPHA_PHASE = 0.5  # deta <= ALPHA/k
BETA_LN = 0.004    # deta <= BETA eta
KAPPA_SAFE = 0.45  # deta <= KAPPA_SAFE * 2.8 / kappa' in the release band
TCA_TRIGGER_AH = 120.0   # tight coupling while kappa' > 120 aH ...
TCA_TRIGGER_K = 50.0     # ... and kappa' > 50 k
RSA_KETA = 45.0    # streaming once k eta > 45 and eta > eta(z ~ 900)
POISSON_KAH = 2.5  # pin phi to the Poisson constraint where k > 2.5 aH
_R_CLOSED_MAX = 0.2  # bound on K/k^2 (closed); open (K < 0) is unclamped

_C_KMS = constants.c / 1e3


def steps_for_kmax(kmax_mpc):
    """Step and table budget (n_steps_a, n_steps_b, m_tab) for a static kmax
    [1/Mpc], the JAX package's tiers."""
    kmax_mpc = float(kmax_mpc)
    if kmax_mpc <= 0.9:
        return 2560, 1280, 4096
    if kmax_mpc <= 3.6:
        return 8192, 4096, 8192
    return N_STEPS_A, N_STEPS_B, M_TAB


# state layout (per lane)
_I_PHI, _I_DC, _I_TC, _I_DB, _I_TB, _I_DG, _I_TG = 0, 1, 2, 3, 4, 5, 6
_I_DDE, _I_TDE = 7, 8          # dark-energy fluid delta, theta
_I_FG = 9                      # F_gamma_2 .. F_gamma_LMAX_G   (LMAX_G-1)
_I_GP = _I_FG + (LMAX_G - 1)   # G_0 .. G_LMAX_POL             (LMAX_POL+1)
_I_UR = _I_GP + (LMAX_POL + 1)  # F_ur_0 .. F_ur_LMAX_UR       (LMAX_UR+1)
_I_NC = _I_UR + (LMAX_UR + 1)  # Psi_{s,q,l}: NS * NQ * (LMAX_NCDM+1)


def _n_state(ns):
    """State length for ``ns`` massive-neutrino species."""
    return _I_NC + ns * NQ_NCDM * (LMAX_NCDM + 1)


N_STATE = _n_state(1)


def _ncdm_q():
    """Gauss-Laguerre q-grid, Fermi-Dirac weights w_fd = w e^q f0 and
    dln f0/dln q, rescaled so that the quadrature satisfies
    int q^4 f0' dq = -4 int q^3 f0 dq exactly (numpy)."""
    q, w = gauss_laguerre_nodes(NQ_NCDM)
    f0 = 1.0 / (np.exp(q) + 1.0)
    w_fd = w * np.exp(q) * f0
    dlnf0 = -q / (1.0 + np.exp(-q))
    scale = -4.0 * np.sum(w_fd * q ** 3) / np.sum(w_fd * q ** 3 * dlnf0)
    return q, w_fd, dlnf0 * scale


def _gradient(f, h):
    """``jnp.gradient(f) / h`` along the last axis (one-sided edges)."""
    return torch.cat([f[..., 1:2] - f[..., :1], (f[..., 2:] - f[..., :-2]) * 0.5,
                      f[..., -1:] - f[..., -2:-1]], dim=-1) / h


_STACK_NAMES = ('lna', 'Hc', 'kp', 'cb2', 'fg', 'fur', 'fc', 'fb', 'fnc',
                'fde', 'w_nc', 'dw_nc', 'w_de')
# rows 1..9 are stored as ln(x): linear interpolation of the log removes the
# convexity bias the superhorizon phi' cancellation amplifies
_LOG_ROWS = slice(1, 10)


def build_tables(params, thermo, m_tab=None):
    """Uniform-ln(eta) coefficient tables of a batch of cosmologies.

    ``params``: dict of batch tensors (B,) omega_b, omega_cdm, h, T_cmb,
    N_ur, T_ncdm_over_cmb, omega_ncdm, w0_fld, wa_fld, omega_k (optional,
    default 0) and m_ncdm (ns, B), masses in eV at a common temperature.
    ``thermo``: a :class:`~.thermodynamics.ThermodynamicsResult` of the same
    batch. Tables are (B, m_tab), per-cosmology scalars (B, 1), ``stack`` the
    fetch targets (13, B, m_tab), ``am`` (ns, B, 1)."""
    if m_tab is None:
        m_tab = M_TAB
    h, T_cmb = params['h'][:, None], params['T_cmb'][:, None]
    device = h.device
    omega_g = (T_cmb ** 4 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
               / constants.rho_crit_over_kgph_per_mph3)
    omega_ur = params['N_ur'][:, None] * 7.0 / 8.0 * (4.0 / 11.0) ** (4.0 / 3.0) * omega_g
    omega_b, omega_c = params['omega_b'][:, None], params['omega_cdm'][:, None]

    # master ln a grid, extended to a = 1e-9 for high-k initial conditions
    lna_np = np.linspace(np.log(1e-9), 0.0, 2 * m_tab + 1)
    dlna = float(lna_np[1] - lna_np[0])
    lna = torch.from_numpy(lna_np).to(device)
    a = torch.exp(lna)

    # ncdm energy and pressure on the evolution's 5-point GL grid, summed
    # over the species (a common temperature)
    q, w_fd, _ = (torch.from_numpy(v).to(device) for v in _ncdm_q())
    T_ncdm_eV = (params['T_ncdm_over_cmb'] * params['T_cmb']) * 8.617333262e-5
    am = params['m_ncdm'] / T_ncdm_eV                                     # (NS, B)
    eps = torch.sqrt(q ** 2 + ((a[:, None] * am.T[:, None, :])[..., None]) ** 2)   # (B, n, NS, NQ)
    I_rho = torch.sum(w_fd * q ** 2 * eps, dim=(-2, -1))                  # (B, n)
    I_p = torch.sum(w_fd * q ** 4 / eps, dim=(-2, -1)) / 3.0
    I_rho0 = I_rho[:, -1:]
    has_ncdm = (torch.sum(am, dim=0) > 0)[:, None]
    omega_nc0 = params['omega_ncdm'][:, None]

    om_g = omega_g / a ** 4
    om_ur = omega_ur / a ** 4
    om_c = omega_c / a ** 3
    om_b = omega_b / a ** 3
    # spatial curvature K = -omega_k (H0/c)^2 [Mpc^-2]: geometry, not a density
    omega_kc = params['omega_k'][:, None] if 'omega_k' in params else torch.zeros_like(h)
    K_curv = -omega_kc * (100.0 / _C_KMS) ** 2
    om_nc = torch.where(has_ncdm, omega_nc0 * (I_rho / I_rho0) / a ** 4, 0.0)
    om_nc_p = torch.where(has_ncdm, omega_nc0 * (I_p / I_rho0) / a ** 4, 0.0)
    w0, wa = params['w0_fld'][:, None], params['wa_fld'][:, None]
    omega_de0 = (h ** 2 - omega_kc - omega_g - omega_ur - omega_c - omega_b
                 - torch.where(has_ncdm, omega_nc0, 0.0))
    om_de = omega_de0 * a ** (-3.0 * (1.0 + w0 + wa)) * torch.exp(3.0 * wa * (a - 1.0))
    om_tot = om_g + om_ur + om_c + om_b + om_nc + om_de

    # conformal Hubble [1/Mpc]; Hc^2 + K = (8 pi G / 3) a^2 rho_tot
    Hc = a * 100.0 * torch.sqrt(om_tot + omega_kc / a ** 2) / _C_KMS
    deta = 1.0 / Hc
    eta = torch.cat([torch.zeros_like(h), cumsum_blocked(0.5 * (deta[:, 1:] + deta[:, :-1]) * dlna)], dim=-1)
    eta = eta + 1.0 / Hc[:, :1]

    # kappa' and T_b from the thermodynamics grid; analytic fully-ionized
    # extension below its a = 1e-8 start
    lna_th = torch.from_numpy(_thermo.LNA_GRID).to(device)
    f_He, n_H0 = thermo.f_He.reshape(-1, 1), thermo.n_H0.reshape(-1, 1)
    kappa_th, T_m_th, x_e_th = (v.reshape(h.shape[0], -1) for v in (thermo.kappa_prime, thermo.T_m, thermo.x_e))
    early = lna < lna_th[0]
    xe_early = 1.0 + 2.0 * f_He
    kp_early = xe_early * n_H0 * _thermo.sigma_thomson * constants.megaparsec_over_m / torch.exp(lna) ** 2
    kp = torch.where(early, kp_early, interp(lna, lna_th, kappa_th))
    T_m = torch.where(early, T_cmb / a, interp(lna, lna_th, T_m_th))
    # baryon sound speed^2: (k_B T / mu m_H c^2)(1 - dlnT/dlna / 3)
    mu_mH = (1.0 + _thermo.not4 * f_He) / (1.0 + f_He + interp(lna, lna_th, x_e_th))
    dlnT = _gradient(torch.log(T_m), dlna)
    cb2 = (constants.Boltzmann * T_m / (mu_mH * _thermo.m_hydrogen * constants.c ** 2) * (1.0 - dlnT / 3.0))

    # everything resampled on a uniform ln(eta) grid per cosmology
    lneta_m = torch.log(eta)
    lneta = linspace_rows(lneta_m[:, 0], lneta_m[:, -1], m_tab)

    def res(x):
        return interp(lneta, lneta_m, x)

    w_nc = torch.where(om_nc > 0, om_nc_p / torch.clamp(om_nc, min=1e-300), 0.0)
    dw = _gradient(w_nc, dlna)
    tabs = {
        'lneta0': lneta[:, :1], 'dlneta': lneta[:, 1:2] - lneta[:, :1], 'lneta': lneta,
        'lna': res(lna.expand(h.shape[0], -1)), 'Hc': res(Hc), 'kp': res(kp), 'cb2': res(cb2),
        'fg': res(om_g / om_tot), 'fur': res(om_ur / om_tot), 'fc': res(om_c / om_tot), 'fb': res(om_b / om_tot),
        'fnc': res(om_nc / om_tot), 'fde': res(om_de / om_tot), 'w_nc': res(w_nc), 'dw_nc': res(dw),
        'w_de': w0 + wa * (1.0 - res(torch.exp(lna).expand(h.shape[0], -1))),
        'I_rho_ratio': res(I_rho / I_rho0),
        'eta0': eta[:, -1:], 'eta_ini_min': eta[:, :1] * 1.05, 'am': am[..., None],
        'wa_fld': wa, 'cs2_fld': params['cs2_fld'][:, None] if 'cs2_fld' in params else torch.ones_like(h),
        'K': K_curv,
        # latest allowed start: a = 1e-7 (matter fraction ~3e-4)
        'eta_rd': interp(torch.full_like(h, np.log(1e-7)), lna, eta),
    }
    rows = [tabs[n] for n in _STACK_NAMES]
    stack = torch.stack(rows)
    tabs['stack'] = torch.cat([stack[:1], torch.log(torch.clamp(stack[_LOG_ROWS], min=1e-300)), stack[10:]])
    return tabs


def _fetch(tabs, eta, lanes=None, rates=False):
    """The stacked tables at per-lane ``eta`` (..., B, nk): index arithmetic
    on the uniform ln(eta) grid, log-stored rows exponentiated back; the
    leading axes (grid points) are free. With ``lanes`` (a :class:`Lanes`),
    also a and the massive-neutrino factors at a(eta): eps, the moment
    weights W0 = w q^2 eps and W2 = w q^4 / eps, and I_rho = sum W0,
    (..., ns, NQ, B, nk) and (..., B, nk). With ``rates``, also 'rate', the
    d/deta of each stacked quantity: the slope of the segment the fetch
    picks, zero where the blend weight is clipped and half of it on the
    clip's edge, as forward mode through the JAX package's fetch gives."""
    lead, (B, nk) = eta.shape[:-2], eta.shape[-2:]
    x = (torch.log(eta) - tabs['lneta0']) / tabs['dlneta']
    s = tabs['stack']
    Q = s.shape[0]
    i = torch.clamp(x.to(torch.int32), 0, s.shape[-1] - 2).to(torch.int64)
    u = x - i
    w = torch.clamp(u, 0.0, 1.0)
    i = i.movedim(-2, 0).reshape(B, -1).expand(Q, B, -1)

    def take(j):
        return torch.gather(s, 2, j).reshape((Q, B) + lead + (nk,)).movedim(1, -2)

    lo, hi = take(i), take(i + 1)
    vals = lo * (1.0 - w) + hi * w
    out = {'lna': vals[0], 'w_nc': vals[10], 'dw_nc': vals[11], 'w_de': vals[12]}
    out.update(zip(_STACK_NAMES[1:10], torch.exp(vals[_LOG_ROWS])))
    out['wa_fld'], out['cs2_fld'], out['K'] = tabs['wa_fld'], tabs['cs2_fld'], tabs['K']
    if rates:
        inside = torch.where((u > 0.0) & (u < 1.0), 1.0, torch.where((u == 0.0) | (u == 1.0), 0.5, 0.0))
        dw = inside / (eta * tabs['dlneta'])
        dv = lo * -dw + hi * dw          # the JAX package's forward-mode arithmetic
        rate = {'lna': dv[0], 'w_nc': dv[10], 'dw_nc': dv[11], 'w_de': dv[12]}
        rate.update((name, out[name] * dv[j]) for j, name in enumerate(_STACK_NAMES[1:10], 1))
        out['rate'] = rate
    if lanes is not None:
        a = out['a'] = torch.exp(out['lna'])
        eps = out['eps'] = torch.sqrt(lanes.q2 + (a[..., None, None, :, :] * lanes.am[:, None]) ** 2)
        out['W0'] = lanes.w2 * eps
        out['W2'] = lanes.w2q2 / eps
        out['I_rho'] = torch.sum(out['W0'], dim=(-4, -3))
    return out


def _s_table(L, K, k):
    """s_l = sqrt(1 - (l^2 - 1) K/k^2) for l = 0..L+1, (L+2,) + k.shape:
    the curved hierarchy couplings, zero where closed space cuts the
    multipole off, K/k^2 saturated at _R_CLOSED_MAX."""
    l = torch.arange(L + 2, dtype=k.dtype, device=k.device).reshape((-1,) + (1,) * k.dim())
    r = torch.clamp(K / k ** 2, max=_R_CLOSED_MAX)
    return torch.sqrt(torch.clamp(1.0 - (l * l - 1.0) * r, min=0.0))


def _ladder(L, s, pre):
    """Coefficients of the free-streaming ladder
    dX_l = pre/(2l+1) (l s_l X_{l-1} - (l+1) s_{l+1} X_{l+1}), l = 0..L,
    with the MB95 eq. 65 closure X_{L+1} = (2L+1)/(pre eta) X_L - X_{L-1}
    folded in: (down, up), each (L+1,) + lanes, where up_L = 0 and down_L
    gains up_L; the closure's diagonal term, -(L+1) s_{L+1} / eta X_L, is
    the caller's."""
    l = torch.arange(L + 1, dtype=s.dtype, device=s.device).reshape((-1,) + (1,) * (s.dim() - 1))
    down = pre / (2.0 * l + 1.0) * (l * s[:L + 1])
    up = pre / (2.0 * l + 1.0) * ((l + 1.0) * s[1:L + 2])
    down = torch.cat([down[:-1], (down[-1] + up[-1])[None]])
    return down, torch.cat([up[:-1], torch.zeros_like(up[-1:])])


class Lanes(object):
    """The factors of a run that depend on k and the curvature only, made
    once: ``k`` (B, nk) in 1/Mpc, the hierarchies' couplings (the ladders of
    rows F_gamma_2 .. F_ur_L in one, and of one massive-neutrino block) and
    the momentum grid."""

    def __init__(self, tabs, k):
        self.k = k
        self.k2 = k ** 2
        K = tabs['K']
        self.am = tabs['am']                                   # (ns, B, 1)
        self.ns = self.am.shape[0]
        q, w_fd, dlnf0 = (torch.from_numpy(v).to(k.device).reshape(-1, 1, 1) for v in _ncdm_q())
        self.q, self.q2, self.dlnf0 = q, q ** 2, dlnf0
        self.w2 = w_fd * q ** 2
        self.w2q, self.w2q2 = self.w2 * q, self.w2 * q ** 2
        r = torch.clamp(K / self.k2, max=_R_CLOSED_MAX)
        self.s2sq = 1.0 - 3.0 * r
        s_g, s_p, s_u, s_n = (_s_table(L, K, k) for L in (LMAX_G, LMAX_POL, LMAX_UR, LMAX_NCDM))
        self.s2 = s_g[2]
        # rows F_gamma_2..L, G_0..L, F_ur_0..L: F_gamma_1 enters as a source
        down_g, up_g = _ladder(LMAX_G, s_g, k)
        down_p, up_p = _ladder(LMAX_POL, s_p, k)
        down_u, up_u = _ladder(LMAX_UR, s_u, k)
        self.f1 = down_g[2] * 4.0 / (3.0 * k)                  # d F_2 / d theta_g through F_1
        self.down1 = torch.cat([torch.zeros_like(down_g[2:3]), down_g[3:], down_p, down_u])
        self.up1 = torch.cat([up_g[2:], up_p, up_u])
        self.closure1 = torch.stack([(L + 1.0) * s[L + 1] for L, s in ((LMAX_G, s_g), (LMAX_POL, s_p),
                                                                         (LMAX_UR, s_u))])
        # one massive-neutrino block (pre = q k / eps is applied per fetch)
        down_n, up_n = _ladder(LMAX_NCDM, s_n, torch.ones_like(k))
        self.down_n = down_n.repeat(self.ns * NQ_NCDM, 1, 1)
        self.up_n = up_n.repeat(self.ns * NQ_NCDM, 1, 1)
        self.closure_n = (LMAX_NCDM + 1.0) * s_n[LMAX_NCDM + 1]
        self.k43 = (4.0 / 3.0) * k
        # the streaming switch k eta > 45 as eta > 45 / k: phase A ends on it
        self.eta_rsa = RSA_KETA / k


def _coefs_a(c, lanes, eta, steps=None):
    """The phase-A coefficients at the fetched points ``c`` and ``eta``
    (..., B, nk): the switches and every factor of :func:`deriv_full` and
    the projections that does not depend on the state. Adds them to ``c``.
    ``steps`` (the RK4 loop's, see :func:`_coefs_b`) is not read: the drag
    map's factors, which depend on the step, are made per step
    (:func:`_drag_coefs`)."""
    k, k2, K = lanes.k, lanes.k2, c['K']
    Hc, kp, cb2 = c['Hc'], c['kp'], c['cb2']
    fg, fur, fc, fb, fnc, fde, w_de = c['fg'], c['fur'], c['fc'], c['fb'], c['fnc'], c['fde'], c['w_de']
    tca = c['tca'] = (kp > TCA_TRIGGER_AH * Hc) & (kp > TCA_TRIGGER_K * k)
    rsa = c['ur_rsa'] = eta > lanes.eta_rsa
    G2 = Hc ** 2 + K
    G2k2 = G2 / k2
    I_rho = c['I_rho'][..., None, None, :, :]
    fnc5 = fnc[..., None, None, :, :]
    c.update(
        # metric: psi = phi - mpsi stress, phi' = rfac (-Hc psi + g15 S_theta)
        mpsi=4.5 * (G2k2 / lanes.s2sq), sg=torch.where(tca, 0.0, (2.0 / 3.0) * fg),
        su=torch.where(rsa, 0.0, (2.0 / 3.0) * fur), S2w=fnc5 * (2.0 / 3.0) * c['W2'] / I_rho,
        T1w=fnc5 * k * lanes.w2q / I_rho, D0w=fnc5 * c['W0'] / I_rho,
        thg=(4.0 / 3.0) * fg, thde=fde * (1.0 + w_de), thu=torch.where(rsa, 0.0, fur * k),
        g15=1.5 * G2k2, rfac=torch.where(rsa, 1.0 / (1.0 - 6.0 * G2k2 * fur), 1.0),
        # photon-baryon fluid and the first-order tight coupling
        gtca=lanes.s2 * (32.0 / 45.0) / kp, cb2k2=cb2 * k2)
    opw = 1.0 + w_de
    cs2 = c['cs2_fld']
    R = (4.0 / 3.0) * fg / fb
    wtot = (fg + fur) / 3.0 + c['w_nc'] * fnc + w_de * fde
    c.update(
        e1=-opw, e2=-3.0 * Hc * (cs2 - w_de),
        e3=-9.0 * Hc ** 2 * (cs2 * opw - (w_de * opw + c['wa_fld'] * torch.exp(c['lna']) / 3.0)) / k2,
        f1=-Hc * (1.0 - 3.0 * cs2), f2=cs2 * k2 * (opw / (opw * opw + 1e-24)),
        R=R, inv1R=1.0 / (1.0 + R), sl1=(2.0 * R / (1.0 + R)) * Hc, sl2=R / (kp * (1.0 + R)),
        a_tb=-(Hc ** 2 - 0.5 * G2 * (1.0 + 3.0 * wtot)), a_dg=-0.5 * Hc * k2, a_psi=-Hc * k2,
        # ladders: scattering and closures
        kp01=0.1 * kp, kp05=0.5 * kp, clos=lanes.closure1 / eta[..., None, :, :],
        clos_n=lanes.closure_n / eta, qe=lanes.q * k / c['eps'],
        src1n=-(c['eps'] * k / (3.0 * lanes.q)) * lanes.dlnf0,
        # projections: Poisson pin and tight-coupling slip
        pin=k > POISSON_KAH * Hc, pc1=-1.5 * (G2 / (k2 * lanes.s2sq)), pc2=3.0 * Hc / k2,
        tqs=1.0 / (kp * (1.0 + R)))
    return c


def _interp_lanes(x, xp, fp):
    """``jnp.interp`` per lane: ``x`` (B, nk, m) queries, ``xp`` and ``fp``
    (B, nk, M) or (B, 1, M) (one grid per cosmology, shared by its modes).
    Returns (B, nk, m)."""
    B, nk, m = x.shape
    n = max(xp.shape[-1], fp.shape[-1])
    if xp.shape[1] == 1:
        i = torch.searchsorted(xp[:, 0].contiguous(), x.reshape(B, nk * m).contiguous(), right=True).reshape(B, nk, m)
    else:
        i = torch.searchsorted(xp, x.contiguous(), right=True)
    i = torch.clamp(i, 1, n - 1)

    def take(a, j):
        return torch.gather(a.expand(B, nk, a.shape[-1]), -1, j)

    x0, x1, f0, f1 = take(xp, i - 1), take(xp, i), take(fp, i - 1), take(fp, i)
    dx = x1 - x0
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def _cum_density(dens, eta_m):
    """Cumulative trapezoid of a step density (B, nk, M) on eta_m (B, M)."""
    seg = 0.5 * (dens[..., 1:] + dens[..., :-1]) * torch.diff(eta_m, dim=-1)[:, None, :]
    return torch.cat([torch.zeros_like(dens[..., :1]), cumsum_blocked(seg)], dim=-1)


def _grid_on(s, eta_mm, start, end, n):
    """The n + 1 points (B, nk, n + 1) uniform in the cumulative step density
    ``s`` (B, nk, M) from eta ``start`` to ``end`` (B, nk), on the master
    grid ``eta_mm`` (B, 1, M)."""
    s_ini, s_end = (_interp_lanes(e[..., None], eta_mm, s) for e in (start, end))
    idx = torch.arange(n + 1, dtype=torch.float64, device=s.device) / n
    return _interp_lanes(s_ini + (s_end - s_ini) * idx, s, eta_mm)


def build_time_grids(tabs, k, n_steps_a=None, n_steps_b=None):
    """Per-lane integration grids (eta_A, eta_B, eta_ini): (B, nk, N + 1)
    for both phases and (B, nk). ``k`` (B, nk) in 1/Mpc.

    Step density on the master grid: rho = max(k/ALPHA, 1/(BETA eta),
    kappa'/(2.8 KAPPA_SAFE) where tight coupling is off); its cumulative
    integral maps a uniform index grid onto eta by interpolation."""
    if n_steps_a is None:
        n_steps_a = N_STEPS_A
    if n_steps_b is None:
        n_steps_b = N_STEPS_B
    eta_m = torch.exp(tabs['lneta'])                     # (B, M)
    kpm, Hcm = tabs['kp'][:, None, :], tabs['Hc'][:, None, :]
    eta0 = tabs['eta0']
    kk = k[..., None]                                     # (B, nk, 1)
    tca_off = (kpm < TCA_TRIGGER_AH * Hcm) | (kpm < TCA_TRIGGER_K * kk)
    dens = torch.maximum(kk / ALPHA_PHASE, (1.0 / (BETA_LN * eta_m))[:, None, :])
    dens = torch.maximum(dens, torch.where(tca_off, kpm / (2.8 * KAPPA_SAFE), 0.0))
    s = _cum_density(dens, eta_m)
    del dens, tca_off

    eta_ini = torch.clamp(torch.clamp(0.03 / k, min=tabs['eta_ini_min']), max=tabs['eta_rd'])
    eta_dec = interp(torch.full_like(eta0, np.log(1.0 / 901.0)), tabs['lna'], eta_m)   # eta(z = 900)
    eta_Aend = torch.clamp(torch.clamp(RSA_KETA / k, min=eta_dec), max=eta0)
    eta_mm = eta_m[:, None, :]
    # phase A ends, and phase B starts, exactly at eta_Aend (see Lanes.eta_rsa)
    eta_A = torch.cat([_grid_on(s, eta_mm, eta_ini, eta_Aend, n_steps_a)[..., :-1], eta_Aend[..., None]], dim=-1)
    del s

    # phase B: ln-eta sampling plus the massive-neutrino acoustic phase
    # (the fluid is still semi-relativistic at handoff)
    w_nc = tabs['w_nc']
    cg2m = torch.clamp(w_nc - tabs['dw_nc'] / (3.0 * (1.0 + w_nc)), min=0.0)
    densB = torch.maximum((1.0 / (BETA_LN * eta_m))[:, None, :], kk * torch.sqrt(cg2m)[:, None, :] / 2.4)
    sB = _cum_density(densB, eta_m)
    del densB
    eta_end = (eta0 * (1.0 + 1e-9)).expand(eta_Aend.shape)
    eta_B = torch.minimum(_grid_on(sB, eta_mm, eta_Aend, eta_end, n_steps_b), (eta0 * (1.0 + 1e-9))[..., None])
    return eta_A, torch.cat([eta_Aend[..., None], eta_B[..., 1:]], dim=-1), eta_ini


def adiabatic_ics(tabs, lanes, eta_ini):
    """MB95 eq. 98 adiabatic initial conditions with C = 1/2 (comoving
    curvature R = 1): the state (n_state, B, nk) at ``eta_ini`` (B, nk)."""
    k = lanes.k
    c = _fetch(tabs, eta_ini)
    frad = c['fg'] + c['fur'] + c['fnc']
    Rnu = (c['fur'] + c['fnc']) / frad
    r_str = lanes.s2 / lanes.s2sq
    C = 0.5
    psi = 20.0 * C / (15.0 + 4.0 * r_str * Rnu)
    phi = (1.0 + 2.0 / 5.0 * r_str * Rnu) * psi
    dg = -2.0 * psi
    # the MB95 series' eta is the radiation-era conformal time 1/(aH)
    eta_rd_ic = 1.0 / c['Hc']
    th = 0.5 * (k ** 2 * eta_rd_ic) * psi
    sig_nu = lanes.s2 * (k * eta_rd_ic) ** 2 / 15.0 * psi
    zero = torch.zeros_like(k)
    rows = [phi, 0.75 * dg, th, 0.75 * dg, th, dg, th,
            0.75 * (1.0 + c['w_de']) * dg, th]                      # the DE fluid: adiabatic
    rows += [zero] * (_I_UR - _I_FG)
    rows += [dg, 4.0 * th / (3.0 * k), 2.0 * sig_nu] + [zero] * (LMAX_UR - 2)
    # ncdm: Psi_0 = -(delta/4) dlnf0, Psi_1 = -(eps/(3qk)) theta dlnf0, Psi_2 = -(sigma/2) dlnf0
    q, _, dlnf0 = _ncdm_q()
    a_ini = torch.exp(interp(torch.log(eta_ini), tabs['lneta'], tabs['lna']))
    for s in range(lanes.ns):
        for j in range(NQ_NCDM):
            eps = torch.sqrt(q[j] ** 2 + (a_ini * lanes.am[s]) ** 2)
            rows += [-0.25 * dg * dlnf0[j], -(eps / (3.0 * q[j] * k)) * th * dlnf0[j], -0.5 * sig_nu * dlnf0[j]]
            rows += [zero] * (LMAX_NCDM - 2)
    return torch.stack(rows)


def _psi_nc(y, lanes):
    """The massive-neutrino hierarchies of the state, (ns, NQ, L+1, B, nk)."""
    return y[_I_NC:].reshape((lanes.ns, NQ_NCDM, LMAX_NCDM + 1) + y.shape[1:])


def _wsum(w, x):
    """sum over (species, q) of w x, (ns, NQ, B, nk) -> (B, nk)."""
    return torch.sum(w * x, dim=(0, 1))


def _stress(y, lanes, c):
    """The anisotropic stress of the metric constraint, linear in the state
    with the coefficients ``c`` (or their rates, see :func:`_psi_rates_a`)."""
    return c['sg'] * y[_I_FG] + c['su'] * y[_I_UR + 2] + _wsum(c['S2w'], _psi_nc(y, lanes)[:, :, 2])


def _metric_parts(y, lanes, c):
    """The stress and the momentum density of the metric constraints: what
    :func:`_metric` needs besides phi (the projections reuse them when
    only phi changed)."""
    psi_nc = _psi_nc(y, lanes)
    theta = (c['fc'] * y[_I_TC] + c['fb'] * y[_I_TB] + c['thg'] * y[_I_TG] + _wsum(c['T1w'], psi_nc[:, :, 1])
             + c['thde'] * y[_I_TDE] + c['thu'] * y[_I_UR + 1])
    return _stress(y, lanes, c), theta


def _metric(phi, parts, c):
    """psi and phi' from the constraints. The slaved photon shear is left
    out under tight coupling, and the massless neutrinos stream (delta =
    -4 psi, theta = 3 phi', sigma = 0) once k eta > 45, where theta_ur =
    3 phi' makes phi' implicit: both are folded into the coefficients."""
    stress, theta = parts
    psi = phi - c['mpsi'] * stress
    return psi, c['rfac'] * (c['g15'] * theta - c['Hc'] * psi)


def deriv_full(y, lanes, c):
    """d/deta of the full phase-A state (n_state, B, nk), with the first-order
    tight-coupling branch per lane where kappa' > max(120 aH, 50 k). ``c``:
    :func:`_fetch` and :func:`_coefs_a` at the lanes' eta."""
    k2 = lanes.k2
    Hc, kp = c['Hc'], c['kp']
    tca = c['tca']
    psi, phip = _metric(y[_I_PHI], _metric_parts(y, lanes, c), c)
    dc, tc, db, tb, dg, tg = y[_I_DC], y[_I_TC], y[_I_DB], y[_I_TB], y[_I_DG], y[_I_TG]
    Fg2 = torch.where(tca, c['gtca'] * tg, y[_I_FG])
    k2psi = k2 * psi
    p3 = 3.0 * phip
    ddc, ddb = p3 - tc, p3 - tb
    ddg = 4.0 * phip - (4.0 / 3.0) * tg
    dtc = k2psi - Hc * tc
    dde, tde = y[_I_DDE], y[_I_TDE]
    ddde = c['e1'] * (tde - p3) + c['e2'] * dde + c['e3'] * tde
    dtde = c['f1'] * tde + c['f2'] * dde + k2psi

    # baryon-photon momentum: drag-free outside tight coupling (the drag
    # pair is integrated exactly per step by _drag_etd), MB95 eq. 74-75 inside
    dtb_full = c['cb2k2'] * db - Hc * tb + k2psi
    dtg_full = k2 * (0.25 * dg - 0.5 * lanes.s2 * Fg2) + k2psi
    slip = c['sl1'] * (tb - tg) + c['sl2'] * (c['a_tb'] * tb + c['a_dg'] * dg + c['a_psi'] * psi
                                               + c['cb2k2'] * ddb - (0.25 * k2) * ddg)
    dtb_tca = (dtb_full + c['R'] * (dtg_full + slip)) * c['inv1R']
    dtb = torch.where(tca, dtb_tca, dtb_full)
    dtg = torch.where(tca, dtb_tca - slip, dtg_full)

    # the ladders F_gamma_2..L, G_0..L, F_ur_0..L in one, scattering
    # -kappa' on the photons, the closures' diagonal on each top row
    lad = lanes.down1 * y[_I_FG - 1:_I_NC - 1] - lanes.up1 * y[_I_FG + 1:_I_NC + 1]
    phot = lad[:_I_UR - _I_FG] - kp * y[_I_FG:_I_UR]
    ur = lad[_I_UR - _I_FG:]
    clos = c['clos']
    phot[LMAX_G - 2].sub_(clos[0] * y[_I_GP - 1])
    phot[-1].sub_(clos[1] * y[_I_UR - 1])
    ur[-1].sub_(clos[2] * y[_I_NC - 1])
    G0, G2 = y[_I_GP], y[_I_GP + 2]
    phot[0].add_(lanes.f1 * tg + c['kp01'] * (y[_I_FG] + G0 + G2))
    PI = Fg2 + G0 + G2
    phot[_I_GP - _I_FG].add_(c['kp05'] * PI)
    phot[_I_GP - _I_FG + 2].add_(c['kp01'] * PI)
    ur[0].add_(4.0 * phip)
    ur[1].add_(lanes.k43 * psi)
    ur.masked_fill_(c['ur_rsa'], 0.0)

    # massive neutrinos: the ladder of each (species, q) with pre = q k / eps
    nc = lanes.down_n * y[_I_NC - 1:-1]
    nc[:-1].sub_(lanes.up_n[:-1] * y[_I_NC + 1:])
    nc = nc.reshape((lanes.ns, NQ_NCDM, LMAX_NCDM + 1) + y.shape[1:]) * c['qe'][:, :, None]
    psi_nc = _psi_nc(y, lanes)
    nc[:, :, -1].sub_(c['clos_n'] * psi_nc[:, :, -1])
    nc[:, :, 0].sub_(phip * lanes.dlnf0)
    nc[:, :, 1].add_(c['src1n'] * psi)
    return torch.cat([torch.stack([phip, ddc, dtc, ddb, dtb, ddg, dtg, ddde, dtde]), phot, ur,
                      nc.reshape((-1,) + y.shape[1:])])


# ---- the post-step projections. Each writes its rows in place into the
# end-of-step state it is given (a fresh tensor in the RK4 loop) and returns it.

def _drag_coefs(cm, d):
    """The exact drag map's factors over a step of length ``d``:
    e^{-z} and d phi1(z), z = kappa'(1+R) d at the midpoint."""
    z = cm['kp'] * (1.0 + cm['R']) * d
    phi1 = torch.where(z > 1e-8, -torch.expm1(-z) / torch.where(z > 1e-8, z, 1.0), 1.0 - 0.5 * z)
    return torch.exp(-z), d * phi1


def _drag_etd(y0, y1, lanes, drag, cm, c1):
    """Exponential (ETD) update of the photon-baryon Thomson drag over one
    step, where tight coupling is off: the slip S = theta_b - theta_g
    relaxes exactly, S_new = S_0 e^{-z} + d phi1(z) D_mid with z =
    kappa'(1+R) d, and the drag-invariant V = (theta_b + R theta_g)/(1+R)
    comes from the drag-free RK4 end state. ``drag``: :func:`_drag_coefs`."""
    e, dphi1 = drag
    k2 = lanes.k2
    ym = 0.5 * (y0[_I_DB:_I_FG + 1] + y1[_I_DB:_I_FG + 1])           # rows DB .. F_2
    D = (cm['cb2k2'] * ym[0] - cm['Hc'] * ym[_I_TB - _I_DB]
         - k2 * (0.25 * ym[_I_DG - _I_DB] - 0.5 * ym[_I_FG - _I_DB]))
    S_new = (y0[_I_TB] - y0[_I_TG]) * e + dphi1 * D
    R, inv1R = cm['R'], cm['inv1R']
    V = (y1[_I_TB] + R * y1[_I_TG]) * inv1R
    tca = c1['tca']
    tb, tg = torch.where(tca, y1[_I_TB], V + R * inv1R * S_new), torch.where(tca, y1[_I_TG], V - inv1R * S_new)
    y1[_I_TB] = tb
    y1[_I_TG] = tg
    return y1


def _tca_project(y, lanes, c):
    """Where tight coupling holds, the slaved photon moments take their
    algebraic values: theta_g = theta_b - S_qss, F_2 = (32/45) s_2 theta_g /
    kappa', G_0 = 5/4 F_2, G_2 = F_2/4, the higher moments 0."""
    tca, gtca, k2 = c['tca'], c['gtca'], lanes.k2
    D = (c['cb2k2'] * y[_I_DB] - c['Hc'] * y[_I_TB]
         - k2 * (0.25 * y[_I_DG] - 0.5 * lanes.s2 * gtca * y[_I_TG]))
    y[_I_TG] = torch.where(tca, y[_I_TB] - D * c['tqs'], y[_I_TG])
    Fg2 = gtca * y[_I_TG]
    y[_I_FG] = torch.where(tca, Fg2, y[_I_FG])
    y[_I_GP] = torch.where(tca, 1.25 * Fg2, y[_I_GP])
    y[_I_GP + 2] = torch.where(tca, 0.25 * Fg2, y[_I_GP + 2])
    y[_I_FG + 1:_I_GP].masked_fill_(tca, 0.0)
    y[_I_GP + 1].masked_fill_(tca, 0.0)
    y[_I_GP + 3:_I_UR].masked_fill_(tca, 0.0)
    return y


def _poisson_project(y, lanes, c, parts):
    """Pin phi to the gauge-invariant Poisson constraint
    (k^2 - 3K) phi = -1.5 (Hc^2 + K) [Delta + 3 (Hc/k^2) (rho+p)theta/rho]
    where k > 2.5 aH (the ODE value is kept superhorizon). ``parts``:
    :func:`_metric_parts` of ``y``."""
    psi, phip = _metric(y[_I_PHI], parts, c)
    rsa = c['ur_rsa']
    dur = torch.where(rsa, -4.0 * psi, y[_I_UR])
    Delta = (c['fg'] * y[_I_DG] + c['fur'] * dur + c['fc'] * y[_I_DC] + c['fb'] * y[_I_DB]
             + _wsum(c['D0w'], _psi_nc(y, lanes)[:, :, 0]) + c['fde'] * y[_I_DDE])
    # the momentum density with theta_ur = 3 phi' where the neutrinos stream
    theta = parts[1] + torch.where(rsa, (4.0 / 3.0) * c['fur'] * 3.0 * phip, 0.0)
    y[_I_PHI] = torch.where(c['pin'], c['pc1'] * (Delta + c['pc2'] * theta), y[_I_PHI])
    return y


def _ur_rsa_project(y, lanes, c, parts):
    """Hold the massless neutrinos at their streaming values where
    k eta > 45: delta_ur = -4 psi, theta_ur = 3 phi', F_l>=2 = 0."""
    psi, phip = _metric(y[_I_PHI], parts, c)
    rsa = c['ur_rsa']
    y[_I_UR] = torch.where(rsa, -4.0 * psi, y[_I_UR])
    y[_I_UR + 1] = torch.where(rsa, 4.0 * phip / lanes.k, y[_I_UR + 1])
    y[_I_UR + 2:_I_NC].masked_fill_(rsa, 0.0)
    return y


def _project_a(y_start, y_end, lanes, drag, cm, c1):
    """The phase-A post-step pipeline: exact Thomson-drag map, TCA slaving,
    Poisson phi-pinning, neutrino streaming. The metric's stress and
    momentum density are made once: the pin changes phi only."""
    y_end = _drag_etd(y_start, y_end, lanes, drag, cm, c1)
    y_end = _tca_project(y_end, lanes, c1)
    parts = _metric_parts(y_end, lanes, c1)
    y_end = _poisson_project(y_end, lanes, c1, parts)
    return _ur_rsa_project(y_end, lanes, c1, parts)


def _coefs_b(c, lanes, eta, steps=None):
    """The streaming-phase coefficients at the fetched points ``c`` and
    ``eta`` (..., B, nk), as :func:`_coefs_a`. ``steps`` (..., B, nk): the
    length of the RK4 step that each point lies on (:func:`_step_points`),
    which decides where the massive-neutrino fluid is pinned
    (:func:`_ncdm_unresolved`); None, for points off a step grid, pins it
    nowhere."""
    k, k2, s2 = lanes.k, lanes.k2, lanes.s2
    Hc, kp, w, fnc, w_de = c['Hc'], c['kp'], c['w_nc'], c['fnc'], c['w_de']
    G2k2 = (Hc ** 2 + c['K']) / k2
    cg2 = w - c['dw_nc'] / (3.0 * (1.0 + w))
    opw, cs2 = 1.0 + w_de, c['cs2_fld']
    cs2_qs = torch.clamp(cs2, min=1e-12)
    c.update(
        b_sn=4.5 * (G2k2 / lanes.s2sq) * fnc * (1.0 + w), g15=1.5 * G2k2, fno=fnc * (1.0 + w),
        thde=c['fde'] * opw, den=1.0 - 6.0 * G2k2 * (c['fg'] + c['fur']),
        cb2k2=c['cb2'] * k2, kpR=kp * (4.0 / 3.0) * c['fg'] / c['fb'],
        n1=-(1.0 + w), n2=-3.0 * Hc * (cg2 - w), n3=-Hc * (1.0 - 3.0 * cg2), n4=(cg2 / (1.0 + w)) * k2,
        n5=-3.0 * Hc, n6=s2 * (16.0 / 15.0) * (cg2 / (1.0 + w)),
        e1=-opw, e2=-3.0 * Hc * (cs2 - w_de),
        e3=-9.0 * Hc ** 2 * (cs2 * opw - (w_de * opw + c['wa_fld'] * torch.exp(c['lna']) / 3.0)) / k2,
        f1=-Hc * (1.0 - 3.0 * cs2), f2=cs2 * k2 * (opw / (opw * opw + 1e-24)),
        # quasi-static dark energy sub-sound-horizon: delta' = 0 and
        # cs2 k^2 delta/(1+w) + k^2 psi = 0, where cs k eta > 45
        de_qs=eta * torch.sqrt(torch.clamp(cs2, min=0.0)) > lanes.eta_rsa,
        qa=-opw / cs2_qs, qb=3.0 * Hc * (cs2_qs - w_de) / cs2_qs)
    c['nc_qs'] = _ncdm_unresolved(c, lanes, steps)
    return c


def _rsa_metric(yB, c):
    """psi and phi' of the reduced streaming-phase state (theta_rad = 3 phi'
    makes phi' an exact small solve)."""
    phi, dc, tc, db, tb, dn, tn, sn, dde, tde = yB
    psi = phi - c['b_sn'] * sn
    theta = c['fc'] * tc + c['fb'] * tb + c['fno'] * tn + c['thde'] * tde
    return psi, (c['g15'] * theta - c['Hc'] * psi) / c['den']


def deriv_rsa(yB, lanes, c):
    """d/deta of the streaming-phase state (phi, dc, tc, db, tb, dn, tn, sn,
    dde, tde): radiation algebraic (delta = -4 psi, theta = 3 phi'), the
    massive species an adiabatic viscous fluid, the dark-energy fluid frozen
    where it is quasi-static. ``c``: :func:`_fetch` and :func:`_coefs_b`."""
    k2 = lanes.k2
    Hc = c['Hc']
    phi, dc, tc, db, tb, dn, tn, sn, dde, tde = yB
    psi, phip = _rsa_metric(yB, c)
    k2psi = k2 * psi
    p3 = 3.0 * phip
    ddn = c['n1'] * (tn - p3) + c['n2'] * dn
    dtn = c['n3'] * tn + c['n4'] * dn + k2psi - (k2 * lanes.s2) * sn
    dsn = c['n5'] * sn + c['n6'] * tn
    ddde = c['e1'] * (tde - p3) + c['e2'] * dde + c['e3'] * tde
    dtde = c['f1'] * tde + c['f2'] * dde + k2psi
    de_qs, nc_qs = c['de_qs'], c['nc_qs']
    ddn, dtn, dsn = (torch.where(nc_qs, 0.0, v) for v in (ddn, dtn, dsn))
    return torch.stack([phip, p3 - tc, k2psi - Hc * tc, p3 - tb,
                        -Hc * tb + c['cb2k2'] * db + k2psi + c['kpR'] * (p3 - tb), ddn, dtn, dsn,
                        torch.where(de_qs, 0.0, ddde), torch.where(de_qs, 0.0, dtde)])


def _project_b(y_start, y_end, lanes, drag, cm, c1):
    """Post-step pin of the streaming-phase dark-energy fluid to its
    quasi-static values sub-sound-horizon, and of the massive-neutrino fluid
    where the step leaves its waves unresolved (:func:`_ncdm_unresolved`):
    theta' = 0 and delta' = 0 with sigma = 0, so delta = -k^2 psi / n4 and
    theta = 3 phi' + n2 delta / (1 + w)."""
    psi, phip = _rsa_metric(y_end, c1)
    de_qs = c1['de_qs']
    y_end[8] = torch.where(de_qs, c1['qa'] * psi, y_end[8])
    y_end[9] = torch.where(de_qs, 3.0 * phip + c1['qb'] * psi, y_end[9])
    nc_qs = c1['nc_qs']
    dn = -lanes.k2 * psi / torch.where(nc_qs, c1['n4'], 1.0)
    y_end[5] = torch.where(nc_qs, dn, y_end[5])
    y_end[6] = torch.where(nc_qs, 3.0 * phip - c1['n2'] * dn / c1['n1'], y_end[6])
    y_end[7] = torch.where(nc_qs, 0.0, y_end[7])
    return y_end


# RK4's stability bound on the imaginary axis: a step that turns an
# undamped wave by more than 2 sqrt(2) radians amplifies it
NCDM_OMEGA_D_MAX = 2.0 * np.sqrt(2.0)


def _ncdm_unresolved(c, lanes, steps):
    """Where the step ``steps`` (..., B, nk) turns the massive-neutrino
    fluid's fastest wave by more than NCDM_OMEGA_D_MAX, at the coefficients
    ``c`` of the point on it (:func:`_coefs_b`): its sound and shear waves,
    omega^2 = cg2 k^2 (1 + s_2 16 / (15 (1 + w))), from delta' = n1 theta,
    theta' = n4 delta - k^2 s_2 sigma, sigma' = n6 theta. A light neutrino
    stays relativistic late, and the static step budget cannot resolve its
    waves at high k (at 1280 steps, m < ~0.012 eV and k > ~0.3 h/Mpc): RK4
    there grows without bound. A lane whose steps all stay within the bound
    is never pinned. None for ``steps`` flags no point."""
    if steps is None:
        return torch.zeros_like(lanes.k, dtype=torch.bool)
    omega2 = -c['n1'] * c['n4'] + lanes.k2 * lanes.s2 * c['n6']
    return torch.sqrt(torch.clamp(omega2, min=0.0)) * steps > NCDM_OMEGA_D_MAX


def _ncdm_handoff(yA, eta_Aend, tabs, lanes):
    """The end-of-phase-A state on the reduced streaming-phase state: the
    massive-neutrino hierarchy collapsed to its fluid moments."""
    c = _fetch(tabs, eta_Aend, lanes)
    psi_nc = _psi_nc(yA, lanes)
    I_rho = c['I_rho']
    opw = 1.0 + c['w_nc']
    return torch.stack([yA[_I_PHI], yA[_I_DC], yA[_I_TC], yA[_I_DB], yA[_I_TB],
                        _wsum(c['W0'], psi_nc[:, :, 0]) / I_rho,
                        lanes.k * (_wsum(lanes.w2q, psi_nc[:, :, 1]) / I_rho) / opw,
                        (2.0 / 3.0) * _wsum(c['W2'], psi_nc[:, :, 2]) / I_rho / opw, yA[_I_DDE], yA[_I_TDE]])


def _at(c, i):
    """The coefficients of grid point ``i`` (the leading axis of every
    per-point entry; per-cosmology entries have none)."""
    return {name: _at(v, i) if isinstance(v, dict) else v[i] if v.dim() > 2 else v for name, v in c.items()}


def _step_points(e):
    """The points of the steps of the grid rows ``e`` (n + 1, B, nk) at
    which the RK4 loop takes its coefficients, e_0, m_0, e_1, m_1, ..., e_n
    (m_i the midpoints), and the length of the step each lies on (e_0 on
    the first)."""
    d = e[1:] - e[:-1]
    pts = torch.cat([torch.stack([e[:-1], 0.5 * (e[:-1] + e[1:])], dim=1).flatten(0, 1), e[-1:]])
    return pts, torch.cat([d[:1], d.repeat_interleave(2, dim=0)])


def _rk4_loop(deriv, coefs, project, y0, eta_grid, tabs, lanes, graphs, name, harvest=None, emit=None, rates=None):
    """Fixed-step RK4 over the per-lane grids ``eta_grid`` (N + 1, B, nk),
    then ``project``. The coefficients ``coefs`` at the steps' ends and
    midpoints are made once per chunk of steps, vectorized, and with
    ``rates`` (a function of them) also 'rate', their d/deta at a fixed
    state that ``emit`` reads. The carry holds the state and its derivative
    at the step's start, which is the next step's first RK4 stage.

    ``harvest``: None or (harvest_eta (B, n_z), rows): the linear blend of
    the state rows ``rows`` at each harvest point, inside the step that holds
    it (half open: e0 <= eta < e1). ``emit``: None or a function
    (y1, ydot1, lanes, c1) -> (n_emit, B, nk) of each step's end state, its
    derivative and the coefficients there (the line-of-sight source taps).
    Returns the final state, the harvest (n_z, len(rows), B, nk) or None and
    the emitted rows (N, n_emit, B, nk) or None. ``name`` keys the loop's
    counts (:func:`~cosmoprimo_tpu_torch.ops.step_loop.step_loop`)."""
    fetch_lanes = lanes if isinstance(lanes, Lanes) else None     # the massive neutrinos' factors
    if harvest is not None:
        harvest_eta, rows = harvest
        rows = torch.as_tensor(rows, device=y0.device)
        h = harvest_eta.T[:, :, None]                     # (n_z, B, 1)

    def prepare(cols):
        e = cols[0]
        pts, steps = _step_points(e)
        c = coefs(_fetch(tabs, pts, fetch_lanes, rates=rates is not None), lanes, pts, steps)
        if rates is not None:
            c['rate'] = rates(c, lanes)
        e0, e1 = e[:-1], e[1:]
        d = e1 - e0
        drag = _drag_coefs(_at(c, slice(1, None, 2)), d) if coefs is _coefs_a else (d, d)
        data = (c, d, 0.5 * d, d / 6.0, drag)
        if harvest is not None:
            # the blend weight where the step holds a harvest point, else 0
            hit = (e0[:, None] <= h) & (e1[:, None] > h)
            dd = d[:, None]
            w = torch.where(hit, torch.clamp((h - e0[:, None]) / torch.where(dd > 0, dd, 1.0), 0.0, 1.0), 0.0)
            data += (hit[:, :, None], w[:, :, None])
        return data

    def step(carry, data, j):
        y, ydot = carry[:2]
        c, d, hd, d6, drag = data[:5]
        d, hd, d6 = d[j], hd[j], d6[j]
        cm, c1 = _at(c, 2 * j + 1), _at(c, 2 * j + 2)
        k2 = deriv(y + hd * ydot, lanes, cm)
        k3 = deriv(y + hd * k2, lanes, cm)
        k4 = deriv(y + d * k3, lanes, c1)
        y1 = project(y, y + d6 * torch.add(ydot, k2, alpha=2.0).add_(k3, alpha=2.0).add_(k4), lanes,
                     (drag[0][j], drag[1][j]), cm, c1)
        ydot1 = deriv(y1, lanes, c1)
        new = (y1, ydot1)
        if harvest is not None:
            hit, w = data[5][j], data[6][j]
            ys = y.index_select(0, rows)
            new += (carry[2] + torch.where(hit, ys + w * (y1.index_select(0, rows) - ys), 0.0),)
        return new, (() if emit is None else (emit(y1, ydot1, lanes, c1),))

    start, steps = (p[:1] for p in _step_points(eta_grid[:2]))
    carry = (y0, deriv(y0, lanes, _at(coefs(_fetch(tabs, start, fetch_lanes), lanes, start, steps), 0)))
    if harvest is not None:
        carry += (y0.new_zeros((h.shape[0], rows.numel()) + y0.shape[1:]),)
    carry, emitted = step_loop(step, carry, (eta_grid,), name, prepare=prepare, graphs=graphs)
    return carry[0], (carry[2] if harvest is not None else None), (emitted[0] if emit is not None else None)


def _psi_rates_a(c, lanes):
    """d/deta at a fixed state of the coefficients of psi = phi - mpsi stress
    (phase A), from the fetch's rates: 'mpsi', and those of the stress,
    'sg', 'su' and 'S2w' (the massive neutrinos' through a(eta))."""
    r = c['rate']
    k2 = lanes.k2
    tca, rsa = c['tca'], c['ur_rsa']
    I_rho = c['I_rho'][..., None, None, :, :]
    eps, W2 = c['eps'], c['W2']
    deps = (c['a'][..., None, None, :, :] * lanes.am[:, None]) ** 2 * r['lna'][..., None, None, :, :] / eps
    dI = torch.sum(lanes.w2 * deps, dim=(-4, -3))[..., None, None, :, :]
    fnc5, dfnc5 = c['fnc'][..., None, None, :, :], r['fnc'][..., None, None, :, :]
    return {'mpsi': 4.5 * (2.0 * c['Hc'] * r['Hc']) / (k2 * lanes.s2sq),
            'sg': torch.where(tca, 0.0, (2.0 / 3.0) * r['fg']), 'su': torch.where(rsa, 0.0, (2.0 / 3.0) * r['fur']),
            'S2w': (2.0 / 3.0) * ((dfnc5 * W2 - fnc5 * W2 * deps / eps) / I_rho - fnc5 * W2 * dI / I_rho ** 2)}


def _emit_los_a(y, ydot, lanes, c):
    """The five line-of-sight source rows of a phase-A state (see
    :func:`compute_los_sources`). psi' is exact: the derivative of psi along
    the state's derivative ``ydot`` plus its explicit eta-dependence through
    the coefficients (:func:`_psi_rates_a`), as the JAX package's forward mode
    through the metric constraint."""
    parts = _metric_parts(y, lanes, c)
    psi, phip = _metric(y[_I_PHI], parts, c)
    r = c['rate']
    dpsi = ((ydot[_I_PHI] - c['mpsi'] * _stress(ydot, lanes, c))          # along the state's derivative
            - (r['mpsi'] * parts[0] + c['mpsi'] * _stress(y, lanes, r)))  # through the coefficients
    # Pi in temperature units: the hierarchy stores brightness moments F_l = 4 Theta_l
    Pi = 0.25 * (y[_I_FG] + y[_I_GP] + y[_I_GP + 2])
    return torch.stack([0.25 * y[_I_DG] + psi + 0.25 * Pi, y[_I_TB] / lanes.k, Pi, phip + dpsi,
                        0.5 * (y[_I_PHI] + psi)])


def _psi_rates_b(c, lanes):
    """d/deta of b_sn in the streaming phase's psi = phi - b_sn sigma_ncdm."""
    r = c['rate']
    w, fnc = c['w_nc'], c['fnc']
    G2 = c['Hc'] ** 2 + c['K']
    return {'b_sn': 4.5 / (lanes.k2 * lanes.s2sq) * ((2.0 * c['Hc'] * r['Hc']) * fnc * (1.0 + w)
                                                      + G2 * r['fnc'] * (1.0 + w) + G2 * fnc * r['w_nc'])}


def _emit_los_b(y, ydot, lanes, c):
    """The source rows of a streaming-phase state: Theta_0 + psi = 0 and
    Pi = 0 there; psi = phi - b_sn sigma_ncdm, psi' exact as in phase A."""
    psi = y[0] - c['b_sn'] * y[7]
    dpsi = ydot[0] - c['b_sn'] * ydot[7] - c['rate']['b_sn'] * y[7]
    zero = torch.zeros_like(psi)
    return torch.stack([zero, y[4] / lanes.k, zero, ydot[0] + dpsi, 0.5 * (y[0] + psi)])


PERTURBATION_NAMES = ('delta_g', 'theta_g', 'shear_g', 'delta_b', 'theta_b',
                      'delta_cdm', 'theta_cdm', 'delta_ur', 'theta_ur',
                      'delta_ncdm', 'theta_ncdm', 'delta_fld', 'theta_fld',
                      'phi', 'psi')


def _emit_series_a(y, ydot, lanes, c):
    """The :data:`PERTURBATION_NAMES` rows of a phase-A state."""
    parts = _metric_parts(y, lanes, c)
    psi, phip = _metric(y[_I_PHI], parts, c)
    tur = torch.where(c['ur_rsa'], 3.0 * phip, 0.75 * lanes.k * y[_I_UR + 1])
    psi_nc = _psi_nc(y, lanes)
    I_rho = c['I_rho']
    dn = _wsum(c['W0'], psi_nc[:, :, 0]) / I_rho
    opw_th_k = _wsum(lanes.w2q, psi_nc[:, :, 1]) / I_rho
    return torch.stack([y[_I_DG], y[_I_TG], 0.5 * y[_I_FG], y[_I_DB], y[_I_TB], y[_I_DC], y[_I_TC], y[_I_UR], tur,
                        dn, lanes.k * opw_th_k / (1.0 + c['w_nc']), y[_I_DDE], y[_I_TDE], y[_I_PHI], psi])


def _emit_series_b(y, ydot, lanes, c):
    """The :data:`PERTURBATION_NAMES` rows of a streaming-phase state: the
    radiation's algebraic values (delta = -4 psi, theta = 3 phi')."""
    psi = y[0] - c['b_sn'] * y[7]
    tg = 3.0 * ydot[0]
    return torch.stack([-4.0 * psi, tg, torch.zeros_like(psi), y[3], y[4], y[1], y[2], -4.0 * psi, tg, y[5], y[6],
                        y[8], y[9], y[0], psi])


def _los_z_nodes(n_rec=512, n_mid=192, n_reio=128, n_late=192):
    """The static redshift template of the line-of-sight source grid: dense
    through recombination (z in [1690, 500]), logarithmic through the matter
    era and reionization, uniform in ln(1+z) at late times (numpy)."""
    z_rec = np.linspace(1690.0, 500.0, n_rec, endpoint=False)
    z_mid = np.geomspace(500.0, 30.0, n_mid, endpoint=False)
    z_reio = np.geomspace(30.0, 4.0, n_reio, endpoint=False)
    z_late = np.expm1(np.linspace(np.log1p(4.0), 0.0, n_late))
    return np.concatenate([z_rec, z_mid, z_reio, z_late])


def _tau_nodes(tabs, z_nodes):
    """Conformal times (B, n) of the redshift template, just inside eta0."""
    lna_n = torch.from_numpy(-np.log1p(np.asarray(z_nodes, dtype=np.float64))).to(tabs['lna'].device)
    tau_h = torch.exp(interp(lna_n, tabs['lna'], tabs['lneta']))
    return torch.minimum(tau_h, tabs['eta0'] * (1.0 - 1e-9))


def _onto_tau(tau_h, grids, series):
    """Each lane's emitted rows from its own step grids onto the shared
    conformal times ``tau_h`` (B, n): ``grids`` the phases' grids
    (N + 1, B, nk) and ``series`` their emitted rows (N, R, B, nk), one
    phase, or two: the first taken before the end of its grid and the second
    after it, each by ``jnp.interp`` (clamped at both ends). Returns
    (B, nk, R, n)."""
    B, nk = grids[0].shape[1:]
    x = tau_h[:, None, :].expand(B, nk, tau_h.shape[-1])
    out = []
    for grid, rows in zip(grids, series):
        xp = grid[1:].permute(1, 2, 0).contiguous()
        f = rows.permute(1, 2, 3, 0)
        out.append(torch.stack([_interp_lanes(x, xp, f[r]) for r in range(f.shape[0])], dim=2))
    if len(out) == 1:
        return out[0]
    return torch.where((x < grids[0][-1][..., None])[:, :, None, :], out[0], out[1])


def _emitting_run(params, thermo, k, n_steps, graphs, emitters, rates=(None, None)):
    """Both phases from the adiabatic start, each step emitting through
    ``emitters`` (phase A's and phase B's, which read ``rates``): the setup
    and the emitted rows of each phase."""
    run = _setup(params, thermo, k, None, n_steps)
    tabs, lanes = run['tabs'], run['lanes']
    yA, _, srcA = _rk4_loop(deriv_full, _coefs_a, _project_a, run['y0'], run['eta_A'], tabs, lanes, graphs,
                            'sources_a', emit=emitters[0], rates=rates[0])
    yB0 = _ncdm_handoff(yA, run['eta_A'][-1], tabs, lanes)
    _, _, srcB = _rk4_loop(deriv_rsa, _coefs_b, _project_b, yB0, run['eta_B'], tabs, lanes, graphs, 'sources_b',
                           emit=emitters[1], rates=rates[1])
    return run, srcA, srcB


def compute_los_sources(params, thermo, k, z_nodes=None, n_steps=None, graphs=True):
    """Line-of-sight CMB sources of a batch on a common conformal-time grid
    per cosmology (Seljak & Zaldarriaga 1996). The two-phase integration of
    :func:`integrate_perturbations` taps five rows at every step, then each
    lane's series goes from its own step grid onto the grid ``tau`` made from
    the redshift template ``z_nodes`` (default :func:`_los_z_nodes`):

    0. mono = Theta_0 + psi + Pi/4 (multiplies g j_l), with Pi = Theta_2 +
       (G_0 + G_2)/4 = (F_g2 + G_0 + G_2)/4 in temperature units;
    1. dopp = theta_b / k (multiplies g j_l');
    2. pol = Pi ((3/4) g Pi multiplies j_l''; the E source is (3/4) g Pi j_l/x^2);
    3. isw = phi' + psi' (multiplies e^-kappa j_l);
    4. weyl = (phi + psi) / 2 (the lensing-potential source).

    ``k`` (B, nk) in 1/Mpc; ``params``, ``thermo`` as :func:`build_tables`;
    ``n_steps`` and ``graphs`` as :func:`integrate_perturbations`. Returns a
    dict: 'tau' (B, n_tau), 'src' (B, nk, 5, n_tau) raw sources (visibility
    not applied), 'g' and 'emk' (= e^-kappa) (B, n_tau), 'eta0' and
    'tau_star' (the visibility peak's, from thermo.z_star) (B, 1), and 'k'."""
    run, srcA, srcB = _emitting_run(params, thermo, k, n_steps, graphs, (_emit_los_a, _emit_los_b),
                                     (_psi_rates_a, _psi_rates_b))
    tabs = run['tabs']
    tau_h = _tau_nodes(tabs, _los_z_nodes() if z_nodes is None else z_nodes)
    src = _onto_tau(tau_h, (run['eta_A'], run['eta_B']), (srcA, srcB))
    c_h = _fetch(tabs, tau_h)
    B = tau_h.shape[0]
    lna_th = torch.from_numpy(_thermo.LNA_GRID).to(tau_h.device)
    kappa = interp(c_h['lna'], lna_th, thermo.tau.reshape(B, -1))
    emk = torch.exp(-kappa)
    tau_star = torch.exp(interp(-torch.log1p(thermo.z_star.reshape(B, 1)), tabs['lna'], tabs['lneta']))
    return {'tau': tau_h, 'src': src, 'g': c_h['kp'] * emk, 'emk': emk, 'eta0': tabs['eta0'], 'tau_star': tau_star,
            'k': k}


def compute_perturbation_series(params, thermo, k, z_nodes=None, n_steps=None, graphs=True):
    """Newtonian-gauge perturbation series of each mode of a batch, from the
    per-lane step grids onto a common conformal-time grid per cosmology (the
    per-k table CLASS's ``get_perturbations`` gives). Arguments as
    :func:`compute_los_sources`. Returns a dict: 'tau' and 'a' (B, n_tau),
    'k' (B, nk), 'series' (B, nk, len(PERTURBATION_NAMES), n_tau) ordered
    as :data:`PERTURBATION_NAMES` (MB95 conventions, comoving curvature
    R = 1; in the streaming phase the radiation's algebraic values), and
    'names'."""
    run, srcA, srcB = _emitting_run(params, thermo, k, n_steps, graphs, (_emit_series_a, _emit_series_b))
    tabs = run['tabs']
    tau_h = _tau_nodes(tabs, _los_z_nodes() if z_nodes is None else z_nodes)
    series = _onto_tau(tau_h, (run['eta_A'], run['eta_B']), (srcA, srcB))
    a_h = torch.exp(interp(torch.log(tau_h), tabs['lneta'], tabs['lna']))
    return {'tau': tau_h, 'a': a_h, 'k': k, 'series': series, 'names': PERTURBATION_NAMES}


def _rows_a(ns):
    """The phase-A rows the assembly reads: phi .. delta_g, F_ur_0 and the
    massive neutrinos' Psi_0, Psi_1 of every (species, q)."""
    nc = [_I_NC + j * (LMAX_NCDM + 1) + l for j in range(ns * NQ_NCDM) for l in (0, 1)]
    return [_I_PHI, _I_DC, _I_TC, _I_DB, _I_TB, _I_DG, _I_UR] + nc


def _setup(params, thermo, k, z_outputs, n_steps):
    """Everything before the loops: the tables, the lanes, the per-lane
    grids (grid axis first), the initial state and, for ``z_outputs`` not
    None, the harvest points."""
    na, nb, mt = n_steps if n_steps is not None else (None, None, None)
    tabs = build_tables(params, thermo, m_tab=mt)
    lanes = Lanes(tabs, k)
    eta_A, eta_B, eta_ini = build_time_grids(tabs, k, n_steps_a=na, n_steps_b=nb)
    run = dict(tabs=tabs, lanes=lanes, k=k, y0=adiabatic_ics(tabs, lanes, eta_ini),
               eta_A=eta_A.permute(2, 0, 1).contiguous(), eta_B=eta_B.permute(2, 0, 1).contiguous())
    if z_outputs is not None:
        z = torch.as_tensor(np.asarray(z_outputs, dtype=np.float64), device=k.device)
        eta_t = torch.exp(interp(-torch.log1p(z), tabs['lna'], tabs['lneta']))   # (B, n_z)
        # z = 0 maps to eta0 exactly; nudge inside the final half-open step
        run.update(z=z, eta_t=torch.minimum(eta_t, tabs['eta0'] * (1.0 - 1e-10)))
    return run


def _phase_a(run, graphs):
    """The full-hierarchy phase: its end state and harvest, in the span
    ``cosmoprimo.perturbations.phase_a`` (closed on the device)."""
    with tracing.span('cosmoprimo.perturbations.phase_a', sync=True):
        yA, outA, _ = _rk4_loop(deriv_full, _coefs_a, _project_a, run['y0'], run['eta_A'], run['tabs'],
                                run['lanes'], graphs, 'phase_a', harvest=(run['eta_t'], _rows_a(run['lanes'].ns)))
    return yA, outA


def _phase_b(run, yA, graphs):
    """The streaming phase from the end of phase A: its harvest, in the span
    ``cosmoprimo.perturbations.phase_b`` (closed on the device)."""
    with tracing.span('cosmoprimo.perturbations.phase_b', sync=True):
        yB0 = _ncdm_handoff(yA, run['eta_A'][-1], run['tabs'], run['lanes'])
        return _rk4_loop(deriv_rsa, _coefs_b, _project_b, yB0, run['eta_B'], run['tabs'], run['lanes'], graphs,
                         'phase_b', harvest=(run['eta_t'], list(range(8))))[1]


def _assemble(run, outA, outB):
    """The transfers per (z, lane), from phase A or phase B, in the
    CDM-comoving synchronous gauge."""
    tabs, lanes, k, eta_t = run['tabs'], run['lanes'], run['k'], run['eta_t']
    res = {'k': k, 'z': run['z']}
    use_A = eta_t.T[:, :, None] < run['eta_A'][-1]                         # (n_z, B, nk)
    for iz in range(eta_t.shape[1]):
        c = _fetch(tabs, eta_t[:, iz:iz + 1].expand(k.shape), lanes)
        yAz, yBz = outA[iz], outB[iz]
        psi_a = yAz[7:].reshape((lanes.ns, NQ_NCDM, 2) + k.shape)
        I_rho = c['I_rho']
        dnA = _wsum(c['W0'], psi_a[:, :, 0]) / I_rho
        opwtA = _wsum(lanes.w2q, psi_a[:, :, 1]) / I_rho
        opw = 1.0 + c['w_nc']
        G2z = c['Hc'] ** 2 + c['K']
        psiB = yBz[0] - 4.5 * (G2z / (k ** 2 * lanes.s2sq)) * c['fnc'] * opw * yBz[7]
        sel = use_A[iz]
        phi, dc, tc, db, tb = (torch.where(sel, yAz[i], yBz[i]) for i in range(5))
        dg = torch.where(sel, yAz[5], -4.0 * psiB)
        dur = torch.where(sel, yAz[6], -4.0 * psiB)
        dn = torch.where(sel, dnA, yBz[5])
        tn = torch.where(sel, k * opwtA / opw, yBz[6])
        shift = 3.0 * c['Hc'] * tc / k ** 2
        dc_s, db_s = dc + shift, db + shift
        dg_s = dg + (4.0 / 3.0) * 3.0 * c['Hc'] * tc / k ** 2
        dur_s = dur + (4.0 / 3.0) * 3.0 * c['Hc'] * tc / k ** 2
        dn_s = dn + opw * shift
        fm = c['fc'] + c['fb'] + c['fnc']
        for name, value in (('delta_cdm', dc_s), ('delta_b', db_s), ('delta_g', dg_s), ('delta_ur', dur_s),
                            ('delta_ncdm', dn_s), ('delta_m', (c['fc'] * dc_s + c['fb'] * db_s + c['fnc'] * dn_s) / fm),
                            ('delta_cb', (c['fc'] * dc_s + c['fb'] * db_s) / (c['fc'] + c['fb'])),
                            ('phi', phi), ('theta_b', tb), ('theta_ncdm', tn)):
            res.setdefault(name, []).append(value)
    for name, value in res.items():
        if isinstance(value, list):
            res[name] = torch.stack(value, dim=1)
    return res


def integrate_perturbations(params, thermo, k, z_outputs, n_steps=None, graphs=True):
    """The two-phase integration of a batch: ``k`` (B, nk) in 1/Mpc (one row
    per cosmology), ``z_outputs`` a list of redshifts. Returns the
    synchronous-gauge (CDM-comoving) transfers, phi, theta_b and theta_ncdm,
    each (B, n_z, nk), normalized to comoving curvature R = 1.
    ``n_steps``: the static (n_steps_a, n_steps_b, m_tab) budget, see
    :func:`steps_for_kmax`; None gives the module defaults. ``graphs``:
    replay the RK4 loops from CUDA graphs on the card. The call is the span
    ``cosmoprimo.perturbations``, with ``.setup`` (the tables, the grids,
    the initial state), ``.phase_a`` and ``.phase_b`` inside it."""
    with tracing.span('cosmoprimo.perturbations'):
        with tracing.span('cosmoprimo.perturbations.setup'):
            run = _setup(params, thermo, k, z_outputs, n_steps)
        yA, outA = _phase_a(run, graphs)
        return _assemble(run, outA, _phase_b(run, yA, graphs))


def linear_pk(params, thermo, k_hMpc, z_outputs, n_steps=None, graphs=True):
    """Linear P(k) [(Mpc/h)^3] of total matter and of cdm + baryons at
    ``k_hMpc`` (nk,) [h/Mpc] and each z of ``z_outputs``: 'pk_m' and 'pk_cb'
    (B, n_z, nk), and the transfers. ``params`` and ``thermo`` as
    :func:`build_tables` (with n_s, A_s, k_pivot and optionally alpha_s,
    beta_s); ``n_steps`` and ``graphs`` as :func:`integrate_perturbations`."""
    h = params['h'][:, None]
    k_hMpc = torch.as_tensor(k_hMpc, dtype=torch.float64, device=h.device)
    k = k_hMpc * h                                                           # (B, nk), 1/Mpc
    tr = integrate_perturbations(params, thermo, k, z_outputs, n_steps=n_steps, graphs=graphs)
    ns, As, kp = params['n_s'][:, None], params['A_s'][:, None], params['k_pivot'][:, None]
    lnkkp = torch.log(k / kp)
    alpha_s = params['alpha_s'][:, None] if 'alpha_s' in params else 0.0
    beta_s = params['beta_s'][:, None] if 'beta_s' in params else 0.0
    neff = ns - 1.0 + 0.5 * alpha_s * lnkkp + beta_s / 6.0 * lnkkp ** 2
    pprim = (2.0 * np.pi ** 2 / k ** 3 * As * (k / kp) ** neff)[:, None, :]   # Mpc^3
    h3 = h[:, None] ** 3
    return {'k': k_hMpc, 'z': tr['z'], 'pk_m': pprim * tr['delta_m'] ** 2 * h3,
            'pk_cb': pprim * tr['delta_cb'] ** 2 * h3, 'transfers': tr}
