"""Tensor-mode (primordial gravitational wave) CMB spectra
(cosmoprimo_tpu/boltzmann/tensor.py), batched over cosmologies: the unlensed
BB and the tensor parts of TT, EE and TE.

The reduced Crittenden-Coulson-Turok / Polnarev system, photon moments in
temperature units:

  metric      h'' + 2 aH h' + k^2 h = 6 (aH)^2 sum_i f_i
                  [ (8/15) F_{i,0} + (16/21) F_{i,2} + (8/35) F_{i,4} ]
  photons     FT_0' = -k FT_1 - h'/2 - kappa' (FT_0 - Psi),  FT_l' = advection - kappa' FT_l
  polar.      FP_0' = -k FP_1 - kappa' (FP_0 + Psi),          FP_l' = advection - kappa' FP_l
  neutrinos   FN_0' = -k FN_1 - h'/2,                         FN_l' = advection
  Psi = FT0/10 + FT2/7 + 3 FT4/70 - 3 FP0/5 + 6 FP2/7 - 3 FP4/70

with the photon towers slaved under tight coupling. The line of sight
(x = k (tau0 - tau)):

  Delta_T,l = sqrt((l+2)!/(l-2)!) int dtau [e^-kappa (-h'/2) + g Psi] j_l/x^2
  Delta_E,l = int dtau g Psi [ -j_l + j_l'' + 2 j_l/x^2 + 4 j_l'/x ]
  Delta_B,l = int dtau g Psi [ 2 j_l' + 4 j_l/x ]
  C_l^XY = pi int dln k P_T(k) Delta_X,l Delta_Y,l,

P_T(k) = r A_s (k/k_pivot)^(n_t + (alpha_t/2) ln(k/k_pivot)). The RK4 loop is
the scalar solver's (perturbations._rk4_loop over ops/step_loop.py, CUDA
graphs on the card), one phase of N_STEPS_T steps per lane.
"""

import numpy as np
import torch

from . import bessel
from .harmonic import (DK_FINE, KMIN, N_REC, _curvature, _fine_grid, _projection, _row_chunks, _spline_to_integers,
                       _trapz_weights, _x_max, coarse_k_grid, shared_kmin)
from .perturbations import (TCA_TRIGGER_AH, TCA_TRIGGER_K, _cum_density, _fetch, _grid_on, _onto_tau, _rk4_loop,
                            _tau_nodes, _thermo, build_tables, interp)

LMAX_T = 8     # photon tensor temperature tower FT_0..FT_LMAX_T
LMAX_P = 8     # photon tensor polarization tower
LMAX_N = 14    # neutrino tensor tower
N_STEPS_T = 8192
ALPHA_T = 0.5      # dtau <= ALPHA_T / k
BETA_T = 0.004     # dtau <= BETA_T tau
KAPPA_SAFE_T = 0.45

_I_H, _I_HP = 0, 1
_I_T = 2
_I_P = _I_T + (LMAX_T + 1)
_I_N = _I_P + (LMAX_P + 1)
N_STATE_T = _I_N + (LMAX_N + 1)


def tensor_cl_kmin(K, kmin=KMIN):
    """The smallest propagating tensor wavenumber [1/Mpc] for a float
    curvature ``K``: the tensor radial eigenvalue is q^2 = k^2 + 3K, and the
    closed discrete modes have k^2 >= 6 K."""
    if K < 0.0:
        return max(kmin, 1.05 * np.sqrt(-3.0 * K))
    if K > 0.0:
        return max(kmin, np.sqrt(6.0 * K))
    return kmin


class TensorLanes(object):
    """The lanes of a tensor run: ``k`` (B, nk) in 1/Mpc and k^2."""

    def __init__(self, k):
        self.k = k
        self.k2 = k ** 2


def tensor_time_grid(tabs, k, n_steps=None):
    """Per-lane grids (B, nk, n_steps + 1) from tau_ini(k) to tau0 with the
    scalar solver's density rules (acoustic phase, ln tau, and the explicit
    kappa'-stability band outside tight coupling), and tau_ini (B, nk)."""
    n_steps = N_STEPS_T if n_steps is None else n_steps
    eta_m = torch.exp(tabs['lneta'])
    kpm, Hcm = tabs['kp'][:, None, :], tabs['Hc'][:, None, :]
    eta0 = tabs['eta0']
    kk = k[..., None]
    tca_off = (kpm < TCA_TRIGGER_AH * Hcm) | (kpm < TCA_TRIGGER_K * kk)
    dens = torch.maximum(kk / ALPHA_T, (1.0 / (BETA_T * eta_m))[:, None, :])
    dens = torch.maximum(dens, torch.where(tca_off, kpm / (2.8 * KAPPA_SAFE_T), 0.0))
    s = _cum_density(dens, eta_m)
    del dens, tca_off
    eta_ini = torch.clamp(torch.clamp(0.03 / k, min=tabs['eta_ini_min']), max=tabs['eta_rd'])
    end = (eta0 * (1.0 + 1e-9)).expand(eta_ini.shape)
    eta_g = _grid_on(s, eta_m[:, None, :], eta_ini, end, n_steps)
    return torch.minimum(eta_g, (eta0 * (1.0 + 1e-9))[..., None]), eta_ini


def _psi_pol(y):
    """The Polnarev scattering combination Psi."""
    FT, FP = y[_I_T:_I_T + LMAX_T + 1], y[_I_P:_I_P + LMAX_P + 1]
    return (FT[0] / 10.0 + FT[2] / 7.0 + 3.0 * FT[4] / 70.0
            - 3.0 * FP[0] / 5.0 + 6.0 * FP[2] / 7.0 - 3.0 * FP[4] / 70.0)


def _coefs_t(c, lanes, eta):
    """The tensor loop's coefficients at the fetched points ``c`` and
    ``eta`` (..., B, nk): the tight-coupling switch, the towers' closure
    factors (2L+1)/(k eta) and the stress factor 6 aH^2."""
    k = lanes.k
    c.update(tca=(c['kp'] > TCA_TRIGGER_AH * c['Hc']) & (c['kp'] > TCA_TRIGGER_K * k),
             S6=6.0 * c['Hc'] ** 2, fnu=c['fur'] + c['fnc'],    # ncdm massless for the tensor stress
             **{f'clos{L}': (2.0 * L + 1.0) / (k * eta) for L in {LMAX_T, LMAX_P, LMAX_N}})
    return c


def _tower(F, L, k, clos):
    """The advection of a tower F_0..F_L (L+1, B, nk):
    k/(2l+1) (l F_{l-1} - (l+1) F_{l+1}), closed by F_{L+1} =
    (2L+1)/(k eta) F_L - F_{L-1}."""
    l = torch.arange(L + 1, dtype=F.dtype, device=F.device).reshape(-1, 1, 1)
    Fm = torch.cat([torch.zeros_like(F[:1]), F[:-1]])
    Fp = torch.cat([F[1:], (clos * F[L] - F[L - 1])[None]])
    return k / (2.0 * l + 1.0) * (l * Fm - (l + 1.0) * Fp)


def deriv_tensor(y, lanes, c):
    """d/deta of the tensor state (h, h', FT, FP, FN), (N_STATE_T, B, nk),
    the photon towers frozen under tight coupling (projected after each
    step). ``c``: :func:`_fetch` and :func:`_coefs_t` at the lanes' eta."""
    k = lanes.k
    kp, tca = c['kp'], c['tca']
    h, hp = y[_I_H], y[_I_HP]
    FT, FP, FN = y[_I_T:_I_P], y[_I_P:_I_N], y[_I_N:]
    Psi = _psi_pol(y)

    def stress(F):
        return (8.0 / 15.0) * F[0] + (16.0 / 21.0) * F[2] + (8.0 / 35.0) * F[4]

    S = c['S6'] * (c['fg'] * stress(FT) + c['fnu'] * stress(FN))
    dFT = _tower(FT, LMAX_T, k, c[f'clos{LMAX_T}'])
    dFT[0] += -0.5 * hp - kp * (FT[0] - Psi)
    dFT[1:] += -kp * FT[1:]
    dFP = _tower(FP, LMAX_P, k, c[f'clos{LMAX_P}'])
    dFP[0] += -kp * (FP[0] + Psi)
    dFP[1:] += -kp * FP[1:]
    dFN = _tower(FN, LMAX_N, k, c[f'clos{LMAX_N}'])
    dFN[0] += -0.5 * hp
    return torch.cat([torch.stack([hp, -2.0 * c['Hc'] * hp - lanes.k2 * h + S]),
                      torch.where(tca, 0.0, dFT), torch.where(tca, 0.0, dFP), dFN])


def _tca_project_tensor(y, lanes, c):
    """Slave the photon towers to their quasi-steady values under tight
    coupling: FT0 = -(2/3) h'/kappa', FP0 = h'/(6 kappa'), the higher
    moments zero."""
    tca, kp, hp = c['tca'], c['kp'], y[_I_HP]
    y[_I_T] = torch.where(tca, -(2.0 / 3.0) * hp / kp, y[_I_T])
    y[_I_P] = torch.where(tca, hp / (6.0 * kp), y[_I_P])
    y[_I_T + 1:_I_P].masked_fill_(tca, 0.0)
    y[_I_P + 1:_I_N].masked_fill_(tca, 0.0)
    return y


def _project_t(y_start, y_end, lanes, drag, cm, c1):
    return _tca_project_tensor(y_end, lanes, c1)


def _emit_t(y, ydot, lanes, c):
    """The two line-of-sight source rows [h', Psi] of a step's end state."""
    return torch.stack([y[_I_HP], _psi_pol(y)])


def _tensor_z_nodes(n_rec=512, n_mid=192, n_reio=256, n_late=512):
    """The source-harvest template: the scalar one's, denser after
    reionization (the -h' e^-kappa source oscillates at k until tau0)."""
    z_rec = np.linspace(1690.0, 500.0, n_rec, endpoint=False)
    z_mid = np.geomspace(500.0, 30.0, n_mid, endpoint=False)
    z_reio = np.geomspace(30.0, 4.0, n_reio, endpoint=False)
    z_late = np.expm1(np.linspace(np.log1p(4.0), 0.0, n_late))
    return np.concatenate([z_rec, z_mid, z_reio, z_late])


def compute_tensor_sources(params, thermo, k, z_nodes=None, graphs=True):
    """Integrate the tensor system on each lane's grid and tap the two
    line-of-sight rows [h', Psi] per step, onto the shared tau grid of each
    cosmology (made from the redshift template ``z_nodes``, default
    :func:`_tensor_z_nodes`). ``k`` (B, nk) in 1/Mpc; ``params`` and
    ``thermo`` as :func:`~.perturbations.build_tables`; ``graphs`` replays the loop from
    CUDA graphs on the card. Returns {'tau' (B, n_tau), 'src'
    (B, nk, 2, n_tau), 'g', 'emk' (B, n_tau), 'eta0' (B, 1), 'k'}."""
    tabs = build_tables(params, thermo)
    eta_g = tensor_time_grid(tabs, k)[0].permute(2, 0, 1).contiguous()
    y0 = torch.zeros((N_STATE_T,) + k.shape, dtype=torch.float64, device=k.device)
    y0[_I_H] = 1.0                            # h(0) = 1, h'(0) = 0, the towers 0
    _, _, src_steps = _rk4_loop(deriv_tensor, _coefs_t, _project_t, y0, eta_g, tabs, TensorLanes(k), graphs,
                                emit=_emit_t)
    tau_h = _tau_nodes(tabs, _tensor_z_nodes() if z_nodes is None else z_nodes)
    src = _onto_tau(tau_h, (eta_g,), (src_steps,))
    c_h = _fetch(tabs, tau_h)
    B = tau_h.shape[0]
    lna_th = torch.from_numpy(_thermo.LNA_GRID).to(tau_h.device)
    emk = torch.exp(-interp(c_h['lna'], lna_th, thermo.tau.reshape(B, -1)))
    return {'tau': tau_h, 'src': src, 'g': c_h['kp'] * emk, 'emk': emk, 'eta0': tabs['eta0'], 'k': k}


def project_tensor_sources(src, ell_list, tables, P_T, dk_fine=DK_FINE, n_quad_late=1664):
    """Line-of-sight projection and C_l quadrature of the tensor sources at
    each sampled multipole. ``src``: :func:`compute_tensor_sources` on the
    coarse k grid (the rows' k the same), with 'K' (B, 1) [1/Mpc^2];
    ``P_T``: the primordial tensor power, a function of the fine k grid
    (nK,) -> (B, nK); ``dk_fine`` the fine grid's spacing at high k. Returns
    a dict of (B, n_ell) raw C_l: tt, ee, bb, te. Memory as
    :func:`~.harmonic.project_sources`."""
    k_f = _fine_grid(src, tensor_cl_kmin, dk_fine)
    hp, Psi = src['src'].unbind(2)
    g, emk = src['g'][:, None, :], src['emk'][:, None, :]
    S = torch.stack([-0.5 * emk * hp + g * Psi, g * Psi], dim=2)   # (B, nk_c, 2, n_h)
    ells = np.asarray(ell_list, dtype=np.float64)
    B = S.shape[0]
    pr = (_trapz_weights(k_f) / k_f) * np.pi * P_T(k_f)
    out = torch.zeros((4, B, ells.size), dtype=torch.float64, device=k_f.device)
    for rows in _row_chunks(B, k_f.numel(), N_REC + n_quad_late):
        gen = _projection(src, S, k_f, 3.0, tables, ells, n_quad_late, None, rows)
        (STf, SPf), w_q, xinvc = next(gen)
        xinvc2 = xinvc ** 2
        p = pr[rows]
        for i, jl, jlp in gen:
            ell = ells[i]
            jlpp = (ell * (ell + 1.0) * xinvc2 - 1.0) * jl - 2.0 * xinvc * jlp
            dT = np.sqrt((ell + 2.0) * (ell + 1.0) * ell * (ell - 1.0)) * torch.matmul(STf * jl * xinvc2, w_q)[..., 0]
            dE = torch.matmul(SPf * (-jl + jlpp + 2.0 * jl * xinvc2 + 4.0 * jlp * xinvc), w_q)[..., 0]
            dB = torch.matmul(SPf * (2.0 * jlp + 4.0 * jl * xinvc), w_q)[..., 0]
            out[:, rows, i] = torch.stack([torch.sum(p * a * b, dim=-1) for a, b in
                                           ((dT, dT), (dE, dE), (dB, dB), (dT, dE))])
    return dict(zip(('tt', 'ee', 'bb', 'te'), out))


def compute_tensor_cls(params, thermo, lmax=600, kmax=None, ells=None, graphs=True):
    """Tensor-mode CMB spectra of a batch: 'tt', 'ee', 'bb', 'te' (B, lmax + 1),
    raw dimensionless C_l, zero at l = 0, 1, and 'ell', 'ells_sampled',
    'raw_sampled'. ``params`` needs the scalar solver's keys and 'r' (and
    'n_t', 'alpha_t'), each (B,); P_T is proportional to r, so rows with
    r = 0 get exactly zero. ``ells`` (default :func:`~.bessel.default_ells`
    of ``lmax``) are the multipoles projected, echoed as 'ells_sampled'. The
    rows share one k grid (see :func:`~.harmonic.compute_cls`)."""
    if kmax is None:
        kmax = max(0.05, 1.7 * lmax / 13000.0)
    ells = bessel.default_ells(lmax) if ells is None else np.asarray(ells)
    K = _curvature(params)
    h = params['h']
    B = h.shape[0]
    k_c = torch.from_numpy(coarse_k_grid(kmax, kmin=shared_kmin(K, tensor_cl_kmin))).to(h.device).expand(B, -1)
    src = compute_tensor_sources(params, thermo, k_c, graphs=graphs)
    src['K'] = torch.from_numpy(K).to(h.device)[:, None]
    zero = torch.zeros_like(h)
    r, n_t, alpha_t = (params.get(name, zero) for name in ('r', 'n_t', 'alpha_t'))

    def P_T(k):
        kp = params['k_pivot'][:, None]
        lnkkp = torch.log(k / kp)
        return r[:, None] * params['A_s'][:, None] * (k / kp) ** (n_t[:, None] + 0.5 * alpha_t[:, None] * lnkkp)

    x_max = _x_max(kmax, K)
    if np.max(K) > 0.0:   # closed: q > k for tensors, widened by the worst eigenvalue
        x_max *= float(np.sqrt(1.0 + 3.0 * np.max(K) / tensor_cl_kmin(float(np.max(K))) ** 2))
    raw = project_tensor_sources(src, ells, bessel.bessel_tables(ells, x_max), P_T)
    zeros = torch.zeros((B, 2), dtype=torch.float64, device=h.device)
    out = {name: torch.cat([zeros, _spline_to_integers(ells, raw[name], lmax)], dim=-1)
           for name in ('tt', 'ee', 'bb', 'te')}
    out['ell'] = np.arange(lmax + 1)
    out['ells_sampled'] = ells
    out['raw_sampled'] = raw
    return out
