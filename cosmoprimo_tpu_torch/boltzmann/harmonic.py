"""Native CMB angular power spectra by line-of-sight integration
(cosmoprimo_tpu/boltzmann/harmonic.py), batched over cosmologies.

Projects the perturbation solver's sources
(perturbations.compute_los_sources) onto the sky (Seljak & Zaldarriaga 1996):

    Delta_T,l(k) = int dtau { [g (Theta0 + psi + Pi/4) + e^-kappa (phi'+psi')] j_l(x)
                              + g (theta_b / k) j_l'(x) + (3/4) g Pi j_l''(x) }
    Delta_E,l(k) = sqrt((l+2)!/(l-2)!) int dtau (3/4) g Pi j_l(x) / x^2
    Delta_P,l(k) = -2 int_0^{chi*} dchi (chi*-chi)/(chi* chi) Psi_Weyl j_l(k chi)

with x = k (tau0 - tau) and C_l^XY = 4 pi int dln k P_R(k) Delta_X Delta_Y.

The tau quadrature and the k grids are static templates whose values follow
each cosmology; the rows of a batch share the k grids (one curvature grid),
each has its own tau grid. The Bessel tables do not depend on the cosmology
(boltzmann/bessel.py) and are evaluated by uniform-grid cubic-Hermite
gathers. The projection loops over the multipoles; per multipole it works on
(rows, n_k, n_tau) blocks, with the rows cut into chunks so that the blocks
stay under PROJECTION_BYTES (see :func:`project_sources`).
"""

import numpy as np
import torch

from ..ops import natural_cubic_coeffs, cubic_eval
from ..ops.spline import _cell_cubic
from . import bessel
from .perturbations import _C_KMS, compute_los_sources

N_REC = 512           # leading tau-harvest nodes spanning z in [1690, 500]
N_QUAD_LATE = 1152    # geometric tau-quadrature nodes after recombination
DK_COARSE = 0.0045    # 1/Mpc; resolves the acoustic phase k r_s of the sources
DK_FINE = 1.1e-4      # 1/Mpc; resolves the Delta_l(k) oscillation (pi/chi*)
KMIN = 3e-5           # 1/Mpc
K_LOG_SWITCH = 0.0035  # fine grid: 2%-log spacing below, uniform tiers above
K_MID = 0.02          # fine-grid mid-tier edge (the reionization oscillation)
K_LOG_SWITCH_COARSE = 0.012  # coarse grid: log spacing below, DK_COARSE above
LIMBER_PP_LO = 250    # pp: exact line of sight below, Limber above, linear blend between
LIMBER_PP_HI = 420
# the (rows, n_k, n_tau) float64 blocks of one multipole's projection, ~24 of
# them live at once, stay under this many bytes: at ellmax_cl = 2500 (lmax
# 2900, 5226 fine k, 2890 tau nodes) a row's block is 121 MB, so 8 rows
# (one chunk) hold ~23 GB at the peak
PROJECTION_BYTES = 24e9
_BLOCKS = 24


def coarse_k_grid(kmax, n_log=56, dk=DK_COARSE, kmin=KMIN):
    """The static k grid the Boltzmann hierarchy is integrated on [1/Mpc]
    (numpy)."""
    sw = K_LOG_SWITCH_COARSE
    n_lin = max(2, int(np.ceil((kmax - sw) / dk)) + 1)
    return np.concatenate([np.geomspace(kmin, sw, n_log, endpoint=False), np.linspace(sw, kmax, n_lin)])


def fine_k_grid(kmax, dk=DK_FINE, rel_log=0.02, kmin=KMIN):
    """The static k grid the line-of-sight integral is evaluated on [1/Mpc]
    (numpy): 2%-log below K_LOG_SWITCH, uniform dk/2 up to K_MID, uniform
    ``dk`` beyond. Raises for kmax <= K_LOG_SWITCH, where the JAX package's
    grid would run backwards."""
    if kmax <= K_LOG_SWITCH:
        raise ValueError(f'fine_k_grid needs kmax > {K_LOG_SWITCH} /Mpc, got {kmax}')
    k_mid = min(K_MID, kmax)
    n_mid = max(2, int(np.ceil((k_mid - K_LOG_SWITCH) / (0.5 * dk))) + 1)
    parts = [np.geomspace(kmin, K_LOG_SWITCH, max(2, int(np.ceil(np.log(K_LOG_SWITCH / kmin) / rel_log))),
                          endpoint=False),
             np.linspace(K_LOG_SWITCH, k_mid, n_mid, endpoint=False)]
    if kmax > k_mid:
        parts.append(np.linspace(k_mid, kmax, max(2, int(np.ceil((kmax - k_mid) / dk)) + 1)))
    else:
        parts.append(np.asarray([k_mid]))
    return np.concatenate(parts)


def sin_K(chi, K):
    """The comoving angular-diameter distance S_K(chi) [Mpc] for the
    curvature ``K`` [1/Mpc^2], a float or a tensor broadcasting against
    ``chi`` (open K < 0, closed K > 0)."""
    if not isinstance(K, torch.Tensor):
        K = torch.tensor(float(K), dtype=chi.dtype, device=chi.device)
    s = torch.sqrt(torch.abs(K))
    safe = torch.where(K == 0.0, 1.0, s)
    return torch.where(K > 0.0, torch.sin(safe * chi) / safe, torch.where(K < 0.0, torch.sinh(safe * chi) / safe, chi))


def cl_kmin(K, kmin=KMIN):
    """The smallest propagating wavenumber kept on the Cl grids [1/Mpc], for
    a float curvature ``K``: above the curvature scale when open, the first
    discrete eigenmode (k^2 >= 8 K) when closed."""
    if K < 0.0:
        return max(kmin, 1.05 * np.sqrt(-K))
    if K > 0.0:
        return max(kmin, np.sqrt(8.0 * K))
    return kmin


def _curvature(params):
    """The curvature K [1/Mpc^2] of each row of ``params`` (numpy)."""
    omega_k = params['omega_k'] if 'omega_k' in params else torch.zeros_like(params['h'])
    return -omega_k.reshape(-1).cpu().numpy() * (100.0 / _C_KMS) ** 2


def shared_kmin(K, kmin_fn=cl_kmin):
    """The k-grid floor ``kmin_fn`` of the curvatures ``K`` (numpy), which
    the rows of a batch share. Rows that would need different k grids raise
    NotImplementedError."""
    kmins = {kmin_fn(float(value)) for value in np.reshape(K, -1)}
    if len(kmins) > 1:
        raise NotImplementedError('the CMB spectra of a batch share one k grid, but these rows would need '
                                  'different ones (their curvature scales differ): build them as separate batches')
    return kmins.pop()


def _x_max(kmax, K):
    """The largest Bessel argument of the projection, for the rows'
    curvatures ``K`` (numpy): in an open geometry the argument q S_K(chi)
    carries the sinh stretch at the horizon."""
    x_max = float(kmax) * 1.05 * 16000.0
    if np.min(K) < 0.0:
        u_h = np.sqrt(-np.min(K)) * 16000.0
        x_max *= float(np.sinh(u_h) / u_h)
    return x_max


def _trapz_weights(x):
    """Trapezoid weights along the last axis."""
    dx = torch.diff(x, dim=-1)
    return 0.5 * torch.cat([dx[..., :1], dx[..., 1:] + dx[..., :-1], dx[..., -1:]], dim=-1)


def _hermite_gather(tab_f, tab_fp, u):
    """Cubic-Hermite evaluation of a uniform-grid table (n_x,) at the
    fractional indices ``u`` (the grid spacing folded into ``tab_fp`` by the
    caller)."""
    return _hermite(_hermite_basis(u, tab_f.shape[-1]), tab_f, tab_fp)


def _hermite_basis(u, n_x):
    """The cell index and the four Hermite basis values at ``u``: what every
    table evaluated at the same ``u`` shares."""
    i0 = torch.clamp(u.to(torch.int32), 0, n_x - 2).to(torch.int64)
    t = u - i0
    t2 = t * t
    t3 = t2 * t
    return i0, 2.0 * t3 - 3.0 * t2 + 1.0, t3 - 2.0 * t2 + t, -2.0 * t3 + 3.0 * t2, t3 - t2


def _hermite(basis, tab_f, tab_fp):
    i0, h00, h10, h01, h11 = basis
    i1 = i0 + 1
    return h00 * tab_f[i0] + h10 * tab_fp[i0] + h01 * tab_f[i1] + h11 * tab_fp[i1]


def geomspace_rows(start, stop, num):
    """``jnp.geomspace`` for per-row ``start`` / ``stop`` (B,) tensors:
    10 ** (the JAX package's linspace of their log10). Returns (B, num)."""
    lo, hi = torch.log10(start), torch.log10(stop)
    t = torch.arange(num - 1, dtype=start.dtype, device=start.device) / (num - 1)
    lin = torch.cat([lo[:, None] * (1 - t) + hi[:, None] * t, hi[:, None]], dim=-1)
    return 10.0 ** lin


def _linear_rows(x, f, t):
    """Piecewise-linear interpolation with edge extrapolation (the JAX
    package's ``linear_eval``) on per-row knots: ``x`` (B, n), ``f``
    (B, ..., n), ``t`` (B, m). Returns (B, ..., m)."""
    n = x.shape[-1]
    i = torch.clamp(torch.searchsorted(x.contiguous(), t.contiguous(), right=True) - 1, 0, n - 2)
    x0, x1 = torch.gather(x, -1, i), torch.gather(x, -1, i + 1)
    w = ((t - x0) / (x1 - x0)).reshape((t.shape[0],) + (1,) * (f.dim() - 2) + t.shape[-1:])
    index = i.reshape(w.shape).expand(f.shape[:-1] + t.shape[-1:])
    return torch.gather(f, -1, index) * (1 - w) + torch.gather(f, -1, index + 1) * w


def _primordial(P_params, k):
    """A_s (k/k_p)^(n_s - 1 + alpha_s/2 ln(k/k_p) + beta_s/6 ln^2(k/k_p))
    with each row's parameters ((B,) tensors) against ``k`` (B, ...)."""
    ns, As, kp, alpha_s, beta_s = (torch.as_tensor(v, dtype=k.dtype, device=k.device).reshape((-1,) + (1,) *
                                   (k.dim() - 1)) for v in P_params)
    lnkkp = torch.log(k / kp)
    return As * (k / kp) ** (ns - 1.0 + 0.5 * alpha_s * lnkkp + beta_s / 6.0 * lnkkp ** 2)


def _row_chunks(B, n_k, n_q):
    """Row slices of at most PROJECTION_BYTES of projection blocks each."""
    per_row = _BLOCKS * n_k * n_q * 8
    size = max(1, int(PROJECTION_BYTES // per_row))
    return [slice(b, min(b + size, B)) for b in range(0, B, size)]


def _projection(src, S, k_f, q_shift, tables, ells, n_quad_late, dtype, rows):
    """What the scalar and tensor projections share, for the rows ``rows``
    of ``src``: the tau quadrature (the first N_REC harvest nodes, then
    ``n_quad_late`` geometric nodes to eta0), the sources ``S``
    (B, nk_c, n_src, n_h) linearly resampled in tau and cubic-splined in k
    onto ``k_f``, the Bessel argument x = q S_K(chi) with q^2 = k^2 +
    ``q_shift`` K, and then, for each multipole index i in turn, j_l and j_l'
    at x. Yields first the sources (n_src, b, nK, n_q), the weights w_q
    (b, n_q, 1) and 1/max(x, dx) (b, nK, n_q), then (i, jl, jlp) per
    multipole."""
    k_c = src['k'][0]
    tau_h, eta0, S = src['tau'][rows], src['eta0'][rows], S[rows]
    K = src['K'][rows]
    tau_late = geomspace_rows(tau_h[:, N_REC], eta0[:, 0] * (1.0 - 1e-9), n_quad_late + 1)[:, 1:]
    tau_q = torch.cat([tau_h[:, :N_REC], tau_late], dim=-1)
    S_q = _linear_rows(tau_h, S, tau_q).movedim(1, 0)             # (nk_c, b, n_src, n_q)
    M = natural_cubic_coeffs(k_c, S_q)
    rdtype = dtype or S_q.dtype
    S_f = S_q.new_empty((S_q.shape[2], S_q.shape[1], k_f.numel(), S_q.shape[3]), dtype=rdtype)
    for j in range(S_f.shape[0]):   # one source at a time bounds the spline's temporaries
        S_f[j] = cubic_eval(k_c, S_q[:, :, j], M[:, :, j], k_f).movedim(0, 1)
    del S_q, M
    x_grid, j_tab, jp_tab = (t.to(rdtype) for t in bessel.device_tables(tables, S_f.device))
    dx = float(tables[0][1] - tables[0][0])
    jp_scaled = jp_tab * dx
    chi_q = (eta0 - tau_q).to(rdtype)
    q_f = torch.sqrt(torch.clamp(k_f.to(rdtype) ** 2 + q_shift * K.to(rdtype), min=0.0))   # (b, nK)
    x = q_f[:, :, None] * sin_K(chi_q, K.to(rdtype))[:, None, :]
    basis = _hermite_basis(x / dx, j_tab.shape[-1])
    yield S_f, _trapz_weights(tau_q).to(rdtype)[:, :, None], 1.0 / torch.clamp(x, min=dx)
    del x
    xn = torch.clamp(x_grid, min=dx)
    for i, ell in enumerate(np.asarray(ells, dtype=np.float64)):
        jl = _hermite(basis, j_tab[i], jp_scaled[i])
        # j' from (j', j'') Hermite, the nodal j'' from the Bessel equation
        l2 = ell * (ell + 1.0)
        jpp_nodes = (l2 / xn ** 2 - 1.0) * j_tab[i] - (2.0 / xn) * jp_tab[i]
        yield i, jl, _hermite(basis, jp_tab[i], jpp_nodes * dx)


def _fine_grid(src, kmin_fn, dk=DK_FINE):
    """The fine k grid (a tensor) of the sources' coarse grid, with the k
    floor their curvatures share and the spacing ``dk`` at high k."""
    k_c = src['k'][0]
    kmin = shared_kmin(src['K'].cpu().numpy(), kmin_fn)
    return torch.from_numpy(fine_k_grid(float(k_c[-1]), dk=dk, kmin=kmin)).to(k_c.device)


def _wlens(src, chi):
    """The lensing efficiency at the comoving distances ``chi`` (B, n),
    comoving distances replaced by S_K with curvature."""
    K, eta0 = src['K'], src['eta0']
    chi_star = eta0 - src['tau_star']
    sk = sin_K(chi, K)
    return torch.where((chi > 1e-4 * eta0) & (chi < chi_star),
                       -2.0 * sin_K(chi_star - chi, K) / (sin_K(chi_star, K) * torch.clamp(sk, min=1e-12)), 0.0), sk


def project_sources(src, ell_list, tables, dtype=None, t_parts=(1.0, 1.0, 1.0, 1.0), dk_fine=DK_FINE,
                    n_quad_late=N_QUAD_LATE):
    """Line-of-sight projection and C_l quadrature at each sampled multipole.

    ``src``: :func:`~.perturbations.compute_los_sources` on the coarse k grid
    (the rows' k the same), with 'P_R_params' (n_s, A_s, k_pivot, alpha_s,
    beta_s, each (B,)) and 'K' (B, 1) [1/Mpc^2]. ``tables``: (x_grid, j, jp)
    from :func:`~.bessel.bessel_tables` for ``ell_list``. ``dtype``: the
    projection's float type (default that of the sources). ``t_parts``
    weighs the temperature source's monopole, Doppler, polarisation and ISW
    terms (a diagnostic: 0 switches one off); ``dk_fine`` is the fine k
    grid's spacing at high k (:func:`fine_k_grid`). Returns a dict of
    (B, n_ell) raw C_l: tt, ee, te, pp, tp, ep.

    Memory: per multipole ~24 (rows, n_k_fine, n_tau) blocks, the rows cut
    into chunks of at most PROJECTION_BYTES."""
    k_f = _fine_grid(src, cl_kmin, dk_fine)
    tau_h, eta0, g, emk = src['tau'], src['eta0'], src['g'], src['emk']
    B = tau_h.shape[0]
    mono, dopp, pol, isw, weyl = src['src'].unbind(2)
    g3, emk3 = g[:, None, :], emk[:, None, :]
    wlens = _wlens(src, eta0 - tau_h)[0]
    w_mono, w_dopp, w_pol, w_isw = t_parts
    S = torch.stack([w_mono * g3 * mono + w_isw * emk3 * isw, w_dopp * g3 * dopp, w_pol * 0.75 * g3 * pol,
                     weyl * wlens[:, None, :]], dim=2)              # (B, nk_c, 4, n_h)
    ells = np.asarray(ell_list, dtype=np.float64)
    pr = (_trapz_weights(k_f) / k_f) * 4.0 * np.pi * _primordial(src['P_R_params'], k_f.expand(B, -1))
    out = torch.zeros((6, B, ells.size), dtype=torch.float64, device=k_f.device)
    for rows in _row_chunks(B, k_f.numel(), N_REC + n_quad_late):
        gen = _projection(src, S, k_f, 1.0, tables, ells, n_quad_late, dtype, rows)
        (ST0f, ST1f, ST2f, SPf), w_q, xinv = next(gen)
        xinv2 = xinv * xinv
        del xinv
        p = pr[rows].to(w_q.dtype)
        for i, jl, jlp in gen:
            ell = ells[i]
            jlpp = (ell * (ell + 1.0) * xinv2 - 1.0) * jl - 2.0 * torch.sqrt(xinv2) * jlp
            dT = torch.matmul(ST0f * jl + ST1f * jlp + ST2f * jlpp, w_q)[..., 0]
            del jlp, jlpp
            dE = np.sqrt((ell + 2.0) * (ell + 1.0) * ell * (ell - 1.0)) * torch.matmul(ST2f * jl * xinv2, w_q)[..., 0]
            dP = torch.matmul(SPf * jl, w_q)[..., 0]
            out[:, rows, i] = torch.stack([torch.sum(p * a * b, dim=-1) for a, b in
                                           ((dT, dT), (dE, dE), (dT, dE), (dP, dP), (dT, dP), (dE, dP))]).to(out.dtype)
    return dict(zip(('tt', 'ee', 'te', 'pp', 'tp', 'ep'), out))


def limber_pp(src, ells):
    """The Limber lensing-potential spectrum from the same Weyl source table,

        C_l^pp = (2 pi^2 / nu^3) int dchi S_K P_R(k) [wlens(chi) T_weyl(k, chi)]^2,

    nu = l + 1/2 and k = sqrt(nu^2 / S_K^2 - K): each (row, tau) column's
    cubic spline in k evaluated at its own k, as a gather on the shared
    knots. ``src`` as :func:`project_sources` (every k of the coarse grid);
    returns (B, n_ell)."""
    k_c, K = src['k'][0], src['K']
    tau_h = src['tau']
    wlens, sk = _wlens(src, src['eta0'] - tau_h)
    SP = (src['src'][:, :, 4, :] * wlens[:, None, :]).movedim(1, 0)       # (nk, B, n_h)
    M = natural_cubic_coeffs(k_c, SP)
    nu = torch.from_numpy(np.asarray(ells, dtype=np.float64) + 0.5).to(k_c.device)[:, None, None]
    kq = torch.sqrt(torch.clamp((nu / torch.clamp(sk, min=1e-3)) ** 2 - K, min=1e-30))   # (n_ell, B, n_h)
    n = k_c.shape[0]
    i = torch.clamp(torch.searchsorted(k_c, kq.contiguous(), right=True) - 1, 0, n - 2)

    def take(table, j):          # table (nk, B, n_h) at (n_ell, B, n_h) knot indices
        return torch.gather(table.permute(1, 2, 0), -1, j.permute(1, 2, 0)).permute(2, 0, 1)

    x0, x1 = k_c[i], k_c[i + 1]
    Sq = _cell_cubic(x1 - x0, kq - x0, x1 - kq, take(SP, i), take(SP, i + 1), take(M, i), take(M, i + 1))
    P_R = _primordial(src['P_R_params'], kq.movedim(1, 0)).movedim(0, 1)
    val = torch.where((kq <= k_c[-1]) & (kq >= k_c[0]), sk * P_R * Sq ** 2, 0.0)
    return ((2.0 * np.pi ** 2 / nu[:, :, 0] ** 3) * torch.sum(val * _trapz_weights(tau_h), dim=-1)).T


def _spline_to_integers(ells, cl, lmax):
    """The natural cubic spline of D_l = l(l+1) C_l against ln l onto every
    integer 2..lmax: ``cl`` (B, n_ell) -> (B, lmax - 1)."""
    ell = torch.from_numpy(np.asarray(ells, dtype=np.float64)).to(cl.device)
    ell_i = torch.arange(2, lmax + 1, dtype=torch.float64, device=cl.device)
    lnl = torch.log(ell)
    D = (ell * (ell + 1.0) * cl).T
    Di = cubic_eval(lnl, D, natural_cubic_coeffs(lnl, D), torch.log(ell_i)).T
    return Di / (ell_i * (ell_i + 1.0))


def _cl_inputs(params, thermo, lmax, kmax=None, kmax_pp=None, graphs=True, ells=None):
    """The grids and sources of :func:`compute_cls`: returns (src, src_main,
    ells, tables, n_quad_late), ``src`` the sources on the whole coarse grid
    (with 'P_R_params' and 'K'), ``src_main`` on its main (TT-sized) part."""
    if kmax is None:
        kmax = max(0.12, 2.4 * lmax / 13000.0)
    if kmax_pp is None:
        kmax_pp = max(kmax, lmax / 2100.0)
    ells = bessel.default_ells(lmax) if ells is None else np.asarray(ells)
    # the late tau quadrature scales with lmax: the j_l(k chi) period is 2 pi / k
    n_quad_late = max(N_QUAD_LATE, int(0.82 * lmax))
    K = _curvature(params)
    k_main = coarse_k_grid(kmax, kmin=shared_kmin(K))
    n_main = len(k_main)
    if kmax_pp > kmax * 1.001:
        n_tail = max(2, int(np.ceil(np.log(kmax_pp / kmax) / 0.04)))
        k_c = np.concatenate([k_main, kmax * np.exp(np.arange(1, n_tail + 1) * np.log(kmax_pp / kmax) / n_tail)])
    else:
        k_c = k_main
    h = params['h']
    k_c = torch.from_numpy(k_c).to(h.device).expand(h.shape[0], -1)
    src = compute_los_sources(params, thermo, k_c, graphs=graphs)
    src['P_R_params'] = tuple(params[name] if name in params else torch.zeros_like(h)
                              for name in ('n_s', 'A_s', 'k_pivot', 'alpha_s', 'beta_s'))
    src['K'] = torch.from_numpy(K).to(h.device)[:, None]
    tables = bessel.bessel_tables(ells, _x_max(kmax, K))
    src_main = dict(src, k=src['k'][:, :n_main], src=src['src'][:, :n_main])
    return src, src_main, ells, tables, n_quad_late


def compute_cls(params, thermo, lmax=2500, kmax=None, ells=None, dtype=None, kmax_pp=None, graphs=True):
    """Unlensed scalar CMB spectra of a batch, natively integrated.

    ``params`` and ``thermo`` as :func:`~.perturbations.build_tables` (with
    n_s, A_s, k_pivot, alpha_s, beta_s). Returns a dict of (B, lmax + 1)
    tensors 'tt', 'ee', 'bb', 'te', 'pp', 'tp', 'ep': raw dimensionless C_l,
    zero at l = 0, 1; and 'ell', 'ells_sampled', 'raw_sampled'.

    ``kmax`` bounds the TT/EE/TE projection (default max(0.12, 2.4 lmax /
    13000) /Mpc); ``kmax_pp`` (default max(kmax, lmax / 2100)) extends the
    coarse hierarchy grid with a 4%-log tail for the Limber lensing
    potential only. ``ells`` (default :func:`~.bessel.default_ells` of
    ``lmax``) are the multipoles projected, then splined to every integer;
    'ells_sampled' echoes them. The sources run at the full step budget;
    ``graphs`` as :func:`~.perturbations.integrate_perturbations`. The rows
    share one k grid, so their curvatures must give one (else
    NotImplementedError)."""
    src, src_main, ells, tables, n_quad_late = _cl_inputs(params, thermo, lmax, kmax, kmax_pp, graphs, ells)
    # the exact projection on the main (TT-sized) k grid only
    raw = project_sources(src_main, ells, tables, dtype=dtype, n_quad_late=n_quad_late)
    # the lensing potential: Limber at high l
    pp_lim = limber_pp(src, ells)
    device = pp_lim.device
    w_lim = torch.from_numpy(np.clip((ells.astype(np.float64) - LIMBER_PP_LO) / (LIMBER_PP_HI - LIMBER_PP_LO),
                                     0.0, 1.0)).to(device)
    raw['pp'] = (1.0 - w_lim) * raw['pp'] + w_lim * pp_lim.to(raw['pp'].dtype)
    out = {}
    B = pp_lim.shape[0]
    zeros = torch.zeros((B, 2), dtype=torch.float64, device=device)
    for name in ('tt', 'ee', 'te', 'pp', 'tp', 'ep'):
        out[name] = torch.cat([zeros, _spline_to_integers(ells, raw[name].to(torch.float64), lmax)], dim=-1)
    out['bb'] = torch.zeros((B, lmax + 1), dtype=torch.float64, device=device)
    out['ell'] = np.arange(lmax + 1)
    out['ells_sampled'] = ells
    out['raw_sampled'] = raw
    return out
