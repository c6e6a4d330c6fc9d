"""Plain reference of the ``desi_bao_template`` configuration: for each
cosmology (flat LCDM with one massive neutrino), the Eisenstein & Hu (1998)
linear P(k) on the filter's k grid, its no-wiggle P(k) by the
'peakaverage' filter (the fiducial's BAO peaks and troughs, rescaled by the
sound-horizon ratio, splined in log k and averaged), the correlation
functions of both by FFTLog, the linear P(k, z) with growth, rs_drag and
chi at the DESI DR1 redshifts.

As in cosmoprimo, the P(k) table of a callable interpolator ignores growth,
so every redshift column of P(k), the no-wiggle P(k) and both xi is the
same spectrum; P(k, z), read from the interpolator with its growth factor,
is where the redshifts differ; the fiducial's peaks are those of its wiggly-to-no-wiggle
transfer ratio (its amplitude, growth and neutrino mass cancel in the
ratio) over a smooth correction fitted to the ratio's edges."""

import numpy as np
from scipy import signal

from . import common


def fiducial_peaks(k, fiducial, dtype=np.float64):
    """The knots of the filter on the grid ``k`` (numpy): two arrays of k
    (peaks, then troughs, each padded with the grid below 1e-3 h/Mpc and
    above the last extremum) and their (low pad, extrema, high pad) counts."""
    index = np.flatnonzero((k >= 1e-3) & (k <= 1.0))
    k_fid = k[index].astype(dtype)
    eh = common.EH98(*(np.array([fiducial[name]], dtype) for name in ('omega_cdm', 'omega_b', 'h')), dtype=dtype)
    ratio = (eh.transfer(k_fid) / eh.transfer_nowiggle(k_fid))[0] ** 2
    # k^-1 .. k^2 held to the ratio's first and last value and step: four
    # constraints on four coefficients
    gradient = np.array([k_fid ** (i - 1) for i in range(4)])
    edges = np.column_stack([gradient[:, 0], gradient[:, 1] - gradient[:, 0], gradient[:, -1],
                             gradient[:, -2] - gradient[:, -1]])
    values = np.array([ratio[0], ratio[1] - ratio[0], ratio[-1], ratio[-2] - ratio[-1]])
    correction = gradient.T @ np.linalg.solve(edges.T, values)
    ik0 = np.searchsorted(k_fid, 1e-2, side='right') + 1
    knots, pads = [], []
    for sign in (1.0, -1.0):
        ik = signal.find_peaks(sign * ratio[ik0:] / correction[ik0:], prominence=1e-10)[0] + ik0 + index[0]
        ikmax = max(index[-1], ik[-1] + 1)
        pads.append((int(index[0]), len(ik), k.size - ikmax))
        knots.append(k[np.concatenate([np.arange(index[0]), ik, np.arange(ikmax, k.size)])])
    return knots, pads


def peakaverage(k, ratio, rescale, knots, pads):
    """The filtered ratio (n, nk): for each row, the ratio splined in log10 k
    at the fiducial's knots divided by the row's sound-horizon ratio, splined
    again through those knots back onto ``k``, averaged over peaks and
    troughs."""
    logk = np.log10(k)
    one = np.ones_like(rescale)
    out = np.zeros_like(ratio)
    for k_knots, (low, mid, high) in zip(knots, pads):
        rescales = np.concatenate([common.linspace_rows(one, rescale, low), np.repeat(rescale[:, None], mid, axis=1),
                                   common.linspace_rows(rescale, one, high)], axis=1)
        log_knots = np.log10(k_knots[None, :].astype(ratio.dtype) / rescales)
        for row in range(ratio.shape[0]):
            at_knots = common.natural_spline(logk, ratio[row])(log_knots[row])
            out[row] += common.natural_spline(log_knots[row], at_knots)(logk).astype(ratio.dtype)
    return out / 2.0


def compute(params, config, dtype=np.float64):
    """``params``: (n,) arrays omega_cdm, omega_b, h, n_s, logA, m_ncdm.
    Returns pk, pknow, pk_z (n, nk, nz), xi, xi_smooth (n, ns, nz), rs_drag
    (n,) and chi (n, nz), in ``dtype``."""
    p = {name: np.asarray(value, dtype) for name, value in params.items()}
    z = np.asarray(config['z'], dtype)
    k64 = np.geomspace(config['kmin'], config['kmax'], config['nk'])
    k = k64.astype(dtype)
    background = common.Background(p['omega_cdm'], p['omega_b'], p['h'], m_ncdm=[p['m_ncdm']],
                                   N_eff=config['N_eff'], dtype=dtype)
    eh = common.EH98(p['omega_cdm'], p['omega_b'], p['h'], dtype=dtype)
    A_s = np.exp(p['logA']) * 1e-10
    pk = common.linear_pk(eh.transfer(k), background, A_s, p['n_s'], k)
    pk_eh = (common.linear_pk(eh.transfer_nowiggle(k), background, A_s, p['n_s'], k)
             * background.growth(np.zeros(1, dtype)) ** 2)
    fiducial = config['fiducial']
    eh_fid = common.EH98(*(np.array([fiducial[name]], dtype) for name in ('omega_cdm', 'omega_b', 'h')), dtype=dtype)
    rescale = eh.rs_drag * eh.h / (eh_fid.rs_drag * eh_fid.h)
    knots, pads = fiducial_peaks(k64, fiducial, dtype=dtype)
    pknow = peakaverage(k, pk / pk_eh, rescale, knots, pads) * pk_eh
    transform = common.PowerToCorrelation(k64, dtype=dtype)
    nz = z.size

    def columns(table):
        return np.repeat(table[:, :, None], nz, axis=2)

    return {'pk': columns(pk), 'pknow': columns(pknow), 'xi': columns(transform(pk)),
            'xi_smooth': columns(transform(pknow)), 'pk_z': columns(pk) * background.growth(z)[:, None, :] ** 2,
            'rs_drag': eh.rs_drag * eh.h,
            'chi': background.comoving_radial_distance(z)}
