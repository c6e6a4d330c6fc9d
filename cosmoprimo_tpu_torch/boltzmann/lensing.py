"""Lensed CMB spectra from the unlensed ones and C_l^phiphi
(cosmoprimo_tpu/boltzmann/lensing.py), batched over cosmologies.

The correlation-function method (Seljak 1996; Challinor & Lewis 2005),
non-perturbative in the deflection variance sigma^2(r):

1. the deflection-difference covariances on an angular grid r,
       sigma^2(r) = sum_l w_l l(l+1) C_l^pp [1 - J_0(x)],  Cgl2(r) = sum_l w_l l(l+1) C_l^pp J_2(x),
   x = (l + 1/2) r, w_l = (2l+1)/4pi;
2. the lensed-minus-unlensed correlation functions, the Gaussian average
   over deflections expanded in I_n(beta), beta = l(l+1) Cgl2 / 2;
3. their transform back, delta-C_l = 2pi int r dr delta-xi(r) J_m((l+1/2) r),
   on the same quadrature, so that its bias cancels at zeroth order in the
   lensing correction.

The Bessel values J_m((l+1/2) r) do not depend on the cosmology: they are
made once per block of r and shared by the rows. The (n_r, lmax + 1)
blocks are cut along r into chunks of R_CHUNK.
"""

import functools

import numpy as np
import torch

R_MAX = np.pi / 8.0   # lensing correlations are dead beyond ~2 degrees
N_R = 8192
_DXJ = 0.05           # Bessel-table spacing in x = (l+1/2) r
# r nodes per chunk: at lmax 2900 a chunk's (B, R_CHUNK, lmax + 1) block is
# 24 MB a row, and ~20 of them live at once
R_CHUNK = 1024


@functools.lru_cache(maxsize=4)
def _bessel_j_tables(x_max, dx=_DXJ, mmax=10):
    """Uniform-grid J_0..J_mmax tables (host, numpy)."""
    from scipy.special import jv
    x = np.arange(0.0, x_max + 6 * dx, dx)
    return x, np.stack([jv(m, x) for m in range(mmax + 1)])


def _hermite_rows(tab, dtab, u, rows):
    """Cubic-Hermite of the table rows ``rows`` at the fractional index u."""
    n_x = tab.shape[-1]
    i0 = torch.clamp(u.to(torch.int32), 0, n_x - 2).to(torch.int64)
    t = u - i0
    t2, t3 = t ** 2, t ** 3
    h00 = 2.0 * t3 - 3.0 * t2 + 1.0
    h10 = t3 - 2.0 * t2 + t
    h01 = -2.0 * t3 + 3.0 * t2
    h11 = t3 - t2
    i1 = i0 + 1
    return [h00 * tab[m][i0] + h10 * dtab[m][i0] + h01 * tab[m][i1] + h11 * dtab[m][i1] for m in rows]


def _i_factors(beta):
    """(I_0..I_3)(|beta|) e^-|beta|, with the odd orders signed for beta < 0."""
    s = torch.sign(beta)
    b = torch.abs(beta)
    i0 = torch.special.i0e(b)
    i1 = torch.special.i1e(b)
    small = b < 1e-4
    bs = torch.where(small, 1.0, b)
    # upward recurrence I_{n+1} = I_{n-1} - (2n/b) I_n, series at small b
    i2 = torch.where(small, torch.exp(-b) * b * b / 8.0, i0 - (2.0 / bs) * i1)
    i3 = torch.where(small, torch.exp(-b) * b ** 3 / 48.0, i1 - (4.0 / bs) * i2)
    return i0, s * i1, i2, s * i3


def lensed_cls(cl_tt, cl_ee, cl_bb, cl_te, cl_pp, lmax=None, n_r=N_R, r_max=R_MAX):
    """Lensed 'tt', 'ee', 'bb', 'te' from the unlensed spectra and the
    lensing potential's, each (B, lmax_in + 1) indexed by l from 0. Returns
    a dict of (B, lmax + 1) tensors in the inputs' raw convention, zero at
    l = 0, 1."""
    lmax_in = cl_tt.shape[-1] - 1
    if lmax is None:
        lmax = lmax_in
    device = cl_tt.device
    ell = torch.arange(lmax_in + 1, dtype=torch.float64, device=device)
    lt = ell + 0.5
    llp1 = ell * (ell + 1.0)
    w_l = (2.0 * ell + 1.0) / (4.0 * np.pi)
    r = torch.from_numpy(np.linspace(r_max / n_r, r_max, n_r)).to(device)
    x_max = float(lmax_in + 0.5) * float(r_max)
    _, jt = _bessel_j_tables(x_max)
    jt = torch.from_numpy(jt).to(device)
    # the nodal derivatives from J_m' = (J_{m-1} - J_{m+1})/2, J_0' = -J_1
    djt = torch.cat([-jt[1:2], 0.5 * (jt[:-2] - jt[2:])]) * _DXJ
    wpp = w_l * llp1 * cl_pp                                            # (B, n_l)
    wt, wp, wm, wx = (w_l * cl for cl in (cl_tt, cl_ee + cl_bb, cl_ee - cl_bb, cl_te))
    wr = 2.0 * np.pi * r * (r[1] - r[0])
    ell_o = torch.arange(lmax + 1, dtype=torch.float64, device=device)
    dC = torch.zeros((4,) + cl_tt.shape[:-1] + (lmax + 1,), dtype=torch.float64, device=device)
    for lo in range(0, n_r, R_CHUNK):
        rc = r[lo:lo + R_CHUNK]
        j0, j2, j4, j6, j8 = _hermite_rows(jt, djt, (lt[None, :] * rc[:, None]) / _DXJ, (0, 2, 4, 6, 8))
        # the deflection covariances
        sigma2 = torch.sum(wpp, dim=-1, keepdim=True) - wpp @ j0.T      # (B, r)
        cgl2 = wpp @ j2.T
        # the lensed-minus-unlensed correlation functions
        beta = 0.5 * llp1 * cgl2[..., None]                              # (B, r, n_l)
        i0f, i1f, i2f, i3f = _i_factors(beta)
        damp = torch.exp(-0.5 * llp1 * sigma2[..., None] + torch.abs(beta))
        del beta
        kT = damp * (i0f * j0 + 2.0 * (i1f * j2 + i2f * j4 + i3f * j6)) - j0
        kM = damp * (i0f * j4 + i1f * (j2 + j6) + i2f * (j0 + j8)) - j4
        kX = damp * (i0f * j2 + i1f * (j0 + j4) + i2f * (j2 + j6)) - j2
        del damp, i0f, i1f, i2f, i3f
        dxi = [(kT @ wt[..., None])[..., 0], (kT @ wp[..., None])[..., 0], (kM @ wm[..., None])[..., 0],
               (kX @ wx[..., None])[..., 0]]
        del kT, kM, kX
        # the differences transformed back on the same r nodes
        o0, o2, o4 = _hermite_rows(jt, djt, ((ell_o + 0.5)[None, :] * rc[:, None]) / _DXJ, (0, 2, 4))
        w = wr[lo:lo + R_CHUNK]
        for n, (xi, o) in enumerate(zip(dxi, (o0, o0, o4, o2))):
            dC[n] += (w * xi) @ o

    def pad(cl):
        return cl[..., :lmax + 1] if lmax <= lmax_in else torch.nn.functional.pad(cl, (0, lmax - lmax_in))

    dC_T, dC_P, dC_M, dC_X = dC
    out = {'tt': pad(cl_tt) + dC_T, 'ee': pad(cl_ee) + 0.5 * (dC_P + dC_M), 'bb': pad(cl_bb) + 0.5 * (dC_P - dC_M),
           'te': pad(cl_te) + dC_X}
    for value in out.values():
        value[..., :2] = 0.0
    return out
