r"""Power-spectrum interpolators (the ported part of
cosmoprimo_tpu/interpolator.py): the tophat window, the sigma_r integral by
FFTLog, the ``from_callable`` wrappers and the table form of the 2D
interpolator, with sigma_r(z), sigma8(z) and the sigma8 rescaling.

Batch-first: a wrapped callable returns the batch on the leading axes and k
on the last, and so do the interpolators. A table is (..., nk, nz), the
batch leading.
"""

import functools

import numpy as np
import torch

from .fftlog import TophatVariance
from .ops import Interpolator1D, Interpolator2D, batch_scalar

_NOT_PORTED = 'is not ported yet (ROADMAP.md, queue 1, slice 4)'


def get_default_k_callable():
    """Default k-grid (cosmopower-style, 540 points 1e-5 -> 1e2 h/Mpc)."""
    return np.concatenate([np.logspace(-5, -4, num=20, endpoint=False),
                           np.logspace(-4, -3, num=40, endpoint=False),
                           np.logspace(-3, -2, num=60, endpoint=False),
                           np.logspace(-2, -1, num=80, endpoint=False),
                           np.logspace(-1, 0, num=100, endpoint=False),
                           np.logspace(0, 2, num=240, endpoint=True)])


def get_default_z_callable():
    return np.linspace(0.0, 10.0 ** 0.5, 30) ** 2


_default_extrap_kmin = 1e-7
_default_extrap_kmax = 1e2


def _kernel_tophat_lowx(x2):
    r"""Maclaurin expansion of W(x) = 3(sin x - x cos x)/x^3 (CCL-stabilized)."""
    return 1. + x2 * (-1.0 / 10.0 + x2 * (1.0 / 280.0 + x2 * (-1.0 / 15120.0 + x2 * (1.0 / 1330560.0 + x2 * (-1.0 / 172972800.0)))))


def kernel_tophat2(x):
    """Squared 3D tophat window W^2(x), numerically stable at low x."""
    lowx = _kernel_tophat_lowx(x ** 2)
    safe = torch.where(x < 0.1, 1.0, x)
    highx = 3.0 * (torch.sin(safe) - safe * torch.cos(safe)) / safe ** 3
    return torch.where(x < 0.1, lowx, highx) ** 2


def _pad_log(k, pk, extrap_kmin=_default_extrap_kmin, extrap_kmax=_default_extrap_kmax):
    """Pad (log10 k, log10 pk) with two points per side continuing the edge
    power law out to the extrapolation range. ``k``: (nk,) tensor; ``pk``:
    (nk, ...), knots first. Non-positive pk values are floored at 1e-250,
    since one NaN knot would poison the whole (global) spline solve."""
    logk = torch.log10(k)
    logpk = torch.log10(torch.clamp(pk, min=1e-250))
    lo = torch.log10(torch.clamp(k[:1] * (1 - 1e-9), max=extrap_kmin))[0]
    hi = torch.log10(torch.clamp(k[-1:] * (1 + 1e-9), min=extrap_kmax))[0]

    slope_hi = (logpk[-1] - logpk[-2]) / (logk[-1] - logk[-2])
    pad_hi_k = torch.stack([logk[-1] * 0.1 + hi * 0.9, hi])
    pad_hi_pk = torch.stack([logpk[-1] + slope_hi * (pad_hi_k[0] - logk[-1]),
                             logpk[-1] + slope_hi * (pad_hi_k[1] - logk[-1])])

    slope_lo = (logpk[1] - logpk[0]) / (logk[1] - logk[0])
    pad_lo_k = torch.stack([lo, logk[0] * 0.1 + lo * 0.9])
    pad_lo_pk = torch.stack([logpk[0] + slope_lo * (pad_lo_k[0] - logk[0]),
                             logpk[0] + slope_lo * (pad_lo_k[1] - logk[0])])

    return torch.cat([pad_lo_k, logk, pad_hi_k]), torch.cat([pad_lo_pk, logpk, pad_hi_pk])


@functools.lru_cache(maxsize=None)
def _tophat_variance(kmin, kmax, nk, device):
    """The TophatVariance transform on a geometric k-grid, and that grid on
    ``device``, made once."""
    k = np.clip(np.geomspace(kmin, kmax, nk), kmin, kmax)
    return TophatVariance(k), torch.from_numpy(k).to(device)


def integrate_sigma_r2(r, pk, kmin=1e-7, kmax=1e2, method='fftlog', nk=None, device=None):
    r"""Smoothed variance :math:`\sigma_r^2 = \frac{1}{2\pi^2}\int dk k^2 P(k) W^2(kr)`.

    ``pk(k)`` takes the (nk,) k tensor on ``device`` and returns (..., nk),
    k last; the result is (...) + r.shape. The 'fftlog' method runs one
    TophatVariance transform over every row on a 1024-point geometric grid
    (on a CUDA tensor, the FFTLog kernel) and splines the result in r.
    """
    if method != 'fftlog':
        raise NotImplementedError(f'integrate_sigma_r2(method={method!r}) {_NOT_PORTED}; '
                                  "method='fftlog' is ported")
    transform, k = _tophat_variance(float(kmin), float(kmax), nk or 1024, torch.device(device or 'cpu'))
    p = pk(k)
    s, var = transform(p.reshape(-1, k.shape[0]))
    r = torch.as_tensor(r, dtype=torch.float64, device=k.device)
    tmp = Interpolator1D(s, var.T, assume_sorted=True)(r.reshape(-1))   # (nr, rows)
    return tmp.T.reshape(p.shape[:-1] + r.shape)


class PowerSpectrumInterpolator1D(object):
    """P(k) from a callable, NaN outside [extrap_kmin, extrap_kmax]."""

    @classmethod
    def from_callable(cls, k=None, pk_callable=None, extrap_kmin=_default_extrap_kmin,
                      extrap_kmax=_default_extrap_kmax, device=None):
        """Wrap ``pk_callable(k)`` (k a 1D tensor on ``device``)."""
        self = cls.__new__(cls)
        self.k = np.sort(np.asarray(get_default_k_callable() if k is None else k, dtype=np.float64).ravel())
        self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
        self.device = device
        self._interp = pk_callable
        self._rsigma8sq = 1.0
        return self

    def __call__(self, k):
        k = torch.as_tensor(k, dtype=torch.float64, device=self.device)
        shape = k.shape
        k = k.reshape(-1)
        mask = (k >= self.extrap_kmin) & (k <= self.extrap_kmax)
        tmp = torch.where(mask, self._interp(k), torch.nan) * batch_scalar(self._rsigma8sq, 1)
        return tmp.reshape(tmp.shape[:-1] + shape)

    def sigma_r(self, r, **kwargs):
        """r.m.s. of the field in a sphere of radius ``r`` (Mpc/h): batch + r.shape."""
        return integrate_sigma_r2(r, self, kmin=self.extrap_kmin, kmax=self.extrap_kmax, device=self.device,
                                  **kwargs) ** 0.5

    def sigma8(self, **kwargs):
        return self.sigma_r(8.0, **kwargs)

    def rescale_sigma8(self, sigma8=1.0):
        """Rescale the amplitude so that :meth:`sigma8` returns ``sigma8``."""
        self._rsigma8sq = 1.0
        self._rsigma8sq = sigma8 ** 2 / self.sigma8() ** 2


class PowerSpectrumInterpolator2D(object):
    """P(k, z), NaN outside the k and z ranges: a table (``pk`` of shape
    (..., nk, nz), splined in log k and log P with the log-log power law
    continued to [extrap_kmin, extrap_kmax]; cubic in z too when nz > 1,
    else times a separable ``growth_factor_sq(z)``), or a callable
    (:meth:`from_callable`)."""

    def __init__(self, k, z, pk, interp_k='log', extrap_pk='log', extrap_kmin=_default_extrap_kmin,
                 extrap_kmax=_default_extrap_kmax, interp_order_k=3, interp_order_z=3, growth_factor_sq=None):
        if (interp_k, extrap_pk, interp_order_k, min(interp_order_z, 3)) != ('log', 'log', 3, 3):
            raise NotImplementedError(f'only log-log cubic tables are ported; other options {_NOT_PORTED}')
        self._rsigma8sq = 1.0
        self.growth_factor_sq = growth_factor_sq
        pk = torch.as_tensor(pk, dtype=torch.float64)
        self.device = pk.device
        k = np.asarray(k.cpu() if isinstance(k, torch.Tensor) else k, dtype=np.float64).ravel()
        z = np.asarray(z.cpu() if isinstance(z, torch.Tensor) else z, dtype=np.float64).ravel()
        ik, iz = np.argsort(k), np.argsort(z)
        self.k, self.z = k[ik], z[iz]
        pk = pk[..., torch.from_numpy(ik).to(self.device), :]
        if pk.shape[-1] == self.z.shape[0]:
            pk = pk[..., torch.from_numpy(iz).to(self.device)]
        self._pk = pk
        self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
        self.is_from_callable = False
        # the splines take the knots first: (nk, nz, ...)
        kk, pp = _pad_log(torch.from_numpy(self.k).to(self.device), pk.movedim((-2, -1), (0, 1)),
                          extrap_kmin=extrap_kmin, extrap_kmax=extrap_kmax)
        kk, pp = 10 ** kk, 10 ** pp
        self._is2d = pk.shape[-1] > 1
        if self._is2d:
            self._interp = Interpolator2D(kk, torch.from_numpy(self.z).to(self.device), pp, interp_x='log',
                                          interp_fun='log', assume_sorted=True)
        else:
            if growth_factor_sq is None:
                raise ValueError('provide either 2D pk array or growth_factor_sq')
            self._interp = Interpolator1D(kk, pp[:, 0], interp_x='log', interp_fun='log', assume_sorted=True)

    @classmethod
    def from_callable(cls, k=None, z=None, pk_callable=None, growth_factor_sq=None,
                      extrap_kmin=_default_extrap_kmin, extrap_kmax=_default_extrap_kmax, device=None):
        """Wrap ``pk_callable(k[, z, grid=...])`` with optional separable
        growth; k and z are 1D tensors on ``device``."""
        self = cls.__new__(cls)
        self.k = np.sort(np.asarray(get_default_k_callable() if k is None else k, dtype=np.float64).ravel())
        self.z = np.sort(np.asarray(get_default_z_callable() if z is None else z, dtype=np.float64).ravel())
        self.growth_factor_sq = growth_factor_sq
        self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
        self.device = device
        self.is_from_callable = True
        self._interp = pk_callable
        self._rsigma8sq = 1.0
        return self

    @property
    def zmin(self):
        return self.z[0]

    @property
    def zmax(self):
        return self.z[-1]

    def __call__(self, k, z, grid=True, ignore_growth=False):
        """P(k, z) of shape batch + k.shape + z.shape if ``grid``, else
        batch + k.shape for paired (k, z)."""
        k = torch.as_tensor(k, dtype=torch.float64, device=self.device)
        z = torch.as_tensor(z, dtype=torch.float64, device=self.device)
        shape = (k.shape + z.shape) if grid else k.shape
        k, z = k.reshape(-1), z.reshape(-1)
        mask_k = (k >= self.extrap_kmin) & (k <= self.extrap_kmax)
        mask_z = (z >= self.zmin) & (z <= self.zmax)
        if self.is_from_callable and self.growth_factor_sq is None:
            tmp = self._interp(k, z, grid=grid)
        else:
            if self.is_from_callable:
                tmp = self._interp(k)
            elif self._is2d:
                tmp = self._interp(k, z, grid=grid)                  # (nk[, nz], ...)
                tmp = tmp.movedim((0, 1), (-2, -1)) if grid else tmp.movedim(0, -1)
            else:
                mask_z = torch.ones_like(mask_z)                     # a one-z table serves every z
                tmp = self._interp(k).movedim(0, -1)                 # (..., nk)
            if grid and (self.is_from_callable or not self._is2d):
                tmp = tmp[..., None].expand(tmp.shape + z.shape)
            if self.growth_factor_sq is not None and not ignore_growth:
                growth = self.growth_factor_sq(z)
                tmp = tmp * (growth[..., None, :] if grid else growth)
        mask = (mask_k[:, None] & mask_z) if grid else (mask_k & mask_z)
        tmp = torch.where(mask, tmp, torch.nan) * batch_scalar(self._rsigma8sq, 2 if grid else 1)
        return tmp.reshape(tmp.shape[:tmp.dim() - (2 if grid else 1)] + shape)

    def sigma_rz(self, r, z, **kwargs):
        """r.m.s. of the field in a sphere of radius ``r`` (Mpc/h) at ``z``:
        batch + r.shape + z.shape."""
        r = torch.as_tensor(r, dtype=torch.float64, device=self.device)
        z = torch.as_tensor(z, dtype=torch.float64, device=self.device)
        sig2 = integrate_sigma_r2(r.reshape(-1), lambda k: self(k, z.reshape(-1)).transpose(-1, -2),
                                  kmin=self.extrap_kmin, kmax=self.extrap_kmax, device=self.device, **kwargs)
        sig2 = sig2.transpose(-1, -2)                                # (..., nr, nz)
        return sig2.reshape(sig2.shape[:-2] + r.shape + z.shape) ** 0.5

    def sigma8_z(self, z=0, **kwargs):
        return self.sigma_rz(8.0, z=z, **kwargs)

    def rescale_sigma8(self, sigma8=1.0):
        """Rescale the amplitude so that :meth:`sigma8_z` at z = 0 returns
        ``sigma8``."""
        self._rsigma8sq = 1.0
        self._rsigma8sq = sigma8 ** 2 / self.sigma8_z(z=0) ** 2
