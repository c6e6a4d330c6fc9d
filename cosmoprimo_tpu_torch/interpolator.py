r"""Power-spectrum interpolators (the part of cosmoprimo_tpu/interpolator.py on
the headline path): the tophat window and the ``from_callable`` wrappers.

Batch-first: a wrapped callable returns the batch on the leading axes and k
on the last, and so do the interpolators.
"""

import numpy as np
import torch


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
        return self

    def __call__(self, k):
        k = torch.as_tensor(k, dtype=torch.float64, device=self.device)
        shape = k.shape
        k = k.reshape(-1)
        mask = (k >= self.extrap_kmin) & (k <= self.extrap_kmax)
        tmp = torch.where(mask, self._interp(k), torch.nan)
        return tmp.reshape(tmp.shape[:-1] + shape)


class PowerSpectrumInterpolator2D(object):
    """P(k, z) from a callable of k times a separable ``growth_factor_sq(z)``
    (or a callable of (k, z) when ``growth_factor_sq`` is None), NaN outside
    the k and z ranges."""

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
        self._interp = pk_callable
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
        if self.growth_factor_sq is not None:
            tmp = self._interp(k)
            if grid:
                tmp = tmp[..., None]
            if not ignore_growth:
                growth = self.growth_factor_sq(z)
                tmp = tmp * (growth[..., None, :] if grid else growth)
        else:
            tmp = self._interp(k, z, grid=grid)
        mask = (mask_k[:, None] & mask_z) if grid else (mask_k & mask_z)
        tmp = torch.where(mask, tmp, torch.nan)
        return tmp.reshape(tmp.shape[:tmp.dim() - (2 if grid else 1)] + shape)
