r"""Power-spectrum and correlation-function interpolators
(cosmoprimo_tpu/interpolator.py): the tophat window, the sigma integrals,
the P(k) and xi(s) interpolators in 1D and 2D (tables or wrapped callables)
and the FFTLog transforms between them, ``to_xi`` and ``to_pk``.

Batch-first: a wrapped callable returns the batch on the leading axes and k
(or s) on the last, and so do the interpolators. A table is (..., nk) in 1D
and (..., nk, nz) in 2D, the batch leading. Grids (k, s, z) are sorted 1D
numpy arrays; the tables and the splines live on the device of the values.
"""

import functools

import numpy as np
import torch

from . import tracing
from .fftlog import CorrelationToPower, PowerToCorrelation, TophatVariance
from .ops import Interpolator1D, Interpolator2D, batch_scalar, bcast_dtype, leggauss, romberg, simpson  # noqa: F401
from .ops.spline import check_bounds


def get_default_k_callable():
    """Default k-grid (cosmopower-style, 540 points 1e-5 -> 1e2 h/Mpc)."""
    return np.concatenate([np.logspace(-5, -4, num=20, endpoint=False),
                           np.logspace(-4, -3, num=40, endpoint=False),
                           np.logspace(-3, -2, num=60, endpoint=False),
                           np.logspace(-2, -1, num=80, endpoint=False),
                           np.logspace(-1, 0, num=100, endpoint=False),
                           np.logspace(0, 2, num=240, endpoint=True)])


def get_default_s_callable():
    return np.logspace(-6.0, 2.0, 500)


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


# the least distance [dex] of the outer pad knot from the table's edge knot
_PAD_STEP = 1e-3


def _pad_log(k, pk, extrap_kmin=_default_extrap_kmin, extrap_kmax=_default_extrap_kmax):
    """Pad (log10 k, log10 pk) with two points per side continuing the edge
    power law out to the extrapolation range, the outer one at least
    _PAD_STEP dex beyond the edge knot. ``k``: (nk,) tensor; ``pk``: (nk, ...),
    knots first. Non-positive pk values are floored at 1e-250, since one NaN
    knot would poison the whole (global) spline solve.

    The JAX package puts the outer pad knot 1e-9 (relative) beyond the edge
    where the table reaches the extrapolation bound, so its pad knots lie
    4e-10 dex from the edge and the spline divides ulp-level differences of
    log10 P by that gap: rounding moves P(k) in the last cell by ~1e-7. The
    step keeps the pads resolvable; it changes the spline only where a table
    ends within _PAD_STEP of its bound (tests/test_torch_interpolator_pad.py)."""
    logk = torch.log10(k)
    logpk = torch.log10(torch.clamp(pk, min=1e-250))
    lo = torch.clamp(logk[0] - _PAD_STEP, max=float(np.log10(float(extrap_kmin))))
    hi = torch.clamp(logk[-1] + _PAD_STEP, min=float(np.log10(float(extrap_kmax))))

    slope_hi = (logpk[-1] - logpk[-2]) / (logk[-1] - logk[-2])
    pad_hi_k = torch.stack([logk[-1] * 0.1 + hi * 0.9, hi])
    pad_hi_pk = torch.stack([logpk[-1] + slope_hi * (pad_hi_k[0] - logk[-1]),
                             logpk[-1] + slope_hi * (pad_hi_k[1] - logk[-1])])

    slope_lo = (logpk[1] - logpk[0]) / (logk[1] - logk[0])
    pad_lo_k = torch.stack([lo, logk[0] * 0.1 + lo * 0.9])
    pad_lo_pk = torch.stack([logpk[0] + slope_lo * (pad_lo_k[0] - logk[0]),
                             logpk[0] + slope_lo * (pad_lo_k[1] - logk[0])])

    return torch.cat([pad_lo_k, logk, pad_hi_k]), torch.cat([pad_lo_pk, logpk, pad_hi_pk])


def _geomspace(a, b, n):
    """Host geometric grid with exact end points."""
    return np.clip(np.geomspace(float(a), float(b), n), float(a), float(b))


def _grid(x):
    """A 1D grid as a sorted numpy array, and the permutation that sorts it."""
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, dtype=np.float64).ravel()
    order = np.argsort(x)
    return x[order], order


def _on(device, array):
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


@functools.lru_cache(maxsize=None)
def _transform(cls, xmin, xmax, n):
    """The FFTLog transform ``cls`` on the geometric grid (xmin, xmax, n),
    with that grid, made once."""
    x = _geomspace(xmin, xmax, n)
    return cls(x), x


@functools.lru_cache(maxsize=None)
def _tophat_variance(kmin, kmax, nk, device):
    """The TophatVariance transform on a geometric k-grid, and that grid on
    ``device``, made once."""
    transform, k = _transform(TophatVariance, kmin, kmax, nk)
    return transform, _on(device, k)


def _apply(transform_cls, x, fun, fftlog_kwargs):
    """Run ``transform_cls`` on the grid ``x`` over the rows of ``fun``
    (..., n): returns the output grid (numpy) and the rows (..., n)."""
    if fftlog_kwargs:
        transform = transform_cls(x, **fftlog_kwargs)
    else:
        transform, _ = _transform(transform_cls, x[0], x[-1], x.size)
    _, out = transform(fun)
    return transform.y[0], out


# ----------------------------------------------------------------------------
# sigma integrals
# ----------------------------------------------------------------------------

def _log_nodes(kmin, kmax, method, nk, device):
    """Nodes in ln k and their weights for the fixed-order methods."""
    lo, hi = np.log(kmin * (1. + 1e-9)), np.log(kmax * (1. - 1e-9))
    if method == 'leggauss':
        xi, wi = leggauss(nk or 100)
        return _on(device, (hi - lo) / 2. * (1. + xi) + lo), _on(device, (hi - lo) / 2. * wi)
    return torch.linspace(lo, hi, nk or 1024, dtype=torch.float64, device=device), None


def _integrate_log(integrand, kmin, kmax, method, epsabs, epsrel, nk, device):
    """int d ln k of ``integrand(lnk)`` (..., n) by 'romberg', 'leggauss' or
    'simpson'."""
    if method == 'romberg':
        return romberg(integrand, float(np.log(kmin * (1. + 1e-9))), float(np.log(kmax * (1. - 1e-9))),
                       epsabs=epsabs, epsrel=epsrel, device=device)
    if method not in ('leggauss', 'simpson'):
        raise ValueError(f'unknown integration method {method!r}')
    logk, w = _log_nodes(kmin, kmax, method, nk, device)
    values = integrand(logk)
    return torch.sum(values * w, dim=-1) if method == 'leggauss' else simpson(values, x=logk, axis=-1)


def integrate_sigma_d2(pk, kmin=1e-7, kmax=1e2, method='simpson', epsabs=1e-5, epsrel=1e-5, nk=None, device=None):
    r"""Displacement-field variance :math:`\sigma_d^2 = \frac{1}{6\pi^2}\int dk P(k)`.

    ``pk(k)`` takes a (nk,) k tensor on ``device`` and returns (..., nk);
    the result is (...)."""
    def integrand(logk):
        k = torch.exp(logk)
        return k * pk(k)

    return _integrate_log(integrand, kmin, kmax, method, epsabs, epsrel, nk, device) / (6. * np.pi ** 2)


def integrate_sigma_r2(r, pk, kmin=1e-7, kmax=1e2, method='fftlog', epsabs=1e-5, epsrel=1e-5, nk=None,
                       kernel=kernel_tophat2, device=None):
    r"""Smoothed variance :math:`\sigma_r^2 = \frac{1}{2\pi^2}\int dk k^2 P(k) W^2(kr)`.

    ``pk(k)`` takes the (nk,) k tensor on ``device`` and returns (..., nk),
    k last; the result is (...) + r.shape. The 'fftlog' method runs one
    TophatVariance transform over every row on a 1024-point geometric grid
    (on a CUDA tensor, the FFTLog kernel) and splines the result in r;
    'romberg', 'leggauss' and 'simpson' integrate in ln k.
    """
    r = torch.as_tensor(r, dtype=torch.float64, device=device)
    if method == 'fftlog':
        transform, k = _tophat_variance(float(kmin), float(kmax), nk or 1024, torch.device(device or 'cpu'))
        p = pk(k)
        s, var = transform(p.reshape(-1, k.shape[0]))
        tmp = Interpolator1D(s, var.T, assume_sorted=True)(r.reshape(-1))   # (nr, rows)
        return tmp.T.reshape(p.shape[:-1] + r.shape)
    rr = r.reshape(-1)

    def integrand(logk):
        k = torch.exp(logk)
        return kernel(k * rr[:, None]) * (k ** 3 * pk(k))[..., None, :]

    tmp = _integrate_log(integrand, kmin, kmax, method, epsabs, epsrel, nk, device) / (2. * np.pi ** 2)
    return tmp.reshape(tmp.shape[:-1] + r.shape)


# ----------------------------------------------------------------------------
# Interpolators
# ----------------------------------------------------------------------------

class _BaseInterpolator(object):
    """Shared machinery: parameters, ``as_dict`` and ``clone``."""

    _grids = ()
    _values = None

    def params(self):
        return {name: getattr(self, name) for name in self.default_params}

    def as_dict(self):
        state = self.params()
        state.update({name: getattr(self, name) for name in self._grids})
        state[self._values] = getattr(self, self._values)
        return state

    def clone(self, **kwargs):
        """A table of the same class with ``kwargs`` replaced; the values
        are evaluated only if ``kwargs`` does not give them."""
        state = self.params()
        state.update({name: getattr(self, name) for name in self._grids})
        if self._values not in kwargs:
            state[self._values] = getattr(self, self._values)
        state.update(kwargs)
        return self.__class__(**state)

    def deepcopy(self):
        """A new table of the same class from :meth:`as_dict`."""
        return self.__class__(**self.as_dict())

    def copy(self):
        """A shallow copy: a new object sharing this one's tensors."""
        new = self.__class__.__new__(self.__class__)
        new.__dict__.update(self.__dict__)
        return new


class PowerSpectrumInterpolator1D(_BaseInterpolator):
    """P(k), NaN outside [extrap_kmin, extrap_kmax]: a table ``pk``
    (..., nk), splined in (log) k and (log) P, with the log-log power law
    continued to [extrap_kmin, extrap_kmax] if ``extrap_pk`` = 'log', or a
    callable (:meth:`from_callable`)."""

    _grids = ('k',)
    _values = 'pk'
    default_params = dict(interp_k='log', extrap_pk='log', extrap_kmin=_default_extrap_kmin,
                          extrap_kmax=_default_extrap_kmax, interp_order_k=3)

    def __init__(self, k, pk, interp_k='log', extrap_pk='log', extrap_kmin=_default_extrap_kmin,
                 extrap_kmax=_default_extrap_kmax, interp_order_k=3):
        self._rsigma8sq = 1.0
        pk = torch.as_tensor(pk, dtype=torch.float64)
        self.device = pk.device
        self.k, ik = _grid(k)
        self._pk = pk[..., _on(self.device, ik)]
        self.interp_k, self.extrap_pk, self.interp_order_k = str(interp_k), str(extrap_pk), int(interp_order_k)
        self.extrap_kmin, self.extrap_kmax = self.k[0], self.k[-1]
        kk, pp = _on(self.device, self.k), self._pk.movedim(-1, 0)          # knots first
        if self.extrap_pk == 'log':
            if self.interp_k != 'log':
                raise ValueError('log-log extrapolation requires log-k interpolation')
            self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
            kk, pp = _pad_log(kk, pp, extrap_kmin=extrap_kmin, extrap_kmax=extrap_kmax)
            kk, pp = 10 ** kk, 10 ** pp
        # the range is masked on the query k (__call__): the spline's own
        # knots are 10**log10(k), which rounding on the card can move past the
        # end points
        self._interp = Interpolator1D(kk, pp, k=self.interp_order_k, interp_x=self.interp_k,
                                      interp_fun=self.extrap_pk, extrap=True, assume_sorted=True)
        self.is_from_callable = False

    @classmethod
    def from_callable(cls, k=None, pk_callable=None, extrap_kmin=_default_extrap_kmin,
                      extrap_kmax=_default_extrap_kmax, device=None):
        """Wrap ``pk_callable(k)`` (k a 1D tensor on ``device``)."""
        self = cls.__new__(cls)
        self.__dict__.update(self.default_params)
        self.k, _ = _grid(get_default_k_callable() if k is None else k)
        self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
        self.device = device
        self.is_from_callable = True
        self._interp = pk_callable
        self._rsigma8sq = 1.0
        return self

    @property
    def pk(self):
        if self.is_from_callable:
            return self(self.k)
        return self._pk * batch_scalar(self._rsigma8sq, 1)

    @property
    def kmin(self):
        return self.k[0]

    @property
    def kmax(self):
        return self.k[-1]

    def __call__(self, k, bounds_error=False, **kwargs):
        """P(k): batch + k.shape. A table with ``bounds_error`` raises
        ValueError for a k outside [extrap_kmin, extrap_kmax] (a check on the
        host, so it waits for the device); ``kwargs`` go to a callable."""
        k = torch.as_tensor(k, dtype=torch.float64, device=self.device)
        shape = k.shape
        k = k.reshape(-1)
        mask = (k >= self.extrap_kmin) & (k <= self.extrap_kmax)
        if self.is_from_callable:
            tmp = self._interp(k, **kwargs)
        else:
            if bounds_error:
                check_bounds(mask)
            tmp = self._interp(k).movedim(0, -1)
        tmp = torch.where(mask, tmp, torch.nan)
        tmp = tmp * batch_scalar(self._rsigma8sq, 1)
        return tmp.reshape(tmp.shape[:-1] + shape)

    def sigma_d(self, **kwargs):
        r"""r.m.s. displacement :math:`\sigma_d`: the batch shape."""
        return integrate_sigma_d2(self, kmin=self.extrap_kmin, kmax=self.extrap_kmax, device=self.device,
                                  **kwargs) ** 0.5

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

    def to_xi(self, nk=1024, fftlog_kwargs=None, **kwargs):
        """P(k) -> xi(s) by FFTLog over every row (on a CUDA tensor, the
        kernel): a :class:`CorrelationFunctionInterpolator1D`."""
        with tracing.span('cosmoprimo.to_xi'):
            k = _geomspace(self.extrap_kmin, self.extrap_kmax, nk)
            s, xi = _apply(PowerToCorrelation, k, self(_on(self.device, k)), fftlog_kwargs)
            default_params = dict(interp_s='log', interp_order_s=self.interp_order_k)
            default_params.update(kwargs)
            return CorrelationFunctionInterpolator1D(s, xi=xi, **default_params)


class PowerSpectrumInterpolator2D(_BaseInterpolator):
    """P(k, z), NaN outside the k and z ranges: a table (``pk`` of shape
    (..., nk, nz), splined in (log) k and (log) P, with the log-log power
    law continued to [extrap_kmin, extrap_kmax] if ``extrap_pk`` = 'log';
    in z too when nz > 1, else times a separable ``growth_factor_sq(z)``),
    or a callable (:meth:`from_callable`)."""

    _grids = ('k', 'z')
    _values = 'pk'
    default_params = dict(interp_k='log', extrap_pk='log', extrap_kmin=_default_extrap_kmin,
                          extrap_kmax=_default_extrap_kmax, interp_order_k=3, interp_order_z=3,
                          growth_factor_sq=None)

    def __init__(self, k, z, pk, interp_k='log', extrap_pk='log', extrap_kmin=_default_extrap_kmin,
                 extrap_kmax=_default_extrap_kmax, interp_order_k=3, interp_order_z=3, growth_factor_sq=None):
        self._rsigma8sq = 1.0
        self.growth_factor_sq = growth_factor_sq
        pk = torch.as_tensor(pk, dtype=torch.float64)
        self.device = pk.device
        self.k, ik = _grid(k)
        self.z, iz = _grid(z)
        pk = pk[..., _on(self.device, ik), :]
        if pk.shape[-1] == self.z.shape[0]:
            pk = pk[..., _on(self.device, iz)]
        self._pk = pk
        self.interp_k, self.extrap_pk = str(interp_k), str(extrap_pk)
        self.interp_order_k, self.interp_order_z = int(interp_order_k), int(interp_order_z)
        self.extrap_kmin, self.extrap_kmax = self.k[0], self.k[-1]
        self.is_from_callable = False
        # the splines take the knots first: (nk, nz, ...)
        kk, pp = _on(self.device, self.k), pk.movedim((-2, -1), (0, 1))
        if self.extrap_pk == 'log':
            if self.interp_k != 'log':
                raise ValueError('log-log extrapolation requires log-k interpolation')
            self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
            kk, pp = _pad_log(kk, pp, extrap_kmin=extrap_kmin, extrap_kmax=extrap_kmax)
            kk, pp = 10 ** kk, 10 ** pp
        self._is2d = pk.shape[-1] > 1
        if self._is2d:
            # as in 1D, the (k, z) range is masked on the query (__call__)
            self._interp = Interpolator2D(kk, _on(self.device, self.z), pp, kx=self.interp_order_k,
                                          ky=min(self.interp_order_z, 3), interp_x=self.interp_k,
                                          interp_fun=self.extrap_pk, extrap=True, assume_sorted=True)
        else:
            if growth_factor_sq is None:
                raise ValueError('provide either 2D pk array or growth_factor_sq')
            self._interp = Interpolator1D(kk, pp[:, 0], k=self.interp_order_k, interp_x=self.interp_k,
                                          interp_fun=self.extrap_pk, extrap=True, assume_sorted=True)

    @classmethod
    def from_callable(cls, k=None, z=None, pk_callable=None, growth_factor_sq=None,
                      extrap_kmin=_default_extrap_kmin, extrap_kmax=_default_extrap_kmax, device=None):
        """Wrap ``pk_callable(k[, z, grid=...])`` with optional separable
        growth; k and z are 1D tensors on ``device``."""
        self = cls.__new__(cls)
        self.__dict__.update(self.default_params)
        self.k, _ = _grid(get_default_k_callable() if k is None else k)
        self.z, _ = _grid(get_default_z_callable() if z is None else z)
        self.growth_factor_sq = growth_factor_sq
        self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
        self.device = device
        self.is_from_callable = True
        self._interp = pk_callable
        self._rsigma8sq = 1.0
        return self

    @property
    def pk(self):
        if self.is_from_callable:
            return self(self.k, self.z, ignore_growth=self.growth_factor_sq is not None)
        return self._pk * batch_scalar(self._rsigma8sq, 2)

    @property
    def kmin(self):
        return self.k[0]

    @property
    def kmax(self):
        return self.k[-1]

    @property
    def zmin(self):
        return self.z[0]

    @property
    def zmax(self):
        return self.z[-1]

    def __call__(self, k, z, grid=True, ignore_growth=False, bounds_error=False):
        """P(k, z) of shape batch + k.shape + z.shape if ``grid``, else
        batch + k.shape for paired (k, z). ``bounds_error`` is accepted and
        not checked, as in the JAX package: the range is masked to NaN."""
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

    def _of_z(self, z):
        """``pk(k)`` for the sigma integrals: (..., nz, nk) at the raveled z."""
        return lambda k: self(k, z.reshape(-1)).transpose(-1, -2)

    def sigma_dz(self, z, **kwargs):
        r"""r.m.s. displacement :math:`\sigma_d(z)`: batch + z.shape."""
        z = torch.as_tensor(z, dtype=torch.float64, device=self.device)
        sig2 = integrate_sigma_d2(self._of_z(z), kmin=self.extrap_kmin, kmax=self.extrap_kmax, device=self.device,
                                  **kwargs)
        return sig2.reshape(sig2.shape[:-1] + z.shape) ** 0.5

    def sigma_rz(self, r, z, **kwargs):
        """r.m.s. of the field in a sphere of radius ``r`` (Mpc/h) at ``z``:
        batch + r.shape + z.shape."""
        r = torch.as_tensor(r, dtype=torch.float64, device=self.device)
        z = torch.as_tensor(z, dtype=torch.float64, device=self.device)
        sig2 = integrate_sigma_r2(r.reshape(-1), self._of_z(z), kmin=self.extrap_kmin, kmax=self.extrap_kmax,
                                  device=self.device, **kwargs)
        sig2 = sig2.transpose(-1, -2)                                # (..., nr, nz)
        return sig2.reshape(sig2.shape[:-2] + r.shape + z.shape) ** 0.5

    def sigma8_z(self, z=0, **kwargs):
        return self.sigma_rz(8.0, z=z, **kwargs)

    def rescale_sigma8(self, sigma8=1.0):
        """Rescale the amplitude so that :meth:`sigma8_z` at z = 0 returns
        ``sigma8``."""
        self._rsigma8sq = 1.0
        self._rsigma8sq = sigma8 ** 2 / self.sigma8_z(z=0) ** 2

    def growth_rate_rz(self, r, z, dz=1e-3, **kwargs):
        r"""f(r, z) = dln sigma_r / dln a by central differences, one-sided
        at the edges of the z-table: batch + r.shape + z.shape."""
        r = torch.as_tensor(r, dtype=torch.float64, device=self.device)
        z = torch.as_tensor(z, dtype=torch.float64, device=self.device)
        shape = r.shape + z.shape
        z = z.reshape(-1)
        hdz = dz / 2.0

        def logsig(zz):
            sig = self.sigma_rz(r, zz, **kwargs)
            return torch.log(sig).reshape(sig.shape[:sig.dim() - len(shape)] + (-1, z.numel()))

        feval = [logsig(z - dz), logsig(z - hdz), logsig(z), logsig(z + hdz), logsig(z + dz)]
        toret = torch.where(z < self.zmin + hdz, -feval[4] + 4 * feval[3] - 3 * feval[2], feval[3] - feval[1])
        toret = torch.where(z > self.zmax - hdz, -(-feval[0] + 4 * feval[1] - 3 * feval[2]), toret)
        dsigdlna = -toret / dz * (1 + z)
        return dsigdlna.reshape(dsigdlna.shape[:-2] + shape)

    def to_1d(self, z, **kwargs):
        """Slice at redshift ``z`` (a scalar): a :class:`PowerSpectrumInterpolator1D`."""
        if self.is_from_callable:
            return PowerSpectrumInterpolator1D.from_callable(self.k, pk_callable=lambda k: self(k, z=z),
                                                             extrap_kmin=self.extrap_kmin,
                                                             extrap_kmax=self.extrap_kmax, device=self.device)
        default_params = dict(extrap_pk=self.extrap_pk, extrap_kmin=self.extrap_kmin,
                              extrap_kmax=self.extrap_kmax, interp_order_k=self.interp_order_k)
        default_params.update(kwargs)
        k = _on(self.device, self.k)
        if self._is2d:
            pk = self._interp(k, torch.full((1,), float(z), dtype=torch.float64, device=self.device))[:, 0]
        else:
            pk = self._interp(k)
        pk = pk.movedim(0, -1)
        if self.growth_factor_sq is not None:
            pk = pk * batch_scalar(self.growth_factor_sq(torch.as_tensor(float(z), dtype=torch.float64,
                                                                         device=self.device)), 1)
        return PowerSpectrumInterpolator1D(self.k, pk * batch_scalar(self._rsigma8sq, 1), **default_params)

    def to_xi(self, nk=1024, fftlog_kwargs=None, **kwargs):
        """P(k, z) -> xi(s, z) by one FFTLog over every (batch, z) row (on a
        CUDA tensor, the kernel): a :class:`CorrelationFunctionInterpolator2D`."""
        with tracing.span('cosmoprimo.to_xi'):
            k = _geomspace(self.extrap_kmin, self.extrap_kmax, nk)
            pk = self(_on(self.device, k), _on(self.device, self.z), ignore_growth=True)
            s, xi = _apply(PowerToCorrelation, k, pk.transpose(-1, -2), fftlog_kwargs)
            default_params = dict(interp_s='log', interp_order_s=self.interp_order_k,
                                  interp_order_z=self.interp_order_z, growth_factor_sq=self.growth_factor_sq)
            default_params.update(kwargs)
            return CorrelationFunctionInterpolator2D(s, z=self.z, xi=xi.transpose(-1, -2), **default_params)


class CorrelationFunctionInterpolator1D(_BaseInterpolator):
    """xi(s), NaN outside [smin, smax]: a table ``xi`` (..., ns) splined in
    (log) s, or a callable (:meth:`from_callable`)."""

    _grids = ('s',)
    _values = 'xi'
    default_params = dict(interp_s='log', interp_order_s=3)

    def __init__(self, s, xi, interp_s='log', interp_order_s=3):
        self._rsigma8sq = 1.0
        xi = torch.as_tensor(xi, dtype=torch.float64)
        self.device = xi.device
        self.s, isort = _grid(s)
        self._xi = xi[..., _on(self.device, isort)]
        self.interp_s, self.interp_order_s = str(interp_s), int(interp_order_s)
        self._interp = Interpolator1D(_on(self.device, self.s), self._xi.movedim(-1, 0), k=self.interp_order_s,
                                      interp_x=self.interp_s, assume_sorted=True)
        self.is_from_callable = False

    @classmethod
    def from_callable(cls, s=None, xi_callable=None, device=None):
        """Wrap ``xi_callable(s)`` (s a 1D tensor on ``device``)."""
        self = cls.__new__(cls)
        self.__dict__.update(self.default_params)
        self._rsigma8sq = 1.0
        self.s, _ = _grid(get_default_s_callable() if s is None else s)
        self.device = device
        self.is_from_callable = True
        self._interp = xi_callable
        return self

    @property
    def xi(self):
        if self.is_from_callable:
            return self(self.s)
        return self._xi * batch_scalar(self._rsigma8sq, 1)

    @property
    def smin(self):
        return self.s[0]

    @property
    def smax(self):
        return self.s[-1]

    extrap_smin = smin
    extrap_smax = smax

    def __call__(self, s, bounds_error=False, **kwargs):
        """xi(s): batch + s.shape. A table with ``bounds_error`` raises
        ValueError for an s outside [smin, smax] (a check on the host);
        ``kwargs`` go to a callable."""
        s = torch.as_tensor(s, dtype=torch.float64, device=self.device)
        shape = s.shape
        s = s.reshape(-1)
        if self.is_from_callable:
            tmp = torch.where((s >= self.smin) & (s <= self.smax), self._interp(s, **kwargs), torch.nan)
        else:
            tmp = self._interp(s, bounds_error=bounds_error).movedim(0, -1)
        tmp = tmp * batch_scalar(self._rsigma8sq, 1)
        return tmp.reshape(tmp.shape[:-1] + shape)

    def sigma_d(self, **kwargs):
        return self.to_pk().sigma_d(**kwargs)

    def sigma_r(self, r, **kwargs):
        return self.to_pk().sigma_r(r, **kwargs)

    def sigma8(self, **kwargs):
        return self.sigma_r(8.0, **kwargs)

    def rescale_sigma8(self, sigma8=1.0):
        self._rsigma8sq = 1.0
        self._rsigma8sq = sigma8 ** 2 / self.sigma8() ** 2

    def to_pk(self, ns=1024, fftlog_kwargs=None, **kwargs):
        """xi(s) -> P(k) by FFTLog over every row (on a CUDA tensor, the
        kernel): a :class:`PowerSpectrumInterpolator1D`."""
        s = _geomspace(self.smin, self.smax, ns)
        k, pk = _apply(CorrelationToPower, s, self(_on(self.device, s)), fftlog_kwargs)
        default_params = dict(interp_k='log', interp_order_k=self.interp_order_s)
        default_params.update(kwargs)
        return PowerSpectrumInterpolator1D(k, pk=pk, **default_params)


class CorrelationFunctionInterpolator2D(_BaseInterpolator):
    """xi(s, z), NaN outside the s and z ranges: a table (``xi`` of shape
    (..., ns, nz), splined in (log) s, and in z when nz > 1, else times a
    separable ``growth_factor_sq(z)``), or a callable (:meth:`from_callable`)."""

    _grids = ('s', 'z')
    _values = 'xi'
    default_params = dict(interp_s='log', interp_order_s=3, interp_order_z=3, growth_factor_sq=None)

    def __init__(self, s, z, xi, interp_s='log', interp_order_s=3, interp_order_z=3, growth_factor_sq=None):
        self._rsigma8sq = 1.0
        self.growth_factor_sq = growth_factor_sq
        xi = torch.as_tensor(xi, dtype=torch.float64)
        self.device = xi.device
        self.s, isort = _grid(s)
        self.z, iz = _grid(z)
        xi = xi[..., _on(self.device, isort), :]
        if xi.shape[-1] == self.z.shape[0]:
            xi = xi[..., _on(self.device, iz)]
        self._xi = xi
        self.interp_s = str(interp_s)
        self.interp_order_s, self.interp_order_z = int(interp_order_s), int(interp_order_z)
        self._is2d = xi.shape[-1] > 1
        ss, xx = _on(self.device, self.s), xi.movedim((-2, -1), (0, 1))
        if self._is2d:
            self._interp = Interpolator2D(ss, _on(self.device, self.z), xx, kx=self.interp_order_s,
                                          ky=min(self.interp_order_z, 3), interp_x=self.interp_s, assume_sorted=True)
        else:
            if growth_factor_sq is None:
                raise ValueError('provide either 2D xi array or growth_factor_sq')
            self._interp = Interpolator1D(ss, xx[:, 0], k=self.interp_order_s, interp_x=self.interp_s,
                                          assume_sorted=True)
        self.is_from_callable = False

    @classmethod
    def from_callable(cls, s=None, z=None, xi_callable=None, growth_factor_sq=None, device=None):
        """Wrap ``xi_callable(s[, z, grid=...])`` with optional separable
        growth; s and z are 1D tensors on ``device``."""
        self = cls.__new__(cls)
        self.__dict__.update(self.default_params)
        self._rsigma8sq = 1.0
        self.s, _ = _grid(get_default_s_callable() if s is None else s)
        self.z, _ = _grid(get_default_z_callable() if z is None else z)
        self.growth_factor_sq = growth_factor_sq
        self.device = device
        self.is_from_callable = True
        self._interp = xi_callable
        return self

    @property
    def xi(self):
        if self.is_from_callable:
            return self(self.s, self.z, ignore_growth=True)
        return self._xi * batch_scalar(self._rsigma8sq, 2)

    @property
    def smin(self):
        return self.s[0]

    @property
    def smax(self):
        return self.s[-1]

    extrap_smin = smin
    extrap_smax = smax

    @property
    def zmin(self):
        return self.z[0]

    @property
    def zmax(self):
        return self.z[-1]

    def __call__(self, s, z, grid=True, ignore_growth=False, bounds_error=False):
        """xi(s, z) of shape batch + s.shape + z.shape if ``grid``, else
        batch + s.shape for paired (s, z). ``bounds_error`` as
        :meth:`PowerSpectrumInterpolator2D.__call__`."""
        s = torch.as_tensor(s, dtype=torch.float64, device=self.device)
        z = torch.as_tensor(z, dtype=torch.float64, device=self.device)
        shape = (s.shape + z.shape) if grid else s.shape
        s, z = s.reshape(-1), z.reshape(-1)
        mask_s = (s >= self.smin) & (s <= self.smax)
        mask_z = (z >= self.zmin) & (z <= self.zmax)
        if self.is_from_callable and self.growth_factor_sq is None:
            tmp = self._interp(s, z, grid=grid)
        else:
            if self.is_from_callable:
                tmp = self._interp(s)
            elif self._is2d:
                tmp = self._interp(s, z, grid=grid)
                tmp = tmp.movedim((0, 1), (-2, -1)) if grid else tmp.movedim(0, -1)
            else:
                mask_z = torch.ones_like(mask_z)
                tmp = self._interp(s).movedim(0, -1)
            if grid and (self.is_from_callable or not self._is2d):
                tmp = tmp[..., None].expand(tmp.shape + z.shape)
            if self.growth_factor_sq is not None and not ignore_growth:
                growth = self.growth_factor_sq(z)
                tmp = tmp * (growth[..., None, :] if grid else growth)
        mask = (mask_s[:, None] & mask_z) if grid else (mask_s & mask_z)
        tmp = torch.where(mask, tmp, torch.nan) * batch_scalar(self._rsigma8sq, 2 if grid else 1)
        return tmp.reshape(tmp.shape[:tmp.dim() - (2 if grid else 1)] + shape)

    def sigma_dz(self, z, **kwargs):
        return self.to_pk().sigma_dz(z=z, **kwargs)

    def sigma_rz(self, r, z, **kwargs):
        return self.to_pk().sigma_rz(r, z=z, **kwargs)

    def sigma8_z(self, z, **kwargs):
        return self.sigma_rz(8.0, z=z, **kwargs)

    def rescale_sigma8(self, sigma8=1.0):
        self._rsigma8sq = 1.0
        self._rsigma8sq = sigma8 ** 2 / self.sigma8_z(z=0) ** 2

    def growth_rate_rz(self, r, z, **kwargs):
        return self.to_pk().growth_rate_rz(r, z=z, **kwargs)

    def to_1d(self, z, **kwargs):
        """Slice at redshift ``z`` (a scalar): a :class:`CorrelationFunctionInterpolator1D`."""
        if self.is_from_callable:
            return CorrelationFunctionInterpolator1D.from_callable(self.s, lambda s: self(s, z=z), device=self.device)
        default_params = dict(interp_order_s=self.interp_order_s)
        default_params.update(kwargs)
        return CorrelationFunctionInterpolator1D(self.s, self(_on(self.device, self.s), z=z), **default_params)

    def to_pk(self, ns=1024, fftlog_kwargs=None, **kwargs):
        """xi(s, z) -> P(k, z) by one FFTLog over every (batch, z) row (on a
        CUDA tensor, the kernel): a :class:`PowerSpectrumInterpolator2D`."""
        s = _geomspace(self.smin, self.smax, ns)
        xi = self(_on(self.device, s), _on(self.device, self.z), ignore_growth=True)
        k, pk = _apply(CorrelationToPower, s, xi.transpose(-1, -2), fftlog_kwargs)
        default_params = dict(interp_k='log', extrap_pk='log', interp_order_k=self.interp_order_s,
                              interp_order_z=self.interp_order_z, growth_factor_sq=self.growth_factor_sq)
        default_params.update(kwargs)
        return PowerSpectrumInterpolator2D(k, z=self.z, pk=pk.transpose(-1, -2), **default_params)
