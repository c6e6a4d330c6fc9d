r"""FFTLog transforms (cosmoprimo_tpu/fftlog.py): FFTlog, PowerToCorrelation,
TophatVariance, ``pad`` and the Mellin kernels.

Computes :math:`G(y) = \int_0^\infty x\,dx\,F(x) K(xy)` for log-spaced x
(Hamilton 2000). The setup (output grid, Mellin coefficients ``padded_u``,
pre- and postfactors) is numpy on the host, in complex128, with ``loggamma``
from scipy. The transform runs on the tensor's device.
"""

import numpy as np
import torch
from scipy.special import loggamma as _loggamma

from .ops.fftlog_kernel import fftlog_core, fftlog_core_torch


# ----------------------------------------------------------------------------
# Mellin transforms of kernels: U_K(z) = \int_0^\infty t^{z-1} K(t) dt
# ----------------------------------------------------------------------------

class BaseKernel(object):
    """Base Mellin kernel, evaluated in numpy complex128."""

    def __call__(self, z):
        return self.eval(np.asarray(z, dtype=np.complex128))

    def __eq__(self, other):
        return other.__class__ == self.__class__


class BesselJKernel(BaseKernel):
    """Mellin transform of the Bessel function J_nu."""

    def __init__(self, nu):
        self.nu = nu

    def __eq__(self, other):
        return other.__class__ == self.__class__ and other.nu == self.nu

    def eval(self, z):
        return np.exp(np.log(2.0) * (z - 1) + _loggamma(0.5 * (self.nu + z)) - _loggamma(0.5 * (2 + self.nu - z)))


class SphericalBesselJKernel(BaseKernel):
    """Mellin transform of the spherical Bessel function j_ell."""

    def __init__(self, nu):
        self.nu = nu

    def __eq__(self, other):
        return other.__class__ == self.__class__ and other.nu == self.nu

    def eval(self, z):
        return np.exp(np.log(2.0) * (z - 1.5) + _loggamma(0.5 * (self.nu + z)) - _loggamma(0.5 * (3 + self.nu - z)))


class TophatKernel(BaseKernel):
    """Mellin transform of the ndim-dimensional tophat window."""

    def __init__(self, ndim=1):
        self.ndim = ndim

    def __eq__(self, other):
        return other.__class__ == self.__class__ and other.ndim == self.ndim

    def eval(self, z):
        return np.exp(np.log(2.0) * (z - 1) + _loggamma(1 + 0.5 * self.ndim)
                      + _loggamma(0.5 * z) - _loggamma(0.5 * (2 + self.ndim - z)))


class TophatSqKernel(BaseKernel):
    """Mellin transform of the squared tophat window."""

    def __init__(self, ndim=1):
        self.ndim = ndim

    def __eq__(self, other):
        return other.__class__ == self.__class__ and other.ndim == self.ndim

    def eval(self, z):
        if self.ndim == 1:
            return -0.25 * np.sqrt(np.pi) * np.exp(_loggamma(0.5 * (z - 2)) - _loggamma(0.5 * (3 - z)))
        if self.ndim == 3:
            return (2.25 * np.sqrt(np.pi) * (z - 2) / (z - 6)
                    * np.exp(_loggamma(0.5 * (z - 4)) - _loggamma(0.5 * (5 - z))))
        return np.exp(np.log(2.0) * (self.ndim - 1) + 2 * _loggamma(1 + 0.5 * self.ndim)
                      + _loggamma(0.5 * (1 + self.ndim - z)) + _loggamma(0.5 * z)
                      - _loggamma(1 + self.ndim - 0.5 * z) - _loggamma(0.5 * (2 + self.ndim - z))) / np.sqrt(np.pi)


class GaussianKernel(BaseKernel):
    """Mellin transform of the Gaussian window."""

    def eval(self, z):
        return 2 ** (0.5 * z - 1) * np.exp(_loggamma(0.5 * z))


class GaussianSqKernel(BaseKernel):
    """Mellin transform of the squared Gaussian window."""

    def eval(self, z):
        return 0.5 * np.exp(_loggamma(0.5 * z))


# ----------------------------------------------------------------------------
# Padding
# ----------------------------------------------------------------------------

def _sides(value):
    try:
        left, right = value
    except (TypeError, ValueError):
        left = right = value
    return left, right


def pad(array, pad_width, axis=-1, extrap=0):
    """Pad the tensor ``array`` along ``axis``; ``extrap`` is 'log' (log-log
    power-law continuation), 'edge', or a constant fill value; a (left, right)
    tuple differentiates the two sides."""
    wl, wr = _sides(pad_width)
    el, er = _sides(extrap)
    axis = axis % array.dim()
    size = array.shape[axis]
    to_axis = [1] * array.dim()
    to_axis[axis] = -1

    def take(i):
        return array.narrow(axis, i % size, 1)

    def arange(start, stop):
        return torch.arange(start, stop, dtype=array.dtype, device=array.device).reshape(to_axis)

    def fill(width, value):
        return torch.full(array.shape[:axis] + (width,) + array.shape[axis + 1:], value,
                          dtype=array.dtype, device=array.device)

    if el == 'edge':
        left = take(0).repeat_interleave(wl, dim=axis)
    elif el == 'log':
        end = take(0)
        left = end * (take(1) / end) ** arange(-wl, 0)
    else:
        left = fill(wl, el)

    if er == 'edge':
        right = take(-1).repeat_interleave(wr, dim=axis)
    elif er == 'log':
        end = take(-1)
        right = end / (take(-2) / end) ** arange(1, wr + 1)
    else:
        right = fill(wr, er)

    return torch.cat([left, array, right], dim=axis)


def _pad_log_np(array, pad_width):
    """Log-extrapolating pad along the last axis of a numpy array (setup)."""
    wl, wr = pad_width
    end_l = array[..., :1]
    ratio_l = array[..., 1:2] / end_l
    left = end_l * ratio_l ** np.arange(-wl, 0)
    end_r = array[..., -1:]
    ratio_r = array[..., -2:-1] / end_r
    right = end_r / ratio_r ** np.arange(1, wr + 1)
    return np.concatenate([left, array, right], axis=-1)


# ----------------------------------------------------------------------------
# FFTLog core
# ----------------------------------------------------------------------------

class FFTlog(object):
    r"""FFTLog transform engine performing ``nparallel`` kernel transforms at
    once (leading axis), each over a log-spaced coordinate array.

    Engines: ``'kernel'`` is the fused CUDA kernel (ops/fftlog_kernel.py;
    on a CPU tensor it runs that kernel's plain version), ``'torch'`` is
    unfused ``torch.fft`` in complex128, and ``'auto'`` means ``'kernel'``
    for a CUDA tensor and ``'torch'`` for a CPU tensor.
    """

    def __init__(self, x, kernel, q=0, minfolds=2, lowring=True, xy=1, engine='auto'):
        self.inparallel = isinstance(kernel, (tuple, list))
        self.set_fft_engine(engine)
        kernels = list(kernel) if self.inparallel else [kernel]
        nk = len(kernels)
        if np.ndim(q) == 0:
            q = [q] * nk
        if np.ndim(xy) == 0:
            xy = [xy] * nk
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, dtype=np.float64)
        shared_x = x.ndim == 1
        if not self.inparallel:
            x = x[None, :]
        elif x.ndim == 1:
            x = np.tile(x[None, :], (nk, 1))
        self.x = x
        self._setup(kernels, list(q), minfolds=minfolds, lowring=lowring, xy=list(xy), shared_x=shared_x)
        self._device_arrays = {}

    def set_fft_engine(self, engine='auto'):
        """Select the FFT engine used by :meth:`__call__`: 'auto', 'kernel'
        or 'torch' (see the class docstring)."""
        if engine not in ('auto', 'kernel', 'torch'):
            raise ValueError(f'unknown FFT engine {engine!r}; choose from auto/kernel/torch')
        self.engine = engine

    @property
    def nparallel(self):
        return self.x.shape[0]

    @property
    def size(self):
        return self.x.shape[-1]

    def _setup(self, kernels, qs, minfolds=2, lowring=True, xy=1.0, shared_x=True):
        size = self.size
        self.delta = np.log(self.x[:, -1] / self.x[:, 0]) / (size - 1)

        nfolds = (size * minfolds - 1).bit_length()
        self.padded_size = 2 ** nfolds
        npad = self.padded_size - size
        self.padded_size_in_left, self.padded_size_in_right = npad // 2, npad - npad // 2
        self.padded_size_out_left, self.padded_size_out_right = npad - npad // 2, npad // 2

        if lowring:
            self.lnxy = np.array([delta / np.pi * np.angle(kern(q + 1j * np.pi / delta))
                                  for kern, delta, q in zip(kernels, self.delta, qs)], dtype=np.float64)
        else:
            self.lnxy = np.log(np.asarray(xy, dtype=np.float64)) + self.delta

        self.y = np.exp(self.lnxy - self.delta)[:, None] / self.x[:, ::-1]

        m = np.arange(0, self.padded_size // 2 + 1)
        self.padded_x = _pad_log_np(self.x, (self.padded_size_in_left, self.padded_size_in_right))
        self.padded_y = _pad_log_np(self.y, (self.padded_size_out_left, self.padded_size_out_right))

        padded_u, padded_prefactor, padded_postfactor = [], [], []
        prev = (None, None, None, None)
        for kern, px, py, lnxy, delta, q in zip(kernels, self.padded_x, self.padded_y, self.lnxy, self.delta, qs):
            padded_prefactor.append(px ** (-q))
            padded_postfactor.append(py ** (-q))
            # Mellin coefficients are shared across rows when the kernel,
            # tilt and x-grid spacing coincide (x broadcast from 1D)
            if shared_x and kern == prev[0] and q == prev[1]:
                u = prev[3]
            else:
                u = kern(q + 2j * np.pi / self.padded_size / delta * m)
                prev = (kern, q, delta, u)
            padded_u.append(u * np.exp(-2j * np.pi * lnxy / self.padded_size / delta * m))
        self.padded_u = np.stack(padded_u)
        self.padded_prefactor = np.stack(padded_prefactor)
        self.padded_postfactor = np.stack(padded_postfactor)

    def _arrays(self, device):
        """Setup arrays as contiguous tensors on ``device``, made once."""
        if device not in self._device_arrays:
            def tensor(array):
                return torch.from_numpy(np.ascontiguousarray(array)).to(device)
            self._device_arrays[device] = {name: tensor(getattr(self, name)) for name in
                                           ('padded_u', 'padded_prefactor', 'padded_postfactor', 'y', 'padded_y')}
        return self._device_arrays[device]

    def __call__(self, fun, extrap=0, keep_padding=False):
        """Transform the tensor ``fun`` whose last axes broadcast against
        (nparallel, size); returns (y, transformed) on ``fun``'s device."""
        fun = torch.as_tensor(fun, dtype=torch.float64)
        arrays = self._arrays(fun.device)
        engine = self.engine
        if engine == 'auto':
            engine = 'kernel' if fun.is_cuda else 'torch'
        core = fftlog_core if engine == 'kernel' else fftlog_core_torch
        if self.inparallel:
            fun = fun.expand(torch.broadcast_shapes(fun.shape, (self.nparallel, self.size)))
        shape = fun.shape[:-1]
        rows = fun.reshape(-1, self.size).contiguous()
        args = (arrays['padded_u'], arrays['padded_prefactor'], arrays['padded_postfactor'])
        if not keep_padding and all(not isinstance(e, str) and e == 0 for e in _sides(extrap)):
            # zero padding, prefactor and crop are fused into the core
            out = core(rows, *args, self.padded_size_in_left, self.padded_size_out_left)
        else:
            padded = pad(rows, (self.padded_size_in_left, self.padded_size_in_right), extrap=extrap)
            out = core(padded.contiguous(), *args, 0, 0)
            if not keep_padding:
                out = out[:, self.padded_size_out_left:self.padded_size_out_left + self.size]
        y = arrays['padded_y' if keep_padding else 'y']
        if not self.inparallel:
            y = y[0]
        return y, out.reshape(shape + out.shape[-1:])


class PowerToCorrelation(FFTlog):
    r"""P(k) -> xi_ell(s): :math:`\xi_\ell(s) = \frac{(-i)^\ell}{2\pi^2}
    \int dk\,k^2 P_\ell(k) j_\ell(ks)`."""

    def __init__(self, k, ell=0, q=0, complex=False, **kwargs):
        kernel = SphericalBesselJKernel(ell) if np.ndim(ell) == 0 else [SphericalBesselJKernel(l) for l in ell]
        FFTlog.__init__(self, k, kernel, q=1.5 + q, **kwargs)
        self.padded_prefactor = self.padded_prefactor * self.padded_x ** 3 / (2 * np.pi) ** 1.5
        ell = np.atleast_1d(ell)
        if complex:
            phase = (-1j) ** ell
        else:
            # real inputs: the imaginary part of odd multipoles is provided
            phase = (-1) ** (ell // 2)
        self.padded_postfactor = self.padded_postfactor * phase[:, None]


class TophatVariance(FFTlog):
    r"""P(k) -> sigma^2(r) with a 3D tophat window: the transform returns
    :math:`\frac{1}{2\pi^2}\int dk\,k^2 P(k) W^2(kr)`."""

    def __init__(self, k, q=0, **kwargs):
        kernel = TophatSqKernel(ndim=3)
        FFTlog.__init__(self, k, kernel, q=1.5 + q, **kwargs)
        self.padded_prefactor = self.padded_prefactor * self.padded_x ** 3 / (2 * np.pi ** 2)
