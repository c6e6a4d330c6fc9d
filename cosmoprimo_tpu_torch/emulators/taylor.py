"""Taylor-expansion emulator engine (cosmoprimo_tpu/emulators/taylor.py):
fits mixed partial derivatives on the uniform finite-difference grid that
:class:`~cosmoprimo_tpu_torch.emulators.samples.DiffSampler` produces (numpy,
as the JAX package), and predicts with the multivariate Taylor sum around
the parameter-box center, one tensordot."""

import itertools
import math

import numpy as np
import torch

from .base import BaseEmulatorEngine, register_emulator_engine


def fd_coefficients(order, npoints, h):
    """1D central finite-difference coefficients for derivative ``order`` on
    a uniform grid of ``npoints`` (odd) spacing ``h``, centered."""
    offsets = np.arange(npoints) - npoints // 2
    A = np.vander(offsets * h, npoints, increasing=True).T  # A[i, j] = (x_j)^i
    rhs = np.zeros(npoints)
    rhs[order] = math.factorial(order)
    return np.linalg.solve(A, rhs)


@register_emulator_engine
class TaylorEmulatorEngine(BaseEmulatorEngine):
    """Taylor expansion of order ``order`` around the parameter-box center."""

    name = 'taylor'
    _tensor_attrs = ('center', 'derivatives', 'powers')

    def __init__(self, *args, order=3, accuracy=2, **kwargs):
        super().__init__(*args, **kwargs)
        self.sampler_options = dict(order=order, accuracy=accuracy)

    def get_default_samples(self, calculator, params, **kwargs):
        from .samples import DiffSampler
        sampler = DiffSampler(calculator, params, device=self.device)
        samples = sampler.run(**{**self.sampler_options, **kwargs})
        samples.attrs.update(center={k: float(v) for k, v in sampler.center.items()},
                             deltas={k: float(v) for k, v in sampler.deltas.items()},
                             offsets=sampler.offsets.tolist(),
                             **self.sampler_options)
        return samples

    def _fit_no_operation(self, X, Y, attrs):
        if 'offsets' not in attrs:
            raise ValueError('provide samples obtained with DiffSampler')
        offsets = np.asarray(attrs['offsets'])
        npoints = offsets.size
        order = int(attrs.get('order', 3))
        ndim = X.shape[1]
        grid_shape = (npoints,) * ndim
        if len(X) != npoints ** ndim:
            raise ValueError('samples do not form a full finite-difference tensor grid')
        # sort rows into tensor-grid order
        sort_idx = np.lexsort(tuple(X[:, d] for d in reversed(range(ndim))))
        Xs = X[sort_idx].reshape(grid_shape + (ndim,))
        Ys = Y[sort_idx].reshape(grid_shape + (Y.shape[-1],))
        center_idx = (npoints // 2,) * ndim
        self.center = Xs[center_idx]
        h = np.array([attrs['deltas'][p] for p in self.params])

        self.powers, self.derivatives = [], []
        for total in range(order + 1):
            for power in itertools.product(range(order + 1), repeat=ndim):
                if sum(power) != total:
                    continue
                value = Ys
                for axis in range(ndim - 1, -1, -1):
                    p = power[axis]
                    if p == 0:
                        # select the center slice along this axis
                        value = np.take(value, npoints // 2, axis=axis)
                    else:
                        coeffs = fd_coefficients(p, npoints, h[axis])
                        value = np.tensordot(coeffs, np.moveaxis(value, axis, 0), axes=(0, 0))
                inv_fact = 1.0
                for p in power:
                    inv_fact /= math.factorial(p)
                self.powers.append(power)
                self.derivatives.append(value * inv_fact)
        self.powers = np.array(self.powers)
        self.derivatives = np.array(self.derivatives)

    def _predict_no_operation(self, X):
        t = self._on(X.device)
        diffs = X - t['center']
        powers = torch.prod(torch.where(t['powers'] > 0, diffs ** t['powers'], 1.0), dim=-1)
        return torch.tensordot(powers, t['derivatives'], dims=([0], [0]))

    def __getstate__(self):
        state = super().__getstate__()
        for name in ['sampler_options', 'center', 'derivatives', 'powers']:
            if hasattr(self, name):
                state[name] = getattr(self, name)
        return state
