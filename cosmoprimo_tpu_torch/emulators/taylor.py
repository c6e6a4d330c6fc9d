"""Taylor-expansion emulator engine, serving
(cosmoprimo_tpu/emulators/taylor.py): the multivariate Taylor sum around
the parameter-box center, one tensordot. The fit on the finite-difference
grid is not ported yet (ROADMAP slice 6b)."""

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
