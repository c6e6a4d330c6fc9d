"""Background-only engine read from an ASCII table of z and background
quantities (cosmoprimo_tpu/models/tabulated.py), linearly interpolated.

One table serves every row of the batch: a query returns batch + z.shape.
A redshift outside the table gives NaN; nothing is checked on the host (the
JAX package raises there outside a trace: ROADMAP queue 3).
"""

import numpy as np
import torch

from ..cosmology import BaseEngine, BaseSection, register_engine
from ..ops import flatarray, interp


@register_engine
class TabulatedEngine(BaseEngine):
    """Engine reading the columns (z, <names>...) of the ASCII table
    ``filename`` (extra parameters ``filename`` and ``names``, by default
    efunc and comoving_radial_distance)."""

    name = 'tabulated'

    def __init__(self, cosmo, **extra_params):
        super().__init__(cosmo, **extra_params)
        self._names = self._extra_params.get('names', ['efunc', 'comoving_radial_distance'])
        arrays = np.loadtxt(self._extra_params['filename'], comments='#', usecols=range(len(self._names) + 1),
                            unpack=True)
        arrays = [torch.from_numpy(np.ascontiguousarray(array)).to(self.device) for array in arrays]
        self.z = arrays[0]
        self._tables = dict(zip(self._names, arrays[1:]))


class Background(BaseSection):
    """Tabulated background quantities (linear interpolation)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._z = engine.z
        self._tables = dict(engine._tables)
        self._batch_shape = engine.batch_shape

    @flatarray()
    def _interp(self, z, name):
        bad = (z < self._z[0]) | (z > self._z[-1])
        out = torch.where(bad, torch.nan, interp(z, self._z, self._tables[name]))
        return out.expand(self._batch_shape + out.shape)


def _make_accessor(name):
    def func(self, z):
        return self._interp(z, name)
    func.__name__ = name
    func.__doc__ = f'{name} at ``z`` from the table: batch + z.shape.'
    return func


for _name in ['efunc', 'comoving_radial_distance']:
    setattr(Background, _name, _make_accessor(_name))
