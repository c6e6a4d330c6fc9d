r"""BBKS (Bardeen, Bond, Kaiser, Szalay 1986) transfer function with the
Sugiyama (1995) shape parameter (cosmoprimo_tpu/models/bbks.py),
batch-first.

References: 1986ApJ...304...15B; astro-ph/9412025; arXiv:1812.05995 eqs.
15-16. As the JAX package, the canonical additive BBKS polynomial
``3.89 q + (16.2 q)^2``, where cosmoprimo has ``3.89 q * (16.2 q)^2``.
"""

import torch

from ..cosmology import BaseEngine, BaseSection, register_engine
# the no-wiggle sections, re-exported so that section discovery finds them
from .eisenstein_hu_nowiggle import Background, Fourier, Primordial  # noqa: F401


@register_engine
class BBKSEngine(BaseEngine):
    """BBKS transfer-function engine."""

    name = 'bbks'

    def __init__(self, cosmo, **extra_params):
        super().__init__(cosmo, **extra_params)
        self.compute()
        self._A_s = self._get_A_s_fid()

    def compute(self):
        """The Sugiyama 1995 shape parameter ``gamma`` (1812.05995 eq. 16):
        the batch shape."""
        self.gamma = self['omega_m'] * torch.exp(-self['Omega_b'] * (1.0 + torch.sqrt(2.0 * self['h']) / self['Omega_m']))


class Transfer(BaseSection):
    """BBKS86 transfer function."""

    def __init__(self, engine):
        super().__init__(engine)
        self._h = engine['h']
        self._gamma = engine.gamma

    def transfer_k(self, k):
        """Matter transfer function at 1D ``k`` in h/Mpc (1812.05995 eq. 15):
        batch + k.shape."""
        q = k * self._h[..., None] / self._gamma[..., None]
        x = 2.34 * q
        return torch.log(1 + x) / x * (1.0 + 3.89 * q + (16.2 * q) ** 2 + (5.47 * q) ** 3 + (6.71 * q) ** 4) ** (-0.25)
