r"""Eisenstein & Hu (1998) zero-baryon ("no-wiggle") transfer function
(cosmoprimo_tpu/models/eisenstein_hu_nowiggle.py), batch-first.

Physics: EH98 eqs. 28-31 (the alpha_gamma / Gamma_eff smooth form).
"""

import numpy as np
import torch

from ..cosmology import BaseSection, register_engine
# the shared sections, re-exported so that section discovery finds them
from .eisenstein_hu import Background, Fourier, Primordial, Thermodynamics  # noqa: F401
from .eisenstein_hu import EisensteinHuEngine, compute_eh98_coefficients


@register_engine
class EisensteinHuNoWiggleEngine(EisensteinHuEngine):
    """EH98 no-wiggle engine."""

    name = 'eisenstein_hu_nowiggle'

    def compute(self):
        c = compute_eh98_coefficients(self)
        # EH98 eq. 31: effective shape parameter interpolation coefficient
        c['alpha_gamma'] = (1.0 - 0.328 * torch.log(431.0 * c['omega_m']) * c['frac_b']
                            + 0.38 * torch.log(22.3 * c['omega_m']) * c['frac_b'] ** 2)
        self._coefficients = c


class Transfer(BaseSection):
    """EH98 zero-baryon transfer function (eqs. 28-31)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._h = engine['h']
        for name in ['rs_drag', 'omega_m', 'alpha_gamma', 'theta_cmb']:
            setattr(self, '_' + name, getattr(engine, name))

    def transfer_k(self, k):
        """Matter transfer function at 1D ``k`` in h/Mpc: batch + k.shape."""
        rs_drag, omega_m, alpha_gamma, theta_cmb = (getattr(self, '_' + name)[..., None] for name in
                                                    ['rs_drag', 'omega_m', 'alpha_gamma', 'theta_cmb'])
        k = k * self._h[..., None]  # 1/Mpc
        ks = k * rs_drag
        gamma_eff = omega_m * (alpha_gamma + (1 - alpha_gamma) / (1 + (0.43 * ks) ** 4))
        q = k * theta_cmb ** 2 / gamma_eff
        L0 = torch.log(2 * np.e + 1.8 * q)
        C0 = 14.2 + 731.0 / (1 + 62.5 * q)
        return L0 / (L0 + C0 * q ** 2)
