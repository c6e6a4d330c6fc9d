r"""Eisenstein & Hu (1999) no-wiggle transfer function with massive
neutrinos: scale-dependent growth with free-streaming suppression
(cosmoprimo_tpu/models/eisenstein_hu_nowiggle_variants.py), batch-first.

Physics: arXiv:astro-ph/9710252 eqs. 1-23 (z_eq, p_c/p_cb, alpha_nu,
gamma_eff, y_freestream, delta_cb against delta_m growth).
"""

import numpy as np
import torch

from .. import constants
from ..cosmology import BaseSection, CosmologyError, register_engine
from ..interpolator import PowerSpectrumInterpolator2D
from ..ops import batch_scalar
# the EH98 sections, re-exported so that section discovery finds them
from .eisenstein_hu import Background, Primordial, Thermodynamics  # noqa: F401
from .eisenstein_hu import EisensteinHuEngine, Fourier as _EHFourier


@register_engine
class EisensteinHuNoWiggleVariantsEngine(EisensteinHuEngine):
    """EH99 no-wiggle engine with massive-neutrino suppression."""

    name = 'eisenstein_hu_nowiggle_variants'

    def compute(self):
        c = {}
        c['omega_b'] = self['omega_b']
        c['omega_m'] = self['omega_cdm'] + self['omega_b'] + self['omega_ncdm_tot'] - self['omega_pncdm_tot']
        c['frac_b'] = c['omega_b'] / c['omega_m']
        c['frac_cdm'] = self['omega_cdm'] / c['omega_m']
        c['frac_cb'] = c['frac_cdm'] + c['frac_b']
        c['frac_ncdm'] = 1.0 - c['frac_cb']
        c['N_ncdm'] = self['N_ncdm']
        c['theta_cmb'] = self['T_cmb'] / 2.7

        om, ob, th = c['omega_m'], c['omega_b'], c['theta_cmb']
        # EH99 eq. 1
        c['z_eq'] = 2.5e4 * om * th ** (-4) - 1.0
        c['k_eq'] = 0.0746 * om * th ** (-2)
        # EH99 eq. 2 (the EH98 z_drag normalization)
        b1 = 0.313 * om ** (-0.419) * (1 + 0.607 * om ** 0.674)
        b2 = 0.238 * om ** 0.223
        c['z_drag'] = 1291 * om ** 0.251 / (1.0 + 0.659 * om ** 0.828) * (1.0 + b1 * ob ** b2)
        # EH98 eq. 26, the approximate sound horizon
        c['rs_drag'] = 44.5 * torch.log(9.83 / om) / torch.sqrt(1.0 + 10.0 * ob ** 0.75)

        frac_bncdm = c['frac_b'] + c['frac_ncdm']
        # EH99 eq. 11: growth exponents
        c['p_c'] = (5.0 - torch.sqrt(1 + 24 * c['frac_cdm'])) / 4.0
        c['p_cb'] = (5.0 - torch.sqrt(1 + 24.0 * c['frac_cb'])) / 4.0
        y_drag = (1 + c['z_eq']) / (1 + c['z_drag'])
        # EH99 eq. 15: small-scale suppression
        alpha_ncdm = (c['frac_cdm'] / c['frac_cb'] * (5.0 - 2.0 * (c['p_c'] + c['p_cb'])) / (5.0 - 4.0 * c['p_cb'])
                      * (1 + y_drag) ** (c['p_cb'] - c['p_c'])
                      * (1 + frac_bncdm * (-0.553 + 0.126 * frac_bncdm ** 2))
                      / (1 - 0.193 * torch.sqrt(c['frac_ncdm'] * c['N_ncdm']) + 0.169 * c['frac_ncdm'] * c['N_ncdm'] ** 0.2)
                      * (1 + (c['p_c'] - c['p_cb']) / 2 * (1 + 1 / (3.0 - 4.0 * c['p_c']) / (7.0 - 4.0 * c['p_cb'])) / (1 + y_drag)))
        c['gamma_ncdm'] = torch.sqrt(alpha_ncdm)
        c['beta_c'] = 1 / (1 - 0.949 * frac_bncdm)
        self._coefficients = c


class Transfer(BaseSection):
    """EH99 transfer function with scale-dependent ncdm growth."""

    def __init__(self, engine):
        super().__init__(engine)
        self._h = engine['h']
        for name in ['omega_m', 'theta_cmb', 'N_ncdm', 'frac_ncdm', 'z_eq', 'p_cb', 'frac_cb',
                     'gamma_ncdm', 'rs_drag', 'beta_c']:
            setattr(self, '_' + name, getattr(engine, name))
        self.ba = engine.get_background()

    def transfer_kz(self, k, z=0.0, of='delta_m', grid=True):
        """Transfer function at 1D ``k`` (h/Mpc) and ``z``: batch + (nk, nz)
        on the grid, or batch + (nk,) at paired (k, z) if not ``grid``."""
        z = torch.as_tensor(z, dtype=torch.float64, device=self.device).reshape(-1)
        k = torch.as_tensor(k, dtype=torch.float64, device=self.device)
        if grid:
            k = k[:, None]
        naxes = k.dim()

        def col(value):   # a coefficient against k's axes
            return batch_scalar(value, naxes)

        k = k * col(self._h)   # 1/Mpc
        omega_m, frac_ncdm, p_cb, gamma_ncdm = col(self._omega_m), col(self._frac_ncdm), col(self._p_cb), col(self._gamma_ncdm)
        q = k / omega_m * col(self._theta_cmb) ** 2
        N = self._N_ncdm

        # scale-dependent growth (EH99 eqs. 12-14)
        if N:
            growth_k0 = self.ba.growth_factor(z, znorm=self._z_eq)   # batch + (nz,)
            if grid:
                growth_k0 = growth_k0[..., None, :]
            y_fs = 17.2 * frac_ncdm * (1 + 0.488 * frac_ncdm ** (-7.0 / 6.0)) * (N * q / frac_ncdm) ** 2
            tmp1 = growth_k0 ** (1.0 - p_cb)
            tmp2 = (growth_k0 / (1 + y_fs)) ** 0.7
            if of == 'delta_cb':
                growth = (1.0 + tmp2) ** (p_cb / 0.7) * tmp1
            elif of == 'delta_m':
                growth = (col(self._frac_cb) ** (0.7 / p_cb) + tmp2) ** (p_cb / 0.7) * tmp1
            else:
                raise CosmologyError(f'No {of} transfer (choices: ["delta_cb", "delta_m"])')
        else:
            growth = growth_k0 = torch.ones_like(z)

        # master function (EH99 eqs. 16-18)
        gamma_eff = omega_m * (gamma_ncdm + (1 - gamma_ncdm) / (1 + (k * col(self._rs_drag) * 0.43) ** 4))
        q_eff = q * omega_m / gamma_eff
        T_L = torch.log(np.e + 1.84 * col(self._beta_c) * gamma_ncdm * q_eff)
        T_C = 14.4 + 325.0 / (1 + 60.5 * q_eff ** 1.08)
        T_sup = T_L / (T_L + T_C * q_eff ** 2)

        # free-streaming correction (EH99 eqs. 22-23)
        if N:
            q_ncdm = 3.92 * q * torch.sqrt(N / frac_ncdm)
            T_sup = T_sup * (1 + 1.24 * frac_ncdm ** 0.64 * N ** (0.3 + 0.6 * frac_ncdm)
                             / (q_ncdm ** (-1.6) + q_ncdm ** 0.8))
        return T_sup * growth / growth_k0


class Fourier(_EHFourier):
    """Power spectra with the scale-dependent growth folded into the (k, z)
    transfer; HMcode takes the cold field's P(k) for sigma(R)."""

    def _pk_interpolator_cb(self, **kwargs):
        return self.pk_interpolator(of='delta_cb', **kwargs)

    def _linear_pk_interpolator(self, of, **kwargs):
        """P(k, z) for 'delta_m' / 'delta_cb', or one or two 'theta_*'
        (velocity spectra, rescaled by the growth rate)."""
        if not isinstance(of, (tuple, list)):
            of = (of, of)
        ntheta = sum(o.startswith('theta_') for o in of)
        of = tuple(o.replace('theta_', 'delta_') for o in of)
        ba, pm, tr = self.ba, self.pm, self.tr

        def growth_factor_sq(z):
            growth = ba.growth_factor(z, znorm=0.0) ** 2
            return growth * ba.growth_rate(z) ** ntheta if ntheta else growth

        def pk_callable(k, z, grid=True):
            tk = tr.transfer_kz(k, z=z, grid=grid, of=of[0])
            if of[1] == of[0]:
                tk = tk ** 2
            else:
                tk = tk * tr.transfer_kz(k, z=z, grid=grid, of=of[1])
            potential_to_density = (3.0 * ba.Omega0_m[..., None] * 100 ** 2 / (2.0 * (constants.c / 1e3) ** 2 * k ** 2)) ** (-2)
            curvature_to_potential = 9.0 / 25.0 * 2.0 * np.pi ** 2 / k ** 3 / ba.h[..., None] ** 3
            pdd = potential_to_density * curvature_to_potential * pm.pk_k(k)   # batch + (nk,)
            gsq = growth_factor_sq(z)                                           # batch + (nz,)
            if grid:
                gsq, pdd = gsq[..., None, :], pdd[..., None]
            return tk * gsq * pdd

        return PowerSpectrumInterpolator2D.from_callable(pk_callable=pk_callable, device=self.device, **kwargs)
