r"""Eisenstein & Hu (1998) wiggly transfer-function engine
(cosmoprimo_tpu/models/eisenstein_hu.py), batch-first.

Physics: EH98 fitting formulae (arXiv:astro-ph/9709112 eqs. 2-24) with the
HS96 z_drag variant; growth approximations from Carroll, Press & Turner
(1992). Coefficients have the batch shape; functions of k or z return
batch + k.shape (k 1D).
"""

import numpy as np
import torch

from .. import constants, utils
from ..cosmology import BaseEngine, BaseSection, DefaultBackground, register_engine
from ..interpolator import PowerSpectrumInterpolator1D, PowerSpectrumInterpolator2D
from ..ops import flatarray


def compute_eh98_coefficients(engine):
    """All EH98 transfer-function coefficients as a dict of batch tensors
    (EH98 eqs. 2-24)."""
    c = {}
    c['omega_b'] = engine['omega_b']
    c['omega_m'] = engine['omega_cdm'] + engine['omega_b']
    c['frac_b'] = c['omega_b'] / c['omega_m']
    c['theta_cmb'] = engine['T_cmb'] / 2.7

    om, ob, th = c['omega_m'], c['omega_b'], c['theta_cmb']
    # matter-radiation equality (eqs. 2-3)
    c['z_eq'] = 2.5e4 * om * th ** (-4) - 1.0
    c['k_eq'] = 0.0746 * om * th ** (-2)  # 1/Mpc

    # drag epoch: HS96 (arXiv:astro-ph/9510117, eq. E1) normalization, which
    # matches CLASS better than EH98 eq. 4 (coefficient 1345 vs 1291)
    b1 = 0.313 * om ** (-0.419) * (1 + 0.607 * om ** 0.674)
    b2 = 0.238 * om ** 0.223
    c['z_drag'] = 1345 * om ** 0.251 / (1.0 + 0.659 * om ** 0.828) * (1.0 + b1 * ob ** b2)

    # baryon-to-photon momentum ratio at drag & equality (eq. 5)
    c['r_drag'] = 31.5 * ob * th ** (-4) * (1000.0 / (1 + c['z_drag']))
    c['r_eq'] = 31.5 * ob * th ** (-4) * (1000.0 / (1 + c['z_eq']))

    # sound horizon (eq. 6), Mpc
    c['rs_drag'] = (2.0 / (3.0 * c['k_eq']) * torch.sqrt(6.0 / c['r_eq'])
                    * torch.log((torch.sqrt(1 + c['r_drag']) + torch.sqrt(c['r_drag'] + c['r_eq'])) / (1 + torch.sqrt(c['r_eq']))))

    # Silk damping scale (eq. 7), 1/Mpc
    c['k_silk'] = 1.6 * ob ** 0.52 * om ** 0.73 * (1 + (10.4 * om) ** (-0.95))

    # CDM suppression (eq. 11)
    a1 = (46.9 * om) ** 0.670 * (1 + (32.1 * om) ** (-0.532))
    a2 = (12.0 * om) ** 0.424 * (1 + (45.0 * om) ** (-0.582))
    c['alpha_c'] = a1 ** (-c['frac_b']) * a2 ** (-c['frac_b'] ** 3)

    # CDM log shift (eq. 12)
    bc1 = 0.944 / (1 + (458 * om) ** (-0.708))
    bc2 = 0.395 * om ** (-0.0266)
    c['beta_c'] = 1.0 / (1 + bc1 * ((1 - c['frac_b']) ** bc2) - 1)

    # baryon amplitude (eqs. 14-15)
    y_d = (1 + c['z_eq']) / (1 + c['z_drag'])
    G = y_d * (-6.0 * torch.sqrt(1 + y_d) + (2.0 + 3.0 * y_d)
               * torch.log((torch.sqrt(1 + y_d) + 1) / (torch.sqrt(1 + y_d) - 1)))
    c['alpha_b'] = 2.07 * c['k_eq'] * c['rs_drag'] * (1 + c['r_drag']) ** (-0.75) * G

    # baryon envelope shift (eqs. 23-24)
    c['beta_node'] = 8.41 * om ** 0.435
    c['beta_b'] = 0.5 + c['frac_b'] + (3.0 - 2.0 * c['frac_b']) * torch.sqrt((17.2 * om) ** 2 + 1)
    return c


@register_engine
class EisensteinHuEngine(BaseEngine):
    """EH98 wiggly transfer function engine (arXiv:astro-ph/9709112)."""

    name = 'eisenstein_hu'

    def __init__(self, cosmo, **extra_params):
        super().__init__(cosmo, **extra_params)
        self._coefficients = compute_eh98_coefficients(self)
        self._A_s = self._get_A_s_fid()

    def __getattr__(self, name):
        coeffs = self.__dict__.get('_coefficients', {})
        if name in coeffs:
            return coeffs[name]
        raise AttributeError(name)


class Background(DefaultBackground):
    """Background with CPT92 growth approximations (no neutrino treatment)."""

    @flatarray()
    def growth_factor(self, z, znorm=None):
        r"""Carroll, Press & Turner (1992) eq. 29 growth approximation;
        normalized to 1 at z=0, or to (1+znorm)/(1+z) in matter domination."""
        def growth(z):
            Om, Ode = self.Omega_m(z), self.Omega_de(z)
            return 1.0 / (1 + z) * 5 * Om / 2.0 / (Om ** (4.0 / 7.0) - Ode + (1.0 + Om / 2.0) * (1 + Ode / 70.0))

        growthz = growth(z)
        if znorm is not None:
            return (1.0 + znorm) * growthz
        return growthz / growth(torch.zeros_like(z))

    @flatarray()
    def growth_rate(self, z):
        r"""f ~ Omega_m(z)^gamma with the w-dependent index of
        arXiv:astro-ph/0507263."""
        wz1 = self.w0_fld + (1.0 - 0.5) * self.wa_fld
        return self.Omega_m(z) ** (0.55 + 0.05 * (1 + wz1))[..., None]


@utils.addproperty('k_pivot', 'n_s', 'alpha_s', 'beta_s')
class Primordial(BaseSection):
    """Primordial curvature power spectrum with runnings."""

    def __init__(self, engine):
        super().__init__(engine)
        self._h = engine['h']
        self._A_s = engine._A_s
        self._n_s = engine['n_s']
        self._alpha_s = engine['alpha_s']
        self._beta_s = engine['beta_s']
        self._k_pivot = engine['k_pivot'] / self._h  # h/Mpc
        self._rsigma8 = engine._rescale_sigma8()

    @property
    def A_s(self):
        return self._A_s * self._rsigma8 ** 2

    def pk_k(self, k, mode='scalar'):
        r"""Primordial curvature spectrum :math:`\mathcal{P}_\mathcal{R}(k)`
        in (Mpc/h)^3 at 1D ``k`` (h/Mpc), with runnings alpha_s, beta_s."""
        ['scalar'].index(mode)
        k_pivot = self.k_pivot[..., None]
        lnkkp = torch.log(k / k_pivot)
        return self._h[..., None] ** 3 * self.A_s[..., None] * (k / k_pivot) ** (
            self.n_s[..., None] - 1.0 + 1.0 / 2.0 * self.alpha_s[..., None] * lnkkp
            + 1.0 / 6.0 * self.beta_s[..., None] * lnkkp ** 2)

    def pk_interpolator(self, mode='scalar'):
        return PowerSpectrumInterpolator1D.from_callable(pk_callable=lambda k: self.pk_k(k, mode=mode),
                                                         device=self.device)


class Transfer(BaseSection):
    """EH98 wiggly matter transfer function (eqs. 10-24)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._h = engine['h']
        for name in ['k_eq', 'k_silk', 'rs_drag', 'beta_node', 'beta_c', 'alpha_c', 'alpha_b', 'beta_b', 'frac_b']:
            setattr(self, '_' + name, getattr(engine, name))

    def transfer_k(self, k):
        """Matter transfer function at 1D ``k`` in h/Mpc."""
        k_eq, k_silk, rs_drag, beta_node, beta_c, alpha_c, alpha_b, beta_b, frac_b = (
            getattr(self, '_' + name)[..., None] for name in
            ['k_eq', 'k_silk', 'rs_drag', 'beta_node', 'beta_c', 'alpha_c', 'alpha_b', 'beta_b', 'frac_b'])
        k = k * self._h[..., None]  # 1/Mpc
        q = k / (13.41 * k_eq)
        ks = k * rs_drag

        ln_beta = torch.log(np.e + 1.8 * beta_c * q)
        ln_nobeta = torch.log(np.e + 1.8 * q)
        C_alpha = 14.2 / alpha_c + 386.0 / (1 + 69.9 * q ** 1.08)
        C_noalpha = 14.2 + 386.0 / (1 + 69.9 * q ** 1.08)

        def T0(a, b):
            return a / (a + b * q ** 2)

        # CDM part (eqs. 17-18)
        f = 1.0 / (1.0 + (ks / 5.4) ** 4)
        T_c = f * T0(ln_beta, C_noalpha) + (1 - f) * T0(ln_beta, C_alpha)

        # baryon part (eqs. 21-22)
        s_tilde = rs_drag * (1 + (beta_node / ks) ** 3) ** (-1.0 / 3.0)
        T_b1 = T0(ln_nobeta, C_noalpha) / (1 + (ks / 5.2) ** 2)
        T_b2 = alpha_b / (1 + (beta_b / ks) ** 3) * torch.exp(-(k / k_silk) ** 1.4)
        T_b = torch.sinc(k * s_tilde / np.pi) * (T_b1 + T_b2)

        # total (eq. 16)
        return frac_b * T_b + (1 - frac_b) * T_c


class Fourier(BaseSection):
    """Linear power spectra built from transfer x primordial x growth."""

    def __init__(self, engine):
        super().__init__(engine)
        self.pm = engine.get_primordial()
        self.tr = engine.get_transfer()
        self.ba = engine.get_background()

    def pk_interpolator(self, of='delta_m', non_linear=False):
        """Linear P(k, z) interpolator for 'delta_m' / 'theta_m' (velocity
        spectra are rescaled by the growth rate)."""
        if non_linear:
            raise NotImplementedError('non-linear spectra (halofit, HMcode) are not ported yet '
                                      '(ROADMAP.md, queue 1, slice 3)')
        if isinstance(of, str):
            of = (of,)
        of = list(of)
        of = of + [of[0]] * (2 - len(of))
        ntheta = sum(o.startswith('theta_') for o in of)
        ba, pm, tr = self.ba, self.pm, self.tr

        def growth_factor_sq(z):
            growth = ba.growth_factor(z, znorm=0.0) ** 2
            return growth * ba.growth_rate(z) ** ntheta if ntheta else growth

        def pk_callable(k):
            # curvature perturbation -> potential -> density contrast
            potential_to_density = (3.0 * ba.Omega0_m[..., None] * 100 ** 2 / (2.0 * (constants.c / 1e3) ** 2 * k ** 2)) ** (-2)
            curvature_to_potential = 9.0 / 25.0 * 2.0 * np.pi ** 2 / k ** 3 / ba.h[..., None] ** 3
            return tr.transfer_k(k) ** 2 * potential_to_density * curvature_to_potential * pm.pk_k(k)

        return PowerSpectrumInterpolator2D.from_callable(pk_callable=pk_callable, growth_factor_sq=growth_factor_sq,
                                                         device=self.device)
