"""CAMB-family Boltzmann engines ('camb' and published variants) with six
sections, CAMB having no Perturbations section
(cosmoprimo_tpu/models/camb.py).

The host-import design of :mod:`.classy`: CAMB runs on the host, one
cosmology a call, through a task graph with ready flags; its scalars are
read directly, its z- and (k, z)-dependent quantities imported as tables
that become float64 tensors on the cosmology's device, served through the
port's interpolators (sigma8 and ``to_xi`` reach the FFTLog kernel).
Functions of z evaluate the host at the requested redshifts and return
tensors on the device.

Beyond renaming:
- Fourier.table reconstructs ``theta_cb`` as the Omega-weighted sum of the
  Newtonian cdm and baryon velocities and undoes the Weyl ~ k^2 (phi+psi)/2
  scaling (factor 2, k^-2), converting to hubble units by hand (CAMB's own
  conversion is wrong for Weyl);
- Thermodynamics gives CAMB's zstar as ``z_star_noreion`` and derives
  CLASS's ``z_star`` (total optical depth = 1) from the opacity;
- Harmonic uses the lmax-aware getters with the muK^2 normalization
  removed;
- the growth ODE runs on the closed-form twin of the background, as the
  JAX package's traced ODE does.
"""

import numpy as np
import torch

from .. import constants, utils
from ..cosmology import (BaseEngine, BaseSection, CosmologyInputError, DefaultBackground, register_engine,
                         register_section)
from ..interpolator import PowerSpectrumInterpolator1D, PowerSpectrumInterpolator2D
from ..ops import Interpolator1D, flatarray
from .boltzmann import (background_z_grid, build_task_dependency, camb_nu_degeneracies, device_table, host_params,
                        translate_camb_params)
from .native import cl_table


def _host(value):
    """A tensor, list or number as a float64 numpy array on the host."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().astype(np.float64)
    return np.asarray(value, dtype=np.float64)


@register_engine
class CambEngine(BaseEngine):
    """Engine wrapping the CAMB Boltzmann code (host-side); raises
    CosmologyInputError when camb is absent. Results are computed through a
    task graph (background -> thermodynamics -> transfer -> fourier /
    harmonic) with ready flags."""

    name = 'camb'
    _camb_module = 'camb'

    def __init__(self, cosmo, **extra_params):
        super().__init__(cosmo, **extra_params)
        params = host_params(self)
        self._set_camb()
        camb = self.camb
        base, post = translate_camb_params(
            params, extra_params=self._extra_params, A_s_fid=float(self._get_A_s_fid()),
            has_fld=bool(self._has_fld), use_ppf=params.get('use_ppf', True), N_eff=float(self['N_eff']))
        self._camb_params = camb.CAMBparams()
        try:
            if post['has_fld']:
                base.setdefault('dark_energy_model',
                                camb.dark_energy.DarkEnergyPPF
                                if post['use_ppf'] and post['de_params'].get('cs2', 1.0) == 1.0
                                else camb.dark_energy.DarkEnergyFluid)
                base.update(post['de_params'])
            non_linear = post['non_linear']
            if non_linear:
                self._camb_params.NonLinear = camb.model.NonLinear_both
                self._camb_params.NonLinearModel = camb.nonlinear.Halofit()
                halofit_version = {'mead': 'mead', 'hmcode': 'mead', 'halofit': 'original'}.get(non_linear, non_linear)
                if base.get('Want_CMB_lensing'):
                    base.setdefault('lens_potential_accuracy', 1)
            camb.set_params(self._camb_params, **base)
            self._camb_params.Reion.delta_redshift = params['reionization_width']
            if non_linear:
                self._camb_params.NonLinearModel.set_params(halofit_version=halofit_version)
            self._camb_params.share_delta_neff = False
            self._camb_params.omnuh2 = float(np.sum(_host(self['omega_ncdm'])))
            self._camb_params.num_nu_massless = params['N_ur']
            self._camb_params.num_nu_massive = self['N_ncdm']
            self._camb_params.nu_mass_eigenstates = self['N_ncdm']
            g, f = camb_nu_degeneracies(params['T_ncdm_over_cmb'], params['m_ncdm'])
            self._camb_params.nu_mass_numbers = np.ones(self['N_ncdm'], dtype=np.int32)
            self._camb_params.nu_mass_fractions = f
            self._camb_params.nu_mass_degeneracies = g
            self._camb_params.WantScalars = 's' in self['modes']
            self._camb_params.WantVectors = 'v' in self['modes']
            self._camb_params.WantTensors = 't' in self['modes']
        except (camb.baseconfig.CAMBParamRangeError, camb.baseconfig.CAMBValueError,
                camb.baseconfig.CAMBError, camb.baseconfig.CAMBUnknownArgumentError) as exc:
            raise CosmologyInputError from exc
        self.ready = _Ready()

    def _set_camb(self):
        try:
            import importlib
            self.camb = importlib.import_module(self._camb_module)
        except ImportError as exc:
            raise CosmologyInputError(
                f'{self._camb_module} is required for engine {self.name!r}; install it or use an '
                'analytic/emulated engine (on-device path).') from exc

    def compute(self, tasks):
        tasks = build_task_dependency(tasks)
        camb = self.camb
        try:
            if 'background' in tasks and not self.ready.ba:
                self.ba = camb.get_background(self._camb_params, no_thermo=True)
                self.ready.ba = True
            if 'thermodynamics' in tasks and not self.ready.th:
                self.ba = self.th = camb.get_background(self._camb_params, no_thermo=False)
                self.ready.ba = self.ready.th = True
            if 'transfer' in tasks and not self.ready.tr:
                self.tr = camb.get_transfer_functions(self._camb_params)
                self.ready.tr = True
            if 'harmonic' in tasks and not self.ready.hr:
                # requesting harmonic invalidates the fourier product, so that
                # calc_power_spectra runs again with the CMB outputs enabled
                self.ready.hr = True
                self.ready.fo = False
            if 'lensing' in tasks and not self.ready.le:
                self._camb_params.DoLensing = True
                self._camb_params.Want_CMB_lensing = True
                self.ready.le = True
                self.tr = camb.CAMBdata()
                self.tr.calc_power_spectra(self._camb_params)
                self.le = self.hr = self.fo = self.tr
                self.ready.fo = True
            if 'fourier' in tasks and not self.ready.fo:
                self.tr.calc_power_spectra(self._camb_params)
                self.fo = self.hr = self.le = self.tr
                self.ready.fo = True
        except camb.baseconfig.CAMBError as exc:
            raise CosmologyInputError from exc

    def _rescale_sigma8(self):
        if self._rsigma8 is not None:
            return self._rsigma8
        self._rsigma8 = 1.0
        if 'sigma8' in self._params:
            self._sections.pop('fourier', None)
            self._rsigma8 = self._params['sigma8'] / self.get_section('fourier').sigma8_m
            if self._camb_params.NonLinear != self.camb.model.NonLinear_none:
                # the non-linear spectrum cannot be rescaled: run again with As scaled
                self._camb_params.InitPower.As *= float(self._rsigma8) ** 2
                self.tr.calc_power_spectra(self._camb_params)
                self._sections.pop('fourier', None)
                self._rsigma8 = 1.0
                self._rsigma8 = self._params['sigma8'] / self.get_section('fourier').sigma8_m
            self._sections.pop('fourier', None)
        return self._rsigma8


class _Ready(object):
    def __init__(self):
        self.ba = self.th = self.tr = self.le = self.hr = self.fo = False


# ----------------------------------------------------------------------------
# Variant engines (full published parameter surfaces)
# ----------------------------------------------------------------------------

@register_engine
class ISiTGREngine(CambEngine):
    """ISiTGR modified-gravity CAMB variant: mu/Sigma, (E11, E22), binned and
    functional parameterizations."""

    name = 'isitgr'
    _camb_module = 'isitgr'
    _default_cosmological_parameters = dict(
        E11=0.0, E22=0.0, c1=1.0, c2=1.0, lambda_k=0.0, mu0=0.0, Sigma0=0.0,
        mu1=1.0, mu2=1.0, mu3=1.0, mu4=1.0,
        eta1=1.0, eta2=1.0, eta3=1.0, eta4=1.0,
        Sigma1=1.0, Sigma2=1.0, Sigma3=1.0, Sigma4=1.0,
        z_div=1.0, z_TGR=2.0, z_tw=0.05,
        k_c=0.01, k_tw=0.001, k_TGR=0.001, k_S=0.5,
        beta_1=1.0, lambda_1=0.0, exp_s=1.0, beta_2=1.0, lambda_2=0.0,
        gamma_0=0.54545, gamma_a=0.0, t_k=10.0, d_s=2.0, r_c=0.0,
        fR0_HS=0.0, n_HS=1.0)
    _default_calculation_parameters = dict(
        MG_parameterization='muSigma', use_growth_index=None, damping_yukawa=False,
        use_BZ_form=False, use_HS_form=False, redshift_bins=None, scale_bins=None,
        use_nDGP=False)


@register_engine
class MGCambEngine(CambEngine):
    """MGCAMB modified-gravity variant: the BZ/Planck/mu-Sigma/QR families
    plus the binned mu/Sigma grid."""

    name = 'mgcamb'
    _camb_module = 'mgcamb'
    _default_cosmological_parameters = dict(
        GRtrans=0.001, B1=1.333, lambda1_2=1000.0, B2=0.5, lambda2_2=1000.0, ss=4.0,
        E11=1.0, E22=1.0, ga=0.5, nn=2.0, mu0=0.0, sigma0=0.0,
        MGQfix=1.0, MGRfix=1.0, Qnot=1.0, Rnot=1.0, sss=0.0,
        Linder_gamma=0.545, B0=0.001, beta_star=1.0, a_star=0.5, xi_star=0.001,
        beta0=0.0, xi0=0.0001, DilS=0.24, DilR=1.0, F_R0=0.0001, FRn=1.0,
        w0DE=-1.0, waDE=0.0,
        **{f'MGCAMB_Mu_idx_{i}': 1.0 for i in range(1, 12)},
        **{f'MGCAMB_Sigma_idx_{i}': 1.0 for i in range(1, 12)},
        **{f'Funcofw_{i}': 0.7 for i in range(1, 12)})
    _default_calculation_parameters = dict(
        MG_wrapped=True, MG_flag=0, pure_MG_flag=1, alt_MG_flag=1, QSA_flag=1,
        CDM_flag=1, muSigma_flag=1, DE_model=0, MGDE_pert=False,
        mugamma_par=1, musigma_par=1, QR_par=1)


@register_engine
class ISiTIDEEngine(CambEngine):
    """Interacting-dark-energy CAMB variant; the growth rate and factor come
    from the modified fortran."""

    name = 'isitide'
    _camb_module = 'isitide'
    _default_cosmological_parameters = dict(w=-1.0, wa=0.0)
    _default_calculation_parameters = dict(dark_energy_model='IDEModel1')


@register_engine
class HEFTCambEngine(CambEngine):
    """H-EFTCAMB (EFT of dark energy, RPH alpha-basis) variant: kineticity,
    braiding, Planck-mass-run and tensor alphas proportional to
    Omega_DE(a), plus the EFTCAMB stability and model-selection switches."""

    name = 'heftcamb'
    _camb_module = 'heftcamb'
    _default_cosmological_parameters = dict(
        RPHkineticity_ODE0=1.0, RPHbraiding_ODE0=0.0, RPHalphaM_ODE0=0.0, RPHtensor_ODE0=0.0)
    _default_calculation_parameters = dict(
        dark_energy_model='EFTCAMB', EFTflag=2, AltParEFTmodel=1,
        EFTCAMB_back_turn_on=1e-8, EFTCAMB_turn_on_time=1e-8,
        EFTCAMB_skip_stability=True, feedback_level=0,
        EFT_ghost_math_stability=False, EFT_mass_math_stability=False,
        EFT_ghost_stability=True, EFT_gradient_stability=True,
        EFT_mass_stability=False, EFT_additional_priors=False,
        RPHintegratefromtoday=False, RPHusealphaM=True,
        RPHkineticitymodel=0, RPHkineticitymodel_ODE=2,
        RPHbraidingmodel=0, RPHbraidingmodel_ODE=2,
        RPHalphaMmodel=0, RPHalphaMmodel_ODE=2,
        RPHtensormodel=0, RPHtensormodel_ODE=2)
    # wrapper-only options that must never reach camb.set_params
    _wrapper_private_keys = ('eftcamb_params', 'eftcamb_print_header', 'heftcamb_debug',
                             'RPH_massP0', 'RPH_braiding0', 'RPH_kinetic0')

    def __init__(self, cosmo, **extra_params):
        # convenience aliases: a full eftcamb_params dict, and RPH_* scalars
        # overriding the alpha-basis
        eftcamb_params = extra_params.pop('eftcamb_params', None)
        if eftcamb_params is not None:
            for key, value in dict(eftcamb_params).items():
                extra_params.setdefault(key, value)
        for alias, target in [('RPH_massP0', 'RPHalphaM_ODE0'),
                              ('RPH_braiding0', 'RPHbraiding_ODE0'),
                              ('RPH_kinetic0', 'RPHkineticity_ODE0')]:
            value = extra_params.pop(alias, None)
            if value is not None:
                extra_params[target] = float(value)
        for key in self._wrapper_private_keys:
            extra_params.pop(key, None)
        super().__init__(cosmo, **extra_params)

    def _set_camb(self):
        try:
            import camb as heftcamb
        except ImportError as exc:
            raise CosmologyInputError(
                'an EFTCAMB-enabled camb build is required for engine heftcamb') from exc
        try:
            has_eftcamb = hasattr(heftcamb.CAMBparams(), 'EFTCAMB')
        except Exception:
            has_eftcamb = False
        if not has_eftcamb:
            raise CosmologyInputError(
                "imported 'camb', but it is not an HEFTCAMB build: CAMBparams() has no EFTCAMB "
                'attribute; put the HEFTCAMB build directory first on PYTHONPATH')
        self.camb = heftcamb


# ----------------------------------------------------------------------------
# Sections
# ----------------------------------------------------------------------------

@register_section
class Background(DefaultBackground):
    """Background served from CAMB's host tables: Omega_x(z) and rho_x(z)
    from get_Omega / get_background_densities, E(z), time and distances from
    the background getters; the comoving distance imported on a dense grid
    and splined on the device."""

    # CAMB species names for each quantity
    _CAMB_SPECIES = {'k': 'K', 'cdm': 'cdm', 'b': 'baryon', 'g': 'photon',
                     'ur': 'neutrino', 'ncdm_tot': 'nu', 'de': 'de'}

    def __init__(self, engine):
        super().__init__(engine)
        engine.compute('background')
        # CAMB background densities are 8 pi G a^4 rho in Mpc units; this
        # converts to comoving 1e10 Msun/h / (Mpc/h)^3
        self._RH0_ = (constants.rho_crit_over_Msunph_per_Mpcph3 * constants.c ** 2
                      / (100.0 * float(self.h) * 1e3) ** 2 / 3.0)

    @property
    def _ba(self):
        return self._engine.ba

    @property
    def age(self):
        r"""Current age of the Universe in Gyr, from CAMB's derived params."""
        self._engine.compute('thermodynamics')
        return self._engine.th.get_derived_params()['age']

    def _omega_of(self, species):
        def fn(z):
            return np.asarray(self._ba.get_Omega(self._CAMB_SPECIES[species], z=z))
        return fn

    def _rho_of(self, species):
        var = self._CAMB_SPECIES[species]

        def fn(z):
            dens = self._ba.get_background_densities(1.0 / (1.0 + np.asarray(z)), vars=[var])[var]
            return np.asarray(dens) * self._RH0_ * (1.0 + np.asarray(z))
        return fn

    @property
    def _closed_form(self):
        """The closed-form twin (DefaultBackground over the same parameters),
        on which the growth ODE runs; for standard CAMB the host densities
        equal its closed forms."""
        if '_closed_twin' not in self.__dict__:
            self.__dict__['_closed_twin'] = DefaultBackground(self._engine)
        return self.__dict__['_closed_twin']

    def _host_eval(self, fn, z):
        """The host callable ``fn`` at the redshifts ``z`` (a tensor), as a
        tensor on the device."""
        return device_table(fn(_host(z)), self.device)

    def _growth_tables(self, mass='m'):
        return self._closed_form._growth_tables(mass=mass)

    @flatarray()
    def Omega_k(self, z):
        return self._host_eval(self._omega_of('k'), z)

    @flatarray()
    def Omega_cdm(self, z):
        return self._host_eval(self._omega_of('cdm'), z)

    @flatarray()
    def Omega_b(self, z):
        return self._host_eval(self._omega_of('b'), z)

    @flatarray()
    def Omega_g(self, z):
        return self._host_eval(self._omega_of('g'), z)

    @flatarray()
    def Omega_ur(self, z):
        return self._host_eval(self._omega_of('ur'), z)

    @flatarray()
    def Omega_ncdm_tot(self, z):
        return self._host_eval(self._omega_of('ncdm_tot'), z)

    @flatarray()
    def Omega_de(self, z):
        return self._host_eval(self._omega_of('de'), z)

    @flatarray()
    def rho_k(self, z):
        return self._host_eval(self._rho_of('k'), z)

    @flatarray()
    def rho_cdm(self, z):
        return self._host_eval(self._rho_of('cdm'), z)

    @flatarray()
    def rho_b(self, z):
        return self._host_eval(self._rho_of('b'), z)

    @flatarray()
    def rho_g(self, z):
        return self._host_eval(self._rho_of('g'), z)

    @flatarray()
    def rho_ur(self, z):
        return self._host_eval(self._rho_of('ur'), z)

    @flatarray()
    def rho_ncdm_tot(self, z):
        return self._host_eval(self._rho_of('ncdm_tot'), z)

    @flatarray()
    def rho_de(self, z):
        return self._host_eval(self._rho_of('de'), z)

    def rho_tot(self, z):
        m = self.rho_cdm(z) + self.rho_b(z) + self.rho_ncdm_tot(z)
        r = self.rho_g(z) + self.rho_ur(z)
        return m + r + self.rho_de(z)

    @flatarray()
    def efunc(self, z):
        return self.hubble_function(z) / (100.0 * self.h)

    @flatarray()
    def hubble_function(self, z):
        r"""H(z) in km/s/Mpc from CAMB."""
        return self._host_eval(lambda zz: self._ba.hubble_parameter(zz), z)

    @flatarray()
    def time(self, z):
        r"""Proper time in Gyr."""
        return self._host_eval(lambda zz: np.vectorize(self._ba.physical_time)(zz) if zz.size else np.zeros_like(zz), z)

    def _chi_table(self):
        if 'comoving_radial_distance' not in self._cache:
            zc = background_z_grid()
            chi = np.asarray(self._ba.comoving_radial_distance(zc)) * float(self.h)
            self._cache['comoving_radial_distance'] = Interpolator1D(zc, device_table(chi, self.device),
                                                                     assume_sorted=True)
        return self._cache['comoving_radial_distance']

    @flatarray()
    def comoving_radial_distance(self, z):
        r"""Comoving radial distance in Mpc/h (CAMB gives Mpc)."""
        return self._chi_table()(z)

    @flatarray()
    def luminosity_distance(self, z):
        r"""Luminosity distance in Mpc/h."""
        return self._host_eval(lambda zz: np.asarray(self._ba.luminosity_distance(zz)) * float(self.h), z)


@register_section
@utils.addproperty('rs_drag', 'z_drag', 'tau_reio', 'z_reio', 'YHe')
class Thermodynamics(BaseSection):
    """Thermodynamics from CAMB's derived params, plus CLASS's z_star (the
    total optical depth, reionization included, crossing 1) from the
    opacity."""

    def __init__(self, engine):
        super().__init__(engine)
        engine.compute('thermodynamics')
        self._h = float(engine['h'])
        derived = engine.th.get_derived_params()
        self._derived = derived
        self._rs_drag = derived['rdrag'] * self._h
        self._z_drag = derived['zdrag']
        # Reion.optical_depth is only set when the cosmology is parameterized
        # by tau; under z_reio it stays at the field default
        tau = engine._camb_params.Reion.optical_depth
        self._tau_reio = tau if tau else engine.get('tau_reio', None)
        self._z_reio = engine._camb_params.get_zrei() if hasattr(engine._camb_params, 'get_zrei') else None
        self._YHe = getattr(engine._camb_params, 'YHe', None)

    @property
    def z_star_noreion(self):
        r"""CAMB's zstar: the optical depth excluding reionization = 1."""
        return self._derived['zstar']

    @property
    def rs_star_noreion(self):
        r"""Comoving sound horizon at z_star_noreion, in Mpc/h."""
        return self._engine.th.sound_horizon(self.z_star_noreion) * self._h

    @property
    def z_star(self):
        r"""Redshift where the total optical depth (reionization included)
        crosses one, CLASS's convention, from the opacity."""
        if not hasattr(self, '_z_star'):
            z_arr = np.linspace(0.0, 1300.0, 4000)
            ev = self._engine.th.get_background_redshift_evolution(z_arr, vars=['opacity'])
            chi = np.asarray(self._engine.ba.comoving_radial_distance(z_arr))
            dchi_dz = np.abs(np.gradient(chi, z_arr))
            dtau = np.asarray(ev['opacity']) * dchi_dz
            tau = np.concatenate([[0.0], np.cumsum(0.5 * (dtau[1:] + dtau[:-1]) * np.diff(z_arr))])
            self._z_star = float(np.interp(1.0, tau, z_arr))
        return self._z_star

    @property
    def rs_star(self):
        r"""Comoving sound horizon at z_star, in Mpc/h."""
        return self._engine.th.sound_horizon(self.z_star) * self._h

    @flatarray()
    def rs_z(self, z):
        r"""Comoving sound horizon r_s(z), in Mpc/h."""
        return device_table(np.asarray(self._engine.th.sound_horizon(_host(z))) * self._h, self.device)

    @property
    def theta_cosmomc(self):
        return self._engine.th.cosmomc_theta()

    @property
    def theta_star(self):
        da = np.asarray(self._engine.ba.angular_diameter_distance(self.z_star)) * self._h
        return self.rs_star / da / (1.0 + self.z_star)

    @property
    def theta_star_noreion(self):
        da = np.asarray(self._engine.ba.angular_diameter_distance(self.z_star_noreion)) * self._h
        return self.rs_star_noreion / da / (1.0 + self.z_star_noreion)


@register_section
@utils.addproperty('k_pivot', 'n_s', 'alpha_s', 'beta_s')
class Primordial(BaseSection):
    """Primordial parameters read back from the CAMB InitPower block; pk_k
    uses CAMB's own primordial_power where the host has it."""

    def __init__(self, engine):
        super().__init__(engine)
        pm = engine._camb_params.InitPower
        self._h = float(engine['h'])
        self._n_s = pm.ns
        self._alpha_s = pm.nrun
        self._beta_s = pm.nrunrun
        self._k_pivot = pm.pivot_scalar / self._h
        self._A_s_raw = pm.As
        self._rsigma8 = engine._rescale_sigma8()

    @property
    def A_s(self):
        return self._A_s_raw * self._rsigma8 ** 2

    @property
    def ln_1e10_A_s(self):
        return torch.log(1e10 * torch.as_tensor(self.A_s, dtype=torch.float64, device=self.device))

    def pk_k(self, k, mode='scalar'):
        r"""Primordial spectrum in (Mpc/h)^3, from CAMB's primordial_power
        when the host has it, else the analytic form."""
        power = getattr(self._engine._camb_params, 'primordial_power', None)
        if power is not None:
            index = ['scalar', 'vector', 'tensor'].index(mode)
            return self._h ** 3 * device_table(power(_host(k) * self._h, index), self.device) * self._rsigma8 ** 2
        k = torch.as_tensor(k, dtype=torch.float64, device=self.device)
        lnkkp = torch.log(k / self.k_pivot)
        return self._h ** 3 * self.A_s * (k / self.k_pivot) ** (
            self.n_s - 1.0 + 0.5 * self.alpha_s * lnkkp + self.beta_s * lnkkp ** 2 / 6.0)

    def pk_interpolator(self, mode='scalar'):
        return PowerSpectrumInterpolator1D.from_callable(pk_callable=lambda k: self.pk_k(k, mode=mode),
                                                         device=self.device)


@register_section
class Transfer(BaseSection):
    """Matter transfer functions as a (k, z) structured array."""

    def __init__(self, engine):
        super().__init__(engine)
        engine.compute('transfer')

    def table(self):
        r"""Structured array of CAMB matter transfer functions, shape
        (k.size, z.size); the first field is 'k' in h/Mpc."""
        tr = self._engine.tr
        data = tr.get_matter_transfer_data()
        transfer_names = list(self._engine.camb.model.transfer_names)
        conversion = {'k/h': 'k'}
        dtype = [('k', np.float64), ('z', np.float64)] + [
            (name, np.float64) for name in transfer_names if name not in ['k/h']]
        out = np.empty(data.transfer_data.shape[1:], dtype=dtype)
        out['z'][...] = tr.transfer_redshifts
        for name in transfer_names:
            out[conversion.get(name, name)] = data.transfer_data[transfer_names.index(name)]
        return out


@register_section
class Harmonic(BaseSection):
    """CMB Cls from CAMB with the muK^2 normalization removed (raw Cl), on
    the cosmology's device."""

    def __init__(self, engine):
        super().__init__(engine)
        engine.compute(['harmonic', 'lensing'] if engine['lensing'] else 'harmonic')
        self._rsigma8 = engine._rescale_sigma8()
        self.ellmax_cl = engine['ellmax_cl']

    def _to_cl_table(self, arr, names):
        scale = self._rsigma8 ** 2
        table = {name: device_table(arr[:, i], self.device) * scale for i, name in enumerate(names)}
        table['ell'] = np.arange(arr.shape[0])
        return cl_table(table)

    def _resolve_ellmax(self, ellmax):
        if ellmax < 0:
            ellmax = self.ellmax_cl + 1 + ellmax
        return ellmax

    def unlensed_cl(self, ellmax=-1):
        r"""Unlensed C_ell ['tt', 'ee', 'bb', 'te'], unitless."""
        ellmax = self._resolve_ellmax(ellmax)
        arr = self._engine.hr.get_unlensed_total_cls(lmax=ellmax, CMB_unit=None, raw_cl=True)
        return self._to_cl_table(arr, ['tt', 'ee', 'bb', 'te'])

    def lensed_cl(self, ellmax=-1):
        r"""Lensed C_ell ['tt', 'ee', 'bb', 'te'], unitless."""
        if not self._engine._camb_params.DoLensing:
            raise CosmologyInputError('you asked for lensed cl, but lensing was not calculated: set lensing = True')
        ellmax = self._resolve_ellmax(ellmax)
        arr = self._engine.hr.get_total_cls(lmax=ellmax, CMB_unit=None, raw_cl=True)
        return self._to_cl_table(arr, ['tt', 'ee', 'bb', 'te'])

    def lens_potential_cl(self, ellmax=-1):
        r"""Lensing-potential C_ell ['pp', 'tp', 'ep'], unitless."""
        if not self._engine._camb_params.DoLensing:
            raise CosmologyInputError('you asked for potential cl, but lensing was not calculated: set lensing = True')
        ellmax = self._resolve_ellmax(ellmax)
        arr = self._engine.hr.get_lens_potential_cls(lmax=ellmax, CMB_unit=None, raw_cl=True)
        return self._to_cl_table(arr, ['pp', 'tp', 'ep'])


# CAMB transfer variable names for each perturbed quantity
_CAMB_OF_VARS = {'delta_m': 'delta_tot', 'delta_cb': 'delta_nonu',
                 'theta_cdm': 'v_newtonian_cdm', 'theta_b': 'v_newtonian_baryon',
                 'phi_plus_psi': 'Weyl'}


def _make_of_tuple(of, size=2):
    if isinstance(of, str):
        of = (of,)
    of = list(of)
    return tuple(of + [of[0]] * (size - len(of)))


@register_section
class Fourier(BaseSection):
    """Power spectra as (k, z) tables, with the theta_cb reconstruction and
    the Weyl unscaling, served on the device."""

    def __init__(self, engine):
        super().__init__(engine)
        engine.compute('fourier')
        self._h = float(engine['h'])
        self._rsigma8 = engine._rescale_sigma8()

    def _checkz(self, z):
        """With a single computed redshift, interpolation in z is impossible:
        raise unless the request matches it."""
        redshifts = self._engine.fo.transfer_redshifts
        if len(redshifts) == 1 and not np.allclose(_host(z), redshifts[0]):
            raise CosmologyInputError(
                f'power spectrum computed for a single redshift z = {redshifts[0]:.2g}, '
                f'cannot interpolate to {_host(z)}')
        return len(redshifts)

    def table(self, non_linear=False, of='delta_m'):
        r"""(k [h/Mpc], z, pk [(Mpc/h)^3]) of shape (len(k), len(z)), numpy.

        ``of='theta_cb'`` (in either slot) is the Omega-weighted sum of the
        Newtonian cdm and baryon velocities; ``of='phi_plus_psi'`` undoes
        CAMB's Weyl ~ k^2 (phi+psi)/2 convention (factor 2, k^-2). The
        hubble units are converted by hand (CAMB's own conversion is wrong
        for Weyl)."""
        of = list(_make_of_tuple(of))
        engine = self._engine

        kpow, factor = 0, float(self._rsigma8) ** 2
        for iof, of_ in enumerate(of):
            if of_ == 'theta_cb':
                Omega_cdm = float(engine['Omega_cdm'])
                Omega_b = float(engine['Omega_b'])
                Omega_tot = Omega_cdm + Omega_b
                w_cdm, w_b = Omega_cdm / Omega_tot, Omega_b / Omega_tot
                tmpof = of.copy()
                tmpof[iof] = 'theta_cdm'
                pka_cdm = self.table(non_linear=non_linear, of=tuple(tmpof))[-1]
                tmpof[iof] = 'theta_b'
                ka, za, pka_b = self.table(non_linear=non_linear, of=tuple(tmpof))
                return ka, za, w_cdm * pka_cdm + w_b * pka_b
            if of_ == 'phi_plus_psi':
                factor *= 2.0
                kpow -= 2

        var1, var2 = [_CAMB_OF_VARS.get(of_, of_) for of_ in of]
        if non_linear and engine._camb_params.NonLinear == engine.camb.model.NonLinear_none:
            raise CosmologyInputError(
                'you asked for non-linear P(k, z), but it has not been calculated: set non_linear')
        ka, za, pka = engine.fo.get_linear_matter_power_spectrum(
            var1=var1, var2=var2, hubble_units=False, k_hunit=False,
            have_power_spectra=True, nonlinear=non_linear)
        pka = np.asarray(pka).T
        ka = np.asarray(ka)
        pka = pka * ka[:, None] ** kpow * factor
        h = self._h
        return ka / h, np.asarray(za), pka * h ** 3

    def pk_interpolator(self, non_linear=False, of='delta_m', **kwargs):
        k, z, pk = self.table(non_linear=non_linear, of=of)
        # abs for the phi_plus_psi crosses
        return PowerSpectrumInterpolator2D(k, z, device_table(np.abs(pk), self.device), **kwargs)

    def pk_kz(self, k, z, non_linear=False, of='delta_m'):
        self._checkz(z)
        return self.pk_interpolator(non_linear=non_linear, of=of)(k, z)

    def sigma_rz(self, r, z, of='delta_m', **kwargs):
        return self.pk_interpolator(of=of, **kwargs).sigma_rz(r, z)

    def sigma8_z(self, z, of='delta_m'):
        return self.sigma_rz(8.0, z, of=of)

    @property
    def sigma8_m(self):
        r"""sigma8 today from CAMB's own integral."""
        return self._engine.fo.get_sigma8()[-1] * self._rsigma8


class ISiTIDEBackground(Background):
    """IDE growth rates from the modified fortran. The host growth is
    D(0) = 1-normalized; ``znorm`` recovers the matter-era raw convention
    from the host value at z = 100. ``mass='cb'`` falls back to the internal
    ODE."""

    @flatarray()
    def growth_rate(self, z, mass='m'):
        if mass != 'm':
            return DefaultBackground.growth_rate.__wrapped__(self, z, mass=mass)
        return self._host_eval(lambda zz: np.asarray(self._ba.get_fQ_growth_rate(z=zz)), z)

    @flatarray()
    def growth_factor(self, z, mass='m', znorm=None):
        if mass != 'm':
            return DefaultBackground.growth_factor.__wrapped__(self, z, mass=mass, znorm=znorm)

        def host(zz):
            return np.asarray(self._ba.get_growth_factor(z=zz))

        out = self._host_eval(host, z)
        if znorm is not None:
            zm = 100.0
            dm = self._host_eval(host, np.array([zm]))[0]
            return (1.0 + znorm) * out / (dm * (1.0 + zm))
        return out


ISiTIDEEngine._section_overrides = {'background': ISiTIDEBackground}
