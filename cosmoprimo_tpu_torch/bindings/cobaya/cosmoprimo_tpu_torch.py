"""cobaya theory over the port's Cosmology (cosmoprimo_tpu/bindings/cobaya/
cosmoprimo_tpu.py): a BoltzmannBase subclass, :class:`CosmoprimoTPUTorch`,
with one Collector per requirement and pooled redshifts, serving Hubble,
distances, Pk_grid, sigma8, fsigma8 and Cl requirements from the engine's
sections.

The cosmology computes on the CUDA card unless ``device`` says otherwise
(e.g. ``device: cpu``); cobaya gets numpy arrays back. Requires ``cobaya``
for live runs; the collector machinery is cobaya-free, so it is testable
with a stub. The engine defaults to 'eisenstein_hu'; ``engine: 'class'`` or
'camb' runs the host Boltzmann wrappers, one cosmology a call.
"""

from copy import deepcopy
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

try:
    from cobaya.theories.cosmo import BoltzmannBase
    from cobaya.log import LoggedError
    HAS_COBAYA = True
except ImportError:
    HAS_COBAYA = False

    class BoltzmannBase(object):
        """Placeholder when cobaya is unavailable."""

    class LoggedError(RuntimeError):
        """Placeholder when cobaya is unavailable."""

        def __init__(self, log, msg, *args):
            super().__init__(msg % args if args else msg)


class _ZPool1D(object):
    """Pool of redshifts shared by all likelihoods requesting a quantity:
    accumulates sorted unique values (as cobaya.tools.Pool1D)."""

    d = 1

    def __init__(self, values):
        self.values = np.atleast_1d(np.unique(np.asarray(values, dtype=np.float64)))

    def update(self, values):
        self.values = np.unique(np.concatenate(
            [self.values, np.atleast_1d(np.asarray(values, dtype=np.float64))]))

    def find_indices(self, values, rtol=1e-10):
        """Indices of ``values`` inside the pool; loud error when a value
        was never registered (silent nearest-neighbor lookup would bias a
        likelihood with no warning)."""
        values = np.atleast_1d(np.asarray(values, dtype=np.float64))
        idx = np.clip(np.searchsorted(self.values, values), 0, len(self.values) - 1)
        left = np.clip(idx - 1, 0, len(self.values) - 1)
        use_left = np.abs(self.values[left] - values) < np.abs(self.values[idx] - values)
        idx = np.where(use_left, left, idx)
        matched = np.isclose(self.values[idx], values, rtol=rtol, atol=1e-12)
        if not matched.all():
            missing = values[~matched]
            raise ValueError(f'redshift(s) {missing} were not declared in must_provide '
                             f'(pool: {self.values})')
        return idx


class _ZPool2D(object):
    """Pool of (z1, z2) pairs (as cobaya.tools.Pool2D)."""

    d = 2

    def __init__(self, values):
        self.values = np.unique(np.atleast_2d(np.asarray(values, dtype=np.float64)), axis=0)

    def update(self, values):
        self.values = np.unique(np.concatenate(
            [self.values, np.atleast_2d(np.asarray(values, dtype=np.float64))], axis=0), axis=0)


class Collector(NamedTuple):
    """What to evaluate for one requirement: section + method + frozen args,
    with the z-pool tracked so later likelihoods can extend it."""

    section: str
    method: Optional[str] = None
    args: Sequence = ()
    args_names: Sequence = ()
    kwargs: dict = {}
    z_pool: Optional[object] = None
    post: Optional[Callable] = None


# cobaya / CAMB variable names -> this framework's perturbed quantities
OF_CONVERSIONS = {'delta_tot': 'delta_m', 'delta_nonu': 'delta_cb',
                  'v_newtonian_cdm': 'theta_cdm', 'v_newtonian_baryon': 'theta_b',
                  'Weyl': 'phi_plus_psi'}


def _np(value):
    """A tensor (on any device) or array as a numpy array on the host."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _get_from_cosmo(cosmo, name):
    """Translate a cobaya parameter name to a cosmology value."""
    aliases = {'omegam': 'Omega_m', 'omegab': 'Omega_b', 'omegac': 'Omega_cdm', 'omk': 'Omega_k',
               'sigma8': 'sigma8', 'ns': 'n_s', 'As': 'A_s', 'tau': 'tau_reio',
               'rdrag': 'rs_drag', 'zdrag': 'z_drag', 'thetastar': 'theta_cosmomc',
               'H0': 'H0', 'mnu': 'm_ncdm_tot', 'nnu': 'N_eff'}
    name = aliases.get(name, name)
    if name in ('rs_drag', 'z_drag'):
        return float(_np(getattr(cosmo.get_thermodynamics(), name)))
    return float(_np(cosmo[name]))


class CosmoprimoTPUTorch(BoltzmannBase):
    """cobaya theory wrapping cosmoprimo_tpu_torch."""

    engine = 'eisenstein_hu'
    extra_params = {}
    fiducial = ''
    device = None   # None: the CUDA card

    def initialize(self):
        if not HAS_COBAYA:
            raise ImportError('cobaya is required for this binding')
        super().initialize()
        self._init_requirements()
        from cosmoprimo_tpu_torch import Cosmology, fiducial as fiducial_module
        if self.fiducial:
            self._base_cosmo = getattr(fiducial_module, self.fiducial)(engine=self.engine, device=self.device,
                                                                       extra_params=self.extra_params or None)
        else:
            self._base_cosmo = Cosmology(engine=self.engine, extra_params=self.extra_params or None,
                                         device=self.device)
        self._cosmo = None

    def _init_requirements(self):
        if not hasattr(self, 'collectors'):
            self.collectors = {}
        if not hasattr(self, 'extra_args') or self.extra_args is None:
            self.extra_args = {}
        if not hasattr(self, 'derived_extra'):
            self.derived_extra = []
        if not hasattr(self, 'z_for_matter_power'):
            self.z_for_matter_power = None

    # ------------------------------------------------------------- requirements
    def _get_of(self, pair):
        pair = [OF_CONVERSIONS.get(of, of) for of in pair]
        if 'class' in str(self.engine):
            # pyclass exposes only the combined theta_cb velocity
            pair = [{'theta_b': 'theta_cb', 'theta_cdm': 'theta_cb'}.get(of, of) for of in pair]
        return tuple(pair)

    def _set_cl_reqs(self, reqs):
        self.extra_args['ellmax_cl'] = max(self.extra_args.get('ellmax_cl', 0), max(reqs.values()))

    def must_provide(self, _requirements=None, **requirements):
        """Register likelihood requirements: builds one Collector per
        product, pooling the z-arrays of repeated requests. Products keyed
        by tuples (Pk_grid, sigma_R) can be passed via the positional
        dict."""
        self._init_requirements()
        requirements = {**(_requirements or {}), **requirements}
        if HAS_COBAYA and hasattr(super(), 'must_provide'):
            super().must_provide(**requirements)
            reqs = self._must_provide
        else:  # stub mode: requirements come pre-normalized
            self._must_provide = {**getattr(self, '_must_provide', {}), **requirements}
            reqs = self._must_provide

        for k, v in reqs.items():
            if k == 'Cl':
                self._set_cl_reqs(v)
                self.extra_args['lensing'] = True
                self.collectors[k] = Collector(section='harmonic', method='lensed_cl')
            elif k == 'unlensed_Cl':
                self._set_cl_reqs(v)
                self.collectors[k] = Collector(section='harmonic', method='unlensed_cl')
            elif k == 'Hubble':
                self._set_collector_with_z_pool(k, v['z'], section='background',
                                                method='hubble_function', args_names=['z'])
            elif k in ('Omega_b', 'Omega_cdm', 'Omega_nu_massive'):
                method = {'Omega_nu_massive': 'Omega_ncdm_tot'}.get(k, k)
                self._set_collector_with_z_pool(k, v['z'], section='background',
                                                method=method, args_names=['z'])
            elif k in ('angular_diameter_distance', 'comoving_radial_distance'):
                self._set_collector_with_z_pool(k, v['z'], section='background',
                                                method=k, args_names=['z'])
            elif k == 'angular_diameter_distance_2':
                self._set_collector_with_z_pool(k, v['z_pairs'], section='background',
                                                method='angular_diameter_distance_2',
                                                args_names=['z1', 'z2'], d=2)
            elif isinstance(k, tuple) and k[0] == 'Pk_grid':
                v = deepcopy(v)
                kmax = v.pop('k_max')
                self._add_P_k_max(kmax, units='1/Mpc')
                self._add_z_for_matter_power(v.pop('z'))
                if v.get('nonlinear'):
                    self.extra_args.setdefault('non_linear', 'halofit')
                v['of'] = self._get_of(k[2:])
                v['non_linear'] = bool(v.pop('nonlinear', False))
                v['extrap_kmax'] = 10 * kmax
                self.collectors[k] = Collector(section='fourier', method='pk_interpolator', kwargs=v)
            elif k == 'sigma8_z':
                self._add_z_for_matter_power(v['z'])
                self._set_collector_with_z_pool(k, v['z'], section='fourier', method='sigma8_z',
                                                args_names=['z'], kwargs={'of': 'delta_m'})
            elif k == 'fsigma8':
                self._add_z_for_matter_power(v['z'])
                self._set_collector_with_z_pool(k, v['z'], section='fourier', method='sigma8_z',
                                                args_names=['z'], kwargs={'of': 'theta_cb'})
            elif isinstance(k, tuple) and k[0] == 'sigma_R':
                v = deepcopy(v)
                self._add_P_k_max(v.pop('k_max'), units='1/Mpc')
                self._add_z_for_matter_power(v['z'])
                self.collectors[k] = Collector(section='fourier', method='sigma_rz',
                                               args=[np.asarray(v['R']), np.asarray(v['z'])],
                                               args_names=['R', 'z'], kwargs={'of': self._get_of(k[1:])})
            elif k in tuple(f'get_{q}' for q in ('background', 'thermodynamics', 'primordial', 'perturbations')):
                self.collectors[k] = Collector(section=k[4:])
            elif v is None:  # derived parameter
                if k not in self.derived_extra:
                    self.derived_extra.append(k)
            else:
                raise LoggedError(getattr(self, 'log', None), 'Requested product not known: %r', {k: v})
        return {}

    def _add_z_for_matter_power(self, z):
        if self.z_for_matter_power is None:
            self.z_for_matter_power = np.empty(0)
        self.z_for_matter_power = np.unique(np.concatenate(
            [np.atleast_1d(np.asarray(z, dtype=np.float64)), self.z_for_matter_power]))
        self.extra_args['z_pk'] = self.z_for_matter_power

    def _set_collector_with_z_pool(self, k, zs, section=None, method=None, args=(), args_names=(),
                                   kwargs=None, post=None, d=1):
        """Create/extend the collector for a z-dependent quantity, merging
        the requested z's into the existing pool."""
        if k in self.collectors and self.collectors[k].z_pool is not None:
            z_pool = self.collectors[k].z_pool
            z_pool.update(zs)
        else:
            z_pool = (_ZPool1D if d == 1 else _ZPool2D)(zs)
        kwargs = dict(kwargs or {})
        args = list(args)
        if d == 1 and 'z' in kwargs:
            kwargs['z'] = z_pool.values
        elif d == 1 and 'z' in args_names:
            args.insert(list(args_names).index('z'), z_pool.values)
        elif d == 2 and 'z1' in args_names and 'z2' in args_names:
            i1, i2 = list(args_names).index('z1'), list(args_names).index('z2')
            args = args[:i1] + [z_pool.values[:, 0]] + args[i1:i2 - 1] + [z_pool.values[:, 1]] + args[i2 - 1:]
        else:
            raise LoggedError(getattr(self, 'log', None),
                              f'cannot insert redshift for collector {method} of requisite {k}')
        self.collectors[k] = Collector(section=section, method=method, z_pool=z_pool,
                                       args=args, args_names=args_names, kwargs=kwargs, post=post)

    def _add_P_k_max(self, k_max, units):
        h_fid = 1.0
        if units == 'h/Mpc':
            k_max *= h_fid
        self.extra_args['kmax_pk'] = max(k_max, self.extra_args.pop('kmax_pk', 0))

    # ------------------------------------------------------------- compute
    def calculate(self, state, want_derived=True, **params_values_dict):
        from cosmoprimo_tpu_torch import CosmologyError, constants
        self._init_requirements()
        try:
            clone_args = dict(params_values_dict)
            extra = {name: value for name, value in self.extra_args.items()}
            theta = clone_args.pop('theta_cosmomc', None)
            if theta is not None:
                theta = 100 * theta
            else:
                theta = clone_args.pop('theta_MC_100', None)
            self._cosmo = self._base_cosmo.clone(**clone_args, **extra)
            if theta is not None:
                self._cosmo = self._cosmo.solve('h', 'theta_MC_100', theta)
        except CosmologyError as exc:
            raise LoggedError(getattr(self, 'log', None), 'cosmology error: %s', exc)
        state['cosmo'] = self._cosmo
        cosmo = self._cosmo
        h = float(cosmo['h'])

        for product, collector in self.collectors.items():
            section = getattr(cosmo, f'get_{collector.section}')()
            if collector.method is None:
                state[product] = section
                continue
            args = list(collector.args)
            if isinstance(product, tuple) and product[0] == 'sigma_R':
                args[0] = args[0] * h  # R in Mpc -> Mpc/h
            result = getattr(section, collector.method)(*args, **collector.kwargs)
            if collector.post:
                result = collector.post(*result)
            if isinstance(result, torch.Tensor):
                result = _np(result)
            if isinstance(product, str) and 'distance' in product:
                result = result / h
            if product == 'Hubble':
                result = result / (constants.c / 1e3)  # 1/Mpc, cobaya convention
            if isinstance(product, tuple) and product[0] == 'Pk_grid':
                nweyl = sum(of == 'Weyl' for of in product[2:])
                kmin, kmax = 1e-4, self.extra_args['kmax_pk']
                nk = 125 * int(np.log10(kmax / kmin) + 0.5)
                k = np.geomspace(kmin, kmax, nk)
                z = np.copy(self.z_for_matter_power)
                pk = _np(result(k / h, z, grid=True)).T
                # we served (phi + psi); cobaya wants Weyl = k^2 (phi + psi) / 2
                result = (k, z, pk / h ** 3 * k ** (2 * nweyl) / 2 ** nweyl)
            if isinstance(product, tuple) and product[0] == 'sigma_R':
                result = (args[1], np.asarray(args[0]) / h, result.T)  # z, R [Mpc], sigma
            if isinstance(product, str) and 'Cl' in product:
                table = {name: _np(result[name]) for name in result}
                if collector.method == 'lensed_cl':
                    pot = cosmo.get_harmonic().lens_potential_cl()
                    table.update({name: _np(pot[name]) for name in pot})
                result = table
            state[product] = result

        if want_derived:
            state['derived'] = {p: _get_from_cosmo(cosmo, p) for p in getattr(self, 'output_params', [])}
        state['derived_extra'] = {p: _get_from_cosmo(cosmo, p) for p in self.derived_extra}
        return True

    # ------------------------------------------------------------- getters
    def _collected(self, key):
        state = self.current_state
        if key in state:
            return state[key]
        raise LoggedError(getattr(self, 'log', None),
                          '%r was not computed: declare it in must_provide', key)

    def get_Hubble(self, z, units='km/s/Mpc'):
        ba = self.current_state['cosmo'].get_background()
        H = _np(ba.hubble_function(np.asarray(z)))
        if units == '1/Mpc':
            from cosmoprimo_tpu_torch import constants
            H = H / (constants.c / 1e3)
        return H

    def get_angular_diameter_distance(self, z):
        ba = self.current_state['cosmo'].get_background()
        h = float(self.current_state['cosmo']['h'])
        return _np(ba.angular_diameter_distance(np.asarray(z))) / h  # Mpc

    def get_angular_diameter_distance_2(self, z_pairs):
        ba = self.current_state['cosmo'].get_background()
        h = float(self.current_state['cosmo']['h'])
        z_pairs = np.atleast_2d(np.asarray(z_pairs, dtype=np.float64))
        return _np(ba.angular_diameter_distance_2(z_pairs[:, 0], z_pairs[:, 1])) / h

    def get_comoving_radial_distance(self, z):
        ba = self.current_state['cosmo'].get_background()
        h = float(self.current_state['cosmo']['h'])
        return _np(ba.comoving_radial_distance(np.asarray(z))) / h  # Mpc

    def get_Pk_grid(self, var_pair=('delta_tot', 'delta_tot'), nonlinear=False, extrap_kmax=None):
        key = ('Pk_grid', bool(nonlinear)) + tuple(var_pair)
        state = self.current_state
        if key in state:
            return state[key]
        cosmo = state['cosmo']
        fo = cosmo.get_fourier()
        pk = fo.pk_interpolator(of=self._get_of(var_pair), non_linear=bool(nonlinear))
        h = float(cosmo['h'])
        k = np.asarray(pk.k) * h  # 1/Mpc
        z = np.asarray(pk.z)
        pkz = _np(pk(pk.k, z)) / h ** 3  # Mpc^3
        return k, z, pkz.T

    def get_sigma8_z(self, z):
        state = self.current_state
        if 'sigma8_z' in state:
            pool = self.collectors['sigma8_z'].z_pool
            return np.asarray(state['sigma8_z'])[pool.find_indices(z)]
        fo = state['cosmo'].get_fourier()
        return _np(fo.pk_interpolator().sigma8_z(np.asarray(z)))

    def get_fsigma8(self, z):
        state = self.current_state
        if 'fsigma8' in state:
            pool = self.collectors['fsigma8'].z_pool
            return np.asarray(state['fsigma8'])[pool.find_indices(z)]
        cosmo = state['cosmo']
        ba = cosmo.get_background()
        pk = cosmo.get_fourier().pk_interpolator()
        z = np.asarray(z)
        return _np(ba.growth_rate(z)) * _np(pk.sigma8_z(z))

    def get_Cl(self, ell_factor=False, units='FIRASmuK2'):
        state = self.current_state
        cls = state['Cl'] if 'Cl' in state else None
        if cls is None:
            hr = state['cosmo'].get_harmonic()
            table = hr.lensed_cl()
            cls = {name: _np(table[name]) for name in table}
        return self._postprocess_cl(dict(cls), ell_factor=ell_factor, units=units)

    def get_unlensed_Cl(self, ell_factor=False, units='FIRASmuK2'):
        state = self.current_state
        cls = state['unlensed_Cl'] if 'unlensed_Cl' in state else None
        if cls is None:
            hr = state['cosmo'].get_harmonic()
            table = hr.unlensed_cl()
            cls = {name: _np(table[name]) for name in table}
        return self._postprocess_cl(dict(cls), ell_factor=ell_factor, units=units)

    def _postprocess_cl(self, cls, ell_factor=False, units='FIRASmuK2'):
        """The unit and ell-factor conventions of the JAX package's binding:
        every spectrum except the dimensionless 'pp' gets the squared
        temperature factor; 'pp' never gets units and gets
        [l(l+1)]^2/(2pi) when ell_factor."""
        ell = np.asarray(cls['ell'])
        factor = 1.0
        if units == 'FIRASmuK2':
            T_cmb = float(self.current_state['cosmo']['T_cmb'])
            factor = (T_cmb * 1e6) ** 2
        ellf = ell * (ell + 1) / (2 * np.pi) if ell_factor else 1.0
        out = {'ell': ell}
        for name, value in cls.items():
            if name == 'ell':
                continue
            if name == 'pp':
                out[name] = np.asarray(value) * (ellf ** 2 * (2 * np.pi) if ell_factor else 1.0)
            else:
                out[name] = np.asarray(value) * factor * ellf
        return out

    def get_rs_drag(self):
        th = self.current_state['cosmo'].get_thermodynamics()
        h = float(self.current_state['cosmo']['h'])
        return float(th.rs_drag) / h  # Mpc

    def get_param(self, p):
        return _get_from_cosmo(self.current_state['cosmo'], p)

    def get_can_provide_params(self):
        return ['h', 'H0', 'Omega_m', 'Omega_k', 'rs_drag', 'z_drag', 'tau_reio',
                'm_ncdm_tot', 'N_eff', 'sigma8', 'theta_cosmomc']
