"""Cosmological parameter system, engine front-end and background
(the part of cosmoprimo_tpu/cosmology.py on the headline path).

Batch-first: every numeric parameter is a float64 tensor of one common batch
shape, () for one cosmology or (B,) for B of them, on one device. Functions of
redshift return batch shape + z.shape, the layout of the JAX package's
vmapped output. Invalid values make their rows NaN and never raise, so no
check waits on the device.

Massive neutrinos are not ported yet (ROADMAP.md, queue 1, slice 4): a
massive-neutrino input raises NotImplementedError, and the ncdm densities are
zero.
"""

import functools
import sys

import numpy as np
import torch

from . import constants, utils
from .ops import Interpolator1D, cumquad_rk4, exception_or_nan, flatarray

_Sections = ['Background', 'Thermodynamics', 'Primordial', 'Perturbations', 'Transfer', 'Harmonic', 'Fourier']

_NO_NCDM = 'massive neutrinos are not ported yet (ROADMAP.md, queue 1, slice 4)'


class CosmologyError(Exception):
    """Exception raised by :class:`Cosmology`."""


class CosmologyInputError(CosmologyError):
    """Error in the value of input parameters."""


# ----------------------------------------------------------------------------
# Parameter tables
# ----------------------------------------------------------------------------

DEFAULT_COSMOLOGICAL_PARAMETERS = dict(
    h=0.7, Omega_cdm=0.25, Omega_b=0.05, Omega_k=0.0, sigma8=0.8, k_pivot=0.05,
    n_s=0.96, alpha_s=0.0, beta_s=0.0, r=0.0, n_t='scc', alpha_t='scc', T_cmb=constants.TCMB,
    m_ncdm=None, neutrino_hierarchy=None, T_ncdm_over_cmb=constants.TNCDM_OVER_CMB, N_eff=constants.NEFF,
    tau_reio=0.06, reionization_width=0.5, A_L=1.0, w0_fld=-1.0, wa_fld=0.0, cs2_fld=1.0)

DEFAULT_CALCULATION_PARAMETERS = dict(
    non_linear='', modes='s', lensing=False, z_pk=None, kmax_pk=10.0, ellmax_cl=2500, YHe='BBN', use_ppf=True)

_CONFLICTS_NO_ALIAS = [
    ('h', 'H0'),
    ('T_cmb', 'Omega_g', 'omega_g'),
    ('Omega_b', 'omega_b'),
    ('Omega_cdm', 'omega_cdm', 'Omega_c', 'omega_c', 'Omega_m', 'omega_m'),
    ('Omega_k', 'omega_k'),
    ('N_ur', 'Omega_ur', 'omega_ur', 'N_eff'),
    ('m_ncdm', 'Omega_ncdm', 'omega_ncdm'),
    ('A_s', 'logA', 'sigma8'),
    ('tau_reio', 'z_reio'),
]

ALIASES = {
    'omega_b': ('ombh2',), 'omega_cdm': ('omch2',), 'Omega_k': ('omk',), 'm_ncdm': ('mnu',),
    'N_eff': ('nnu',), 'n_s': ('ns',), 'alpha_s': ('nrun',), 'beta_s': ('nrunrun',), 'tau_reio': ('tau',),
    'Omega_m': ('Omega0_m',), 'Omega_cdm': ('Omega0_cdm', 'Omega_c'), 'Omega_b': ('Omega0_b',),
    'Omega_k': ('Omega0_k',), 'Omega_ur': ('Omega0_ur',), 'Omega_ncdm': ('Omega0_ncdm',),
    'Omega_fld': ('Omega0_fld',), 'T_cmb': ('T0_cmb',), 'Omega_g': ('Omega0_g',),
    'logA': ('ln10^10A_s', 'ln10^{10}A_s', 'ln_A_s_1e10'), 'w0_fld': ('w',), 'wa_fld': ('wa',),
}


def _all_conflicts(conflicts_no_alias, aliases):
    out = []
    for group in conflicts_no_alias:
        group = list(group)
        for name in list(group):
            for alias in aliases.get(name, ()):
                if alias not in group:
                    group.append(alias)
        out.append(tuple(group))
    for name, als in aliases.items():
        if not any(name in group for group in conflicts_no_alias):
            out.append((name,) + tuple(als))
    return out


CONFLICT_PARAMETERS = _all_conflicts(_CONFLICTS_NO_ALIAS, ALIASES)


def find_conflicts(name, conflicts=CONFLICT_PARAMETERS):
    for group in conflicts:
        if name in group:
            return group
    return ()


def check_params(params, conflicts=CONFLICT_PARAMETERS):
    for name in params:
        clash = [eq for eq in find_conflicts(name, conflicts) if eq != name and eq in params]
        if clash:
            raise CosmologyInputError('Conflicting parameters are given: {}'.format([name] + clash))


def merge_params(base, update, conflicts=CONFLICT_PARAMETERS):
    """Merge ``update`` into ``base``, dropping parameters of ``base`` that
    conflict with names in ``update`` (``base`` modified in place)."""
    for name in update:
        for eq in find_conflicts(name, conflicts):
            base.pop(eq, None)
    base.update(update)
    return base


# ----------------------------------------------------------------------------
# Parameter compilation
# ----------------------------------------------------------------------------

_STATIC_PARAMS = ('z_pk', 'kmax_pk', 'ellmax_cl')
_SPECIES_PARAMS = ('m_ncdm', 'T_ncdm_over_cmb')


def _has_species(value):
    return value is not None and (np.ndim(value) == 0 or len(value) > 0)


def _infer_device(params):
    for value in params.values():
        if isinstance(value, torch.Tensor):
            return value.device
    return torch.device('cpu')


def _asfloat(value, device):
    """``value`` as a float64 tensor on ``device``. A Python or numpy scalar
    is filled in on the device: a copy from host memory would wait for all
    the work already queued there."""
    if not isinstance(value, torch.Tensor) and np.ndim(value) == 0:
        return torch.full((), float(value), dtype=torch.float64, device=device)
    if isinstance(value, np.ndarray):
        value = value.copy()  # may be read-only; torch would share its memory
    return torch.as_tensor(value, dtype=torch.float64, device=device)


def _to_batch(params, device):
    """Make every numeric parameter a float64 tensor on ``device``, and
    broadcast the per-cosmology ones to their common batch shape."""
    batch = {}
    for name, value in params.items():
        if name in _STATIC_PARAMS or value is None or isinstance(value, (str, bool, list, tuple)):
            continue
        value = _asfloat(value, device)
        if name in _SPECIES_PARAMS:
            params[name] = value
        else:
            batch[name] = value
    shape = torch.broadcast_shapes(*(value.shape for value in batch.values()))
    params.update({name: value.expand(shape) for name, value in batch.items()})
    return params


def compile_params(args, engine=None, device=None):
    """Normalize input parameters to the internal basis: H0->h, omega->Omega,
    logA->A_s, Omega_g->T_cmb, N_ur from N_eff; apply positivity and
    dark-energy validation, poisoning the offending rows with NaN.

    Pure function: dict in, dict out (numeric values as batch tensors).
    """
    params = dict(args)
    if device is None:
        device = _infer_device(params)
    check_ignore = getattr(engine, '_check_ignore', ()) if engine is not None else ()

    def asfloat(value):
        return _asfloat(value, device)

    for name in ('m_ncdm', 'mnu', 'Omega_ncdm', 'Omega0_ncdm', 'omega_ncdm', 'neutrino_hierarchy'):
        if _has_species(params.pop(name, None)):
            raise NotImplementedError(f'{name} given: {_NO_NCDM}')
    T_ncdm_over_cmb = params.pop('T_ncdm_over_cmb', None)
    if T_ncdm_over_cmb is not None and np.ndim(T_ncdm_over_cmb) and len(T_ncdm_over_cmb):
        raise TypeError('T_ncdm_over_cmb and m_ncdm must have the same length, found '
                        f'{len(T_ncdm_over_cmb)} != 0')

    if 'H0' in params:
        params['h'] = params.pop('H0') / 100.0

    def set_alias(target, aliases):
        for alias in aliases:
            if alias in params:
                assert target not in params, f'found both {alias} and {target}'
                params[target] = params.pop(alias)

    omegas = ['omega_b', 'omega_cdm', 'omega_m']
    for name in omegas:
        set_alias(name, ALIASES.get(name, ()))

    h = params['h']
    for name in list(params):
        if name.startswith('omega'):
            value = asfloat(params.pop(name)) / h ** 2
            target = name.replace('omega', 'Omega')
            assert target not in params, f'found both {name} and {target}'
            params[target] = value

    for name, aliases in ALIASES.items():
        if name in omegas:
            continue
        set_alias(name, aliases)

    if 'logA' in params:
        params['A_s'] = torch.exp(asfloat(params.pop('logA'))) * 1e-10

    if 'Omega_g' in params:
        params['T_cmb'] = (asfloat(params.pop('Omega_g')) * h ** 2 * constants.rho_crit_over_kgph_per_mph3
                           / (4.0 / constants.c ** 3 * constants.Stefan_Boltzmann)) ** 0.25

    N_ur = params.pop('N_ur', None)
    if 'Omega_ur' in params:
        T_ur = params['T_cmb'] * (4.0 / 11.0) ** (1.0 / 3.0)
        rho = 7.0 / 8.0 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann * T_ur ** 4
        N_ur = params.pop('Omega_ur') / (rho / (h ** 2 * constants.rho_crit_over_kgph_per_mph3))
    # no ncdm species: N_eff is carried by the massless neutrinos alone
    N_eff = params.pop('N_eff', constants.NEFF)
    params['N_ur'] = asfloat(N_eff if N_ur is None else N_ur)
    params['m_ncdm'] = torch.zeros(0, dtype=torch.float64, device=device)
    params['T_ncdm_over_cmb'] = torch.zeros(0, dtype=torch.float64, device=device)
    if params.pop('N_ncdm', None) is not None:
        raise CosmologyInputError('Do not provide N_ncdm; provide m_ncdm of the correct length')

    if params.get('z_pk', None) is None:
        from .interpolator import get_default_z_callable
        params['z_pk'] = get_default_z_callable()
    if params.get('modes', None) is None:
        params['modes'] = ['s']
    for name in ['modes', 'z_pk']:
        if np.ndim(params[name]) == 0:
            params[name] = [params[name]]
    params['z_pk'] = np.sort(np.asarray(params['z_pk']))
    if 0.0 not in params['z_pk']:
        params['z_pk'] = np.insert(params['z_pk'], 0, 0.0)

    if 'Omega_m' in params:
        params['Omega_cdm'] = params.pop('Omega_m') - params['Omega_b']

    for name, default in {'w0_fld': -1.0, 'wa_fld': 0.0, 'cs2_fld': 1.0}.items():
        params[name] = asfloat(params.get(name, default))

    def w_err(value):
        raise CosmologyInputError(f'w0_fld + wa_fld >= 1/3 (found {value}) violates early radiation domination')
    value = params['w0_fld'] + params['wa_fld']
    value = exception_or_nan(value, value >= 1.0 / 3.0, w_err)
    for name in ['w0_fld', 'wa_fld']:
        params[name] = torch.where(torch.isnan(value), torch.nan, params[name])

    params['use_ppf'] = bool(params.get('use_ppf', True))

    for basename in ['Omega_cdm', 'Omega_b', 'T_cmb', 'h', 'A_s', 'sigma8']:
        if basename in params and basename not in check_ignore:
            value = asfloat(params[basename])

            def pos_err(v, basename=basename):
                raise CosmologyInputError(f'Parameter {basename} should be positive, found {v}')
            params[basename] = exception_or_nan(value, value < 0.0, pos_err)

    def check_str(name, allowed):
        value = params[name]
        if value is None:
            value = allowed[0]
        if isinstance(value, str):
            value = value.upper()
            if value not in allowed:
                raise CosmologyInputError(f'Parameter {name} should be a float or one of {allowed}')
            params[name] = value
            return True
        params[name] = asfloat(value)
        return False

    check_str('YHe', ('BBN',))
    check_str('n_t', ('SCC',))
    check_str('alpha_t', ('SCC',))
    r, n_s = params['r'], params['n_s']
    # single-field slow-roll consistency (as CAMB initialpower)
    if params['n_t'] == 'SCC':
        params['n_t'] = -r / 8.0 * (2.0 - n_s - r / 8.0)
    if params['alpha_t'] == 'SCC':
        params['alpha_t'] = r / 8.0 * (r / 8.0 + n_s - 1)

    return _to_batch(params, device)


# ----------------------------------------------------------------------------
# Derived-parameter accessor shared by Cosmology and engines
# ----------------------------------------------------------------------------

class ParamsAccessor(object):
    """Dict-style access to base and derived parameters."""

    def __getitem__(self, name):
        return self.get(name)

    @property
    def device(self):
        return self._params['h'].device

    @property
    def batch_shape(self):
        return self._params['h'].shape

    def get(self, *args, **kwargs):
        if len(args) == 1:
            name = args[0]
            has_default = 'default' in kwargs
            default = kwargs.get('default', None)
        else:
            name, default = args
            has_default = True
        try:
            return self._get(name, self._params)
        except KeyError:
            pass
        if has_default:
            return default
        raise CosmologyError(f'Parameter {name} not found.')

    def _get(self, name, params):
        if name in params:
            return params[name]
        if name in self._derived:
            return self._derived[name]
        if name.startswith('omega'):
            return self.get('O' + name[1:]) * params['h'] ** 2
        if name == 'H0':
            return params['h'] * 100
        if name in ('logA', 'ln10^{10}A_s', 'ln10^10A_s', 'ln_A_s_1e10'):
            return torch.log(1e10 * params['A_s'])
        if name == 'Omega_g':
            rho = params['T_cmb'] ** 4 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
            return rho / (self.get('h') ** 2 * constants.rho_crit_over_kgph_per_mph3)
        if name == 'T_ur':
            return params['T_cmb'] * (4.0 / 11.0) ** (1.0 / 3.0)
        if name == 'T_ncdm':
            return params['T_ncdm_over_cmb'] * params['T_cmb'][..., None]
        if name == 'Omega_ur':
            rho = params['N_ur'] * 7.0 / 8.0 * self.get('T_ur') ** 4 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
            return rho / (self.get('h') ** 2 * constants.rho_crit_over_kgph_per_mph3)
        if name == 'Omega_r':
            rho = (params['T_cmb'] ** 4 + params['N_ur'] * 7.0 / 8.0 * self.get('T_ur') ** 4) * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
            return rho / (self.get('h') ** 2 * constants.rho_crit_over_kgph_per_mph3) + self.get('Omega_pncdm_tot')
        if name == 'm_ncdm_tot':
            return torch.sum(params['m_ncdm'])
        if name in ('Omega_ncdm', 'Omega_pncdm'):
            # one row per species (none yet), then the batch
            return params['h'].new_zeros((0,) + params['h'].shape)
        if name == 'Omega_ncdm_tot':
            return torch.sum(self.get('Omega_ncdm'), dim=0)
        if name == 'Omega_pncdm_tot':
            return torch.sum(self.get('Omega_pncdm'), dim=0)
        if name == 'Omega_m':
            return self.get('Omega_b') + self.get('Omega_cdm') + self.get('Omega_ncdm_tot') - self.get('Omega_pncdm_tot')
        if name == 'Omega_de':
            return 1.0 - sum(self.get(nm) for nm in ['Omega_cdm', 'Omega_b', 'Omega_g', 'Omega_ur', 'Omega_ncdm_tot', 'Omega_k'])
        if name == 'Omega_Lambda':
            return torch.where(self._has_fld, 0.0, self.get('Omega_de'))
        if name == 'Omega_fld':
            return torch.where(self._has_fld, self.get('Omega_de'), 0.0)
        if name == 'K':
            return -100.0 ** 2 / (constants.c / 1e3) ** 2 * params['Omega_k']  # (h/Mpc)^2
        if name == 'N_ncdm':
            return len(params['m_ncdm'])
        if name == 'N_eff':
            return torch.sum(params['T_ncdm_over_cmb'] ** 4 * (4.0 / 11.0) ** (-4.0 / 3.0)) + params['N_ur']
        raise KeyError(name)

    @property
    def _has_fld(self):
        return (self._params['w0_fld'] != -1) | (self._params['wa_fld'] != 0) | (self._params['cs2_fld'] != 1.0)


# ----------------------------------------------------------------------------
# Engine registry
# ----------------------------------------------------------------------------

_ENGINE_REGISTRY = {}

_ENGINE_MODULES = {
    'eisenstein_hu': 'models.eisenstein_hu',
}


def register_engine(cls):
    """Register an engine class. Section classes are discovered from the
    engine's module by name on first access."""
    _ENGINE_REGISTRY[cls.name] = cls
    return cls


def get_engine(engine):
    """Resolve an engine name or class to the engine class."""
    if isinstance(engine, str):
        engine = engine.lower()
        if engine not in _ENGINE_REGISTRY:
            modname = _ENGINE_MODULES.get(engine)
            if modname is not None:
                import importlib
                importlib.import_module('.' + modname, __package__)
        try:
            return _ENGINE_REGISTRY[engine]
        except KeyError:
            raise CosmologyInputError(f'Unknown engine {engine}; ported engines: {sorted(_ENGINE_MODULES)}.')
    if isinstance(engine, BaseEngine):
        return engine.__class__
    return engine


class BaseEngine(ParamsAccessor):
    """Base engine: holds compiled parameters and lazily-instantiated physics
    sections."""

    name = 'base'
    _check_ignore = ()
    _default_cosmological_parameters = dict()
    _default_calculation_parameters = dict()

    @classmethod
    def _section_classes(cls):
        """Section classes discovered from the engine's module by name,
        cached per engine class."""
        cached = cls.__dict__.get('_Section_classes_cache', None)
        if cached is not None:
            return cached
        module = sys.modules[cls.__module__]
        sections = {}
        for name in _Sections:
            Section = getattr(module, name, None)
            if Section is not None:
                sections[name.lower()] = Section
        cls._Section_classes_cache = sections
        return sections

    @property
    def _Section_classes(self):
        return self._section_classes()

    def __init__(self, cosmo, **extra_params):
        params = dict(cosmo._params)
        defaults = dict(self._default_cosmological_parameters)
        defaults.update(self._default_calculation_parameters)
        for name, value in defaults.items():
            params.setdefault(name, value)
        for name in [name for name in extra_params if name in defaults]:
            params[name] = extra_params.pop(name)
        self._params = params
        self._derived = {}
        self._extra_params = dict(extra_params)
        self._sections = {}
        self._rsigma8 = None

    def get_section(self, section):
        section = section.lower()
        if section not in self._sections:
            try:
                Section = self._section_classes()[section]
            except KeyError:
                raise CosmologyInputError(f'Engine {self.name} does not provide section {section}')
            self._sections[section] = Section(self)
        return self._sections[section]

    def _get_A_s_fid(self):
        """First-guess A_s given sigma8 (CLASS input.c heuristic)."""
        if 'A_s' in self._params:
            return self._params['A_s']
        return 2.43e-9 * (self['sigma8'] / 0.87659) ** 2

    def _get_sigma8_fid(self):
        if 'sigma8' in self._params:
            return self._params['sigma8']
        return (self['A_s'] / 2.43e-9) ** 0.5 * 0.87659

    def _rescale_sigma8(self):
        """Ratio rescaling the perturbative amplitudes so that sigma8 matches
        the input value; 1 when the amplitude is given as A_s or logA.

        Two passes, as the JAX package: the ratio is set to 1, the Fourier
        section is dropped and built again on the first-guess amplitude, its
        sigma8_m gives the ratio, and the section is dropped again so that
        the next one is built on the rescaled amplitude. A Primordial section
        built during the first pass sees the ratio 1."""
        if self._rsigma8 is not None:
            return self._rsigma8
        self._rsigma8 = 1.0
        if 'sigma8' in self._params:
            self._sections.pop('fourier', None)
            self._rsigma8 = self._params['sigma8'] / self.get_section('fourier').sigma8_m
            self._sections.pop('fourier', None)
        return self._rsigma8

    def clone(self, **params):
        """A new engine of this class on this engine's compiled parameters,
        with ``params`` (compiled names, batch tensors) replaced."""
        cosmo = Cosmology.__new__(Cosmology)
        cosmo._params = {**self._params, **params}
        return self.__class__(cosmo, **self._extra_params)


for _section in _Sections:
    def _make_engine_getter(section):
        def getter(self):
            return self.get_section(section)
        getter.__doc__ = f'Return {section} calculations.'
        return getter
    setattr(BaseEngine, 'get_{}'.format(_section.lower()), _make_engine_getter(_section.lower()))


# ----------------------------------------------------------------------------
# Cosmology
# ----------------------------------------------------------------------------

class Cosmology(ParamsAccessor):
    """A validated batch of cosmological parameters with an optional engine.

    Parameters may be Python numbers, numpy arrays or tensors; they are
    broadcast to one batch shape, as float64 tensors on ``device`` (by default
    the device of the first tensor given, else the CPU).
    """

    def __init__(self, engine=None, extra_params=None, device=None, **params):
        check_params(params)
        self._derived = {}
        self._engine = None
        defaults = dict(DEFAULT_COSMOLOGICAL_PARAMETERS)
        defaults.update(DEFAULT_CALCULATION_PARAMETERS)
        self._input_params = merge_params(defaults, params)
        self._params = compile_params(self._input_params, engine=get_engine(engine) if engine is not None else None,
                                      device=device)
        self._extra_params = {}
        if engine is not None:
            self.set_engine(engine, **(extra_params or {}))

    @property
    def engine(self):
        return self._engine

    def set_engine(self, engine, set_engine=True, **extra_params):
        if engine is None:
            if self._engine is None:
                raise CosmologyInputError('Please provide an engine')
            engine = self._engine
        elif not isinstance(engine, BaseEngine):
            engine = get_engine(engine)(self, **extra_params)
        if set_engine:
            self._engine = engine
        return engine

    @classmethod
    def from_state(cls, state, device=None):
        """Build from the dict that ``cosmoprimo_tpu.Cosmology.__getstate__()``
        returns (numpy arrays and strings), on ``device`` (default CPU), with
        its compiled parameters taken as they are."""
        params = dict(state['params'])
        for name in _SPECIES_PARAMS:
            if np.size(params.get(name, ())):
                raise NotImplementedError(f'{name} in state: {_NO_NCDM}')
        new = cls.__new__(cls)
        new._derived = {}
        new._engine = None
        new._extra_params = {}
        new._input_params = dict(state.get('input_params', {}))
        new._params = _to_batch(params, torch.device('cpu') if device is None else torch.device(device))
        if state.get('engine', None) is not None:
            new.set_engine(state['engine']['name'], **state['engine']['extra_params'])
        return new

    def __getattr__(self, name):
        """Forward attribute access to the engine's sections, e.g.
        ``cosmo.comoving_radial_distance`` finds the Background method."""
        if name.startswith('_'):
            raise AttributeError(name)
        engine = self.__dict__.get('_engine', None)
        if engine is None:
            raise AttributeError(f'Attribute {name} not found; try setting an engine ("set_engine")?')
        owners = [sec for sec, S in engine._Section_classes.items() if hasattr(S, name)]
        if len(owners) == 1:
            return getattr(engine.get_section(owners[0]), name)
        raise AttributeError(f'Attribute {name} not found in a unique section of engine {engine.name}')


for _section in _Sections:
    def _make_cosmo_getter(section):
        def getter(self, engine=None, set_engine=True, **extra_params):
            engine_obj = self.set_engine(engine, set_engine=set_engine, **extra_params)
            return engine_obj.get_section(section)
        getter.__doc__ = f'Return {section} calculations (optionally with a new engine).'
        return getter
    setattr(Cosmology, 'get_{}'.format(_section.lower()), _make_cosmo_getter(_section.lower()))


# ----------------------------------------------------------------------------
# Sections
# ----------------------------------------------------------------------------

class BaseSection(object):
    """Base physics section, on the engine's device."""

    def __init__(self, engine):
        self._engine = engine
        self.device = engine.device

    @property
    def engine(self):
        """The engine this section was built from."""
        return self._engine


@utils.addproperty('H0', 'h', 'N_ur', 'N_ncdm', 'm_ncdm', 'm_ncdm_tot', 'N_eff', 'T0_cmb', 'T0_ncdm',
                   'w0_fld', 'wa_fld', 'cs2_fld', 'K',
                   'Omega0_cdm', 'Omega0_b', 'Omega0_k', 'Omega0_g', 'Omega0_ur', 'Omega0_r',
                   'Omega0_pncdm', 'Omega0_pncdm_tot', 'Omega0_ncdm', 'Omega0_ncdm_tot',
                   'Omega0_m', 'Omega0_Lambda', 'Omega0_fld', 'Omega0_de')
class BaseBackground(BaseSection):
    """Background quantities from closed-form densities.

    Densities are *comoving*, in :math:`10^{10} M_\\odot/h / (\\mathrm{Mpc}/h)^3`.
    Parameters have the batch shape; methods of z return batch + z.shape.
    """

    def __init__(self, engine):
        super().__init__(engine)
        for name in ['H0', 'h', 'N_ur', 'N_ncdm', 'm_ncdm', 'm_ncdm_tot', 'N_eff', 'w0_fld', 'wa_fld', 'cs2_fld', 'K']:
            setattr(self, '_' + name, engine[name])
        self._T0_cmb = engine['T_cmb']
        self._T0_ncdm = engine['T_ncdm']
        for name in ['cdm', 'b', 'k', 'g', 'ur', 'r', 'ncdm', 'ncdm_tot', 'pncdm', 'pncdm_tot', 'm', 'Lambda', 'fld', 'de']:
            setattr(self, '_Omega0_' + name, engine['Omega_' + name])

    # ---- densities
    @flatarray()
    def rho_ncdm_tot(self, z):
        return torch.zeros_like(self.h[..., None] * z)

    @flatarray()
    def p_ncdm_tot(self, z):
        return torch.zeros_like(self.h[..., None] * z)

    @flatarray()
    def rho_g(self, z):
        return self.Omega0_g[..., None] * (1 + z) * constants.rho_crit_over_Msunph_per_Mpcph3

    @flatarray()
    def rho_b(self, z):
        return self.Omega0_b[..., None] * torch.ones_like(z) * constants.rho_crit_over_Msunph_per_Mpcph3

    @flatarray()
    def rho_ur(self, z):
        return self.Omega0_ur[..., None] * (1 + z) * constants.rho_crit_over_Msunph_per_Mpcph3

    def rho_r(self, z):
        return self.rho_g(z) + self.rho_ur(z) + 3.0 * self.p_ncdm_tot(z)

    @flatarray()
    def rho_cdm(self, z):
        return self.Omega0_cdm[..., None] * torch.ones_like(z) * constants.rho_crit_over_Msunph_per_Mpcph3

    def rho_m(self, z):
        return self.rho_cdm(z) + self.rho_b(z) + self.rho_ncdm_tot(z) - 3.0 * self.p_ncdm_tot(z)

    @flatarray()
    def rho_k(self, z):
        return self.Omega0_k[..., None] / (1 + z) * constants.rho_crit_over_Msunph_per_Mpcph3

    @flatarray()
    def rho_Lambda(self, z):
        return self.Omega0_Lambda[..., None] / (1 + z) ** 3 * constants.rho_crit_over_Msunph_per_Mpcph3

    @flatarray()
    def rho_fld(self, z):
        # CPL equation of state w(a) = w0 + wa (1 - a)
        w0, wa = self.w0_fld[..., None], self.wa_fld[..., None]
        return (self.Omega0_fld[..., None] * (1 + z) ** (3.0 * (1 + w0 + wa))
                * torch.exp(3.0 * wa * (1.0 / (1 + z) - 1)) * constants.rho_crit_over_Msunph_per_Mpcph3 / (1 + z) ** 3)

    @flatarray()
    def rho_de(self, z):
        w0, wa = self.w0_fld[..., None], self.wa_fld[..., None]
        return (self.Omega0_de[..., None] * (1 + z) ** (3.0 * (w0 + wa))
                * torch.exp(3.0 * wa * (1.0 / (1 + z) - 1)) * constants.rho_crit_over_Msunph_per_Mpcph3)

    def rho_tot(self, z):
        m = self.rho_cdm(z) + self.rho_b(z) + self.rho_ncdm_tot(z)
        r = self.rho_g(z) + self.rho_ur(z)
        return m + r + self.rho_de(z)

    def rho_crit(self, z):
        return self.rho_tot(z) + self.rho_k(z)

    # ---- expansion
    @flatarray()
    def efunc(self, z):
        return torch.sqrt(self.rho_crit(z) * (1 + z) ** 3 / constants.rho_crit_over_Msunph_per_Mpcph3)

    @flatarray()
    def hubble_function(self, z):
        return self.efunc(z) * self.H0[..., None]

    # ---- density parameters
    def Omega_cdm(self, z):
        return self.rho_cdm(z) / self.rho_crit(z)

    def Omega_b(self, z):
        return self.rho_b(z) / self.rho_crit(z)

    def Omega_k(self, z):
        return self.rho_k(z) / self.rho_crit(z)

    def Omega_g(self, z):
        return self.rho_g(z) / self.rho_crit(z)

    def Omega_ur(self, z):
        return self.rho_ur(z) / self.rho_crit(z)

    def Omega_r(self, z):
        return self.rho_r(z) / self.rho_crit(z)

    def Omega_m(self, z):
        return self.rho_m(z) / self.rho_crit(z)

    def Omega_ncdm_tot(self, z):
        return self.rho_ncdm_tot(z) / self.rho_crit(z)

    def Omega_pncdm_tot(self, z):
        return 3 * self.p_ncdm_tot(z) / self.rho_crit(z)

    def Omega_Lambda(self, z):
        return self.rho_Lambda(z) / self.rho_crit(z)

    def Omega_fld(self, z):
        return self.rho_fld(z) / self.rho_crit(z)

    def Omega_de(self, z):
        return self.rho_de(z) / self.rho_crit(z)


@functools.lru_cache(maxsize=None)
def _z_interp_tensor(name, device):
    """:func:`get_default_z_interp` on ``device``, copied there once."""
    return torch.from_numpy(get_default_z_interp(name)).to(device)


def get_default_z_interp(name):
    """Static z-grids for background interpolation tables."""
    if name in ('rho_ncdm', 'p_ncdm'):
        zm = 1.0
        return np.concatenate([np.linspace(0.0, zm, 20)[:-1], 1.0 / np.geomspace(1e-8, 1.0 / (1 + zm), 100)[::-1] - 1.0])
    if name in ('time', 'age'):
        return 1.0 / np.logspace(-8, 0.0, 400)[::-1] - 1.0
    if name == 'comoving_radial_distance':
        zm = 0.3
        return np.concatenate([np.linspace(0.0, zm, 20)[:-1], 1.0 / np.geomspace(1e-4, 1.0 / (1 + zm), 100)[::-1] - 1.0])
    raise ValueError(f'No default z interpolation grid for {name}')


class DefaultBackground(BaseBackground):
    """Background with interpolation tables for the expensive quantities,
    built on first access and cached on the section."""

    def __init__(self, engine):
        super().__init__(engine)
        self._cache = {}

    @flatarray()
    def comoving_radial_distance(self, z):
        r"""Comoving radial distance, in Mpc/h (astro-ph/9905116 eq. 15)."""
        if 'comoving_radial_distance' not in self._cache:
            zc = _z_interp_tensor('comoving_radial_distance', self.device)
            tmp = cumquad_rk4(lambda y, zz: constants.c / 1e3 / (100.0 * self.efunc(zz)), 0.0, zc)
            # the spline runs along axis 0: knots first, batch after
            self._cache['comoving_radial_distance'] = Interpolator1D(zc, torch.movedim(tmp, -1, 0), assume_sorted=True)
        return torch.movedim(self._cache['comoving_radial_distance'](z), 0, -1)
