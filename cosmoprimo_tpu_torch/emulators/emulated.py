"""Emulated cosmology engine (cosmoprimo_tpu/emulators/emulated.py): serve
an emulator's predictions through the standard section API ('emulated',
and the pretrained 'capse', 'cosmopower_bolliet2023',
'emu_camb_mnu_w_wa_cmb' and 'cosmopower_jense2024' entry points).

Sections rebuild callables from the predicted tables: Background by
splines over the default background z-grid (or, with no background nets,
the ODE default background), Fourier by PowerSpectrumInterpolator2D over the
predicted (k, z) tables (sigma8 and to_xi through the FFTLog kernel on the
card), Harmonic as Cl tables. Batch-first: a section holds the whole batch,
each table batch + its shape, and everything stays torch, so lensed_cl etc.
take ``torch.func.jacfwd`` end to end.

No emulator file is downloaded: a pretrained engine reads its file from
``$COSMOPRIMO_EMULATOR_DIR`` (default ~/.cosmoprimo/emulators), and raises
CosmologyError naming the path when it is absent.
"""

import os

import numpy as np
import torch

from .. import utils
from ..cosmology import (BaseBackground, BaseEngine, BaseSection, CosmologyError, DefaultBackground,
                         _compute_rs_cosmomc, find_conflicts, register_engine, register_section)
from ..interpolator import PowerSpectrumInterpolator1D, PowerSpectrumInterpolator2D
from ..models.native import cl_table
from ..ops import Interpolator1D, flatarray
from .base import Emulator
from .operations import _per_row


def get_default_k_callable():
    """cosmopower-style k-grid (on-disk schema: must match the reference's
    emulator files): per-decade point counts 20/40/60/80/100/120 over
    [1e-5, 10], with 1e-6 / 1e2 end anchors."""
    counts = {-5: 20, -4: 40, -3: 60, -2: 80, -1: 100}
    segments = [np.array([1e-6])]
    for decade, num in counts.items():
        segments.append(np.logspace(decade, decade + 1, num=num, endpoint=False))
    segments += [np.logspace(0, 1, num=120, endpoint=True), np.array([1e2])]
    return np.concatenate(segments)


def get_default_z_callable(key='fourier', non_linear=False):
    if 'background' in key:
        return 1.0 / np.logspace(-3, 0.0, 256)[::-1] - 1.0
    z = np.linspace(0.0, 10.0 ** 0.5, 30) ** 2
    if non_linear:
        return z[z < 2.0]
    return z


def _rescaled(value, rsigma8):
    """A table of batch + its shape times the per-row (or scalar) sigma8
    ratio squared."""
    if isinstance(rsigma8, torch.Tensor):
        return value * _per_row(rsigma8, value) ** 2
    return value * rsigma8 ** 2


def _batched(value, batch, ndim, device):
    """A served quantity of ``ndim`` axes per cosmology as batch + its
    shape, on ``device``: a fixed output (the same for every row) is
    expanded."""
    value = torch.as_tensor(value, dtype=torch.float64, device=device)
    return value.expand(batch + value.shape) if value.dim() == ndim else value


@register_engine
class EmulatedEngine(BaseEngine):
    """Engine backed by an :class:`Emulator` file: ``path`` (a class
    attribute, see :meth:`read`, or ``extra_params={'path': ...}``; a dict
    of paths merges several files). Nothing is downloaded."""

    name = 'emulated'
    path = None

    def __init__(self, cosmo, **extra_params):
        super().__init__(cosmo, **extra_params)
        # the emulator read from the class's own path is cached on that class
        # (not inherited by a subclass bound to another file)
        emulator = self.__class__.__dict__.get('_emulator', None)
        path = self._extra_params.get('path', self.path)
        if emulator is None or path is not self.path:
            emulator = Emulator()
            paths = path if isinstance(path, dict) else {str(path): None}
            for filename, url in paths.items():
                if not os.path.exists(filename):
                    raise CosmologyError(
                        f'Emulator file {filename} not found. This build has no network egress: download '
                        f'{url or "the emulator"} elsewhere and point `path` or COSMOPRIMO_EMULATOR_DIR at it.')
                other = Emulator.read(filename)
                emulator.yoperations += other.yoperations
                emulator.engines.update(other.engines)
                emulator.defaults.update(other.defaults)
                emulator.fixed.update(other.fixed)
                emulator.xoperations += other.xoperations
            if path is self.path:
                self.__class__._emulator = emulator
        self._emulator = emulator.to(self.device)

        self._A_s = self._get_A_s_fid()
        self._sigma8 = self._get_sigma8_fid()
        self._needs_rescale = None
        self._predictor = _EmulatorPredictor(emulator, self._resolve_inputs(emulator), dict(self._params))

    def _resolve_inputs(self, emulator):
        """Map this cosmology's parameters onto the emulator's expected input
        names, resolving the A_s <-> sigma8 direction mismatch (setting
        ``_needs_rescale``) and theta-derived inputs. Returns the x-space
        inputs (batch tensors) after the emulator's own xoperations."""
        wanted = {name for eng in emulator.engines.values() for name in eng.params} - {'z'}
        values = {}
        for name in wanted:
            if name in ('theta_MC_100', 'theta_cosmomc'):
                values[name] = self._theta_input(name)
            else:
                try:
                    values[name] = self[name]
                except CosmologyError:
                    # direction mismatch between the cosmology's amplitude
                    # parameter and the emulator's training input
                    if name == 'sigma8':
                        values[name] = self._sigma8
                        self._needs_rescale = 'A_s'
                    elif 'A_s' in find_conflicts(name):
                        values[name] = self._A_s if name == 'A_s' else torch.log(1e10 * self._A_s)
                        self._needs_rescale = 'sigma8'
        if 'm_ncdm' in values:
            values['m_ncdm'] = self['m_ncdm_tot']
        values = {**emulator.defaults, **values}
        for operation in emulator.xoperations:
            values = operation(values)
        return values

    def _theta_input(self, name):
        """theta_MC for the emulator input, from the ODE default background
        (self.get_background() would recurse into this engine mid-init)."""
        ba = DefaultBackground(self)
        rs, zstar = _compute_rs_cosmomc(self['omega_b'], self['omega_m'], ba.hubble_function_rows)
        theta = rs * ba.h / ba.comoving_transverse_distance_rows(zstar[..., None])[..., 0]
        return theta * (100.0 if name == 'theta_MC_100' else 1.0)

    def _predict(self, section):
        return self._predictor(section)

    def _rescale_sigma8(self):
        if self._rsigma8 is not None:
            return self._rsigma8
        self._rsigma8 = 1.0
        if self._needs_rescale == 'sigma8':
            self._sections.pop('fourier', None)
            self._rsigma8 = self._params['sigma8'] / self.get_section('fourier').sigma8_m
            self._sections.pop('fourier', None)
        elif self._needs_rescale == 'A_s':
            self._sections.pop('fourier', None)
            self._rsigma8 = (self._params['A_s'] / self.get_section('primordial').A_s) ** 0.5
            self._sections.pop('fourier', None)
        return self._rsigma8

    @classmethod
    def read(cls, filename):
        """Return an engine subclass bound to ``filename``."""

        class _EmulatedEngine(cls):
            path = filename
            __module__ = cls.__module__
        _EmulatedEngine.name = cls.name
        return _EmulatedEngine


class _EmulatorPredictor(object):
    """Serves per-section emulator states.

    Built once per engine: scans the emulator's quantity names into a
    per-section index (fixed values / parameter-only nets / z-dependent
    nets), so each section lookup is a dict hit plus the net evaluations.
    Sections whose nets take ``z`` get a callable that completes the
    prediction at the requested redshifts.
    """

    def __init__(self, emulator, x, cosmo_params):
        self.emulator = emulator
        self.x = x
        self.cosmo_params = cosmo_params
        self.fixed = emulator.fixed_on(cosmo_params['h'].device)
        self.index = {}
        for name, eng in emulator.engines.items():
            section = name.split('.', 1)[0]
            entry = self.index.setdefault(section, {'fixed': {}, 'static': [], 'with_z': []})
            entry['with_z' if 'z' in eng.params else 'static'].append(name)
        for name, value in self.fixed.items():
            section = name.split('.', 1)[0]
            self.index.setdefault(section, {'fixed': {}, 'static': [], 'with_z': []})['fixed'][name] = value

    def _finalize(self, entry, section, raw):
        raw = {**entry['fixed'], **raw}
        X = dict(self.cosmo_params)
        for operation in self.emulator.yoperations[::-1]:
            try:
                raw = operation.inverse(raw, X=X)
            except KeyError:
                pass
        # a fixed output that the operations left as it is goes to the section
        # as the emulator's numpy array, as the JAX package serves it: the
        # sections' grids are then host arrays, also under forward mode
        stored = {id(value): self.emulator.fixed[name] for name, value in entry['fixed'].items()}
        strip = len(section) + 1
        return {name[strip:]: stored.get(id(value), value) for name, value in raw.items()}

    def __call__(self, section):
        entry = self.index.get(section, {'fixed': {}, 'static': [], 'with_z': []})
        raw = {name: self.emulator.engines[name].predict(self.x) for name in entry['static']}
        if not entry['with_z']:
            return self._finalize(entry, section, raw)

        def complete(**req):
            inputs = {**self.x, **req}
            full = dict(raw)
            for name in entry['with_z']:
                full[name] = self.emulator.engines[name].predict(inputs)
            return self._finalize(entry, section, full)

        return complete


_BACKGROUND_TABLES = ['rho_ncdm', 'p_ncdm', 'rho_fld', 'time', 'comoving_radial_distance', 'growth_factor',
                      'growth_rate']
_SPECIES_TABLES = ('rho_ncdm', 'p_ncdm')


@register_section
class Background(BaseBackground):
    """Background quantities from emulated tables, splined over the default
    background z-grid: batch + z.shape ((N_ncdm,) + batch + z.shape for the
    ncdm tables)."""

    def __init__(self, engine):
        super().__init__(engine)
        state = engine._predict(section='background')
        if not any(name != 'z' for name in state):
            # hybrid mode: the emulator file carries no background nets, so
            # serve the ODE-computed default background through the same
            # table interface
            state = Background.__getstate__(DefaultBackground(engine))
        self.__setstate__(state)

    def _table(self, name, z):
        """The spline ``name`` at ``z`` (1D): batch + z.shape, or
        (N_ncdm,) + batch + z.shape for a species table."""
        out = self._state[name](z)                  # z + batch (+ (N_ncdm,))
        if name in _SPECIES_TABLES:
            return out.movedim(-1, 0).movedim(1, -1)
        return out.movedim(0, -1)

    @flatarray()
    def rho_ncdm(self, z, species=None):
        out = self._table('rho_ncdm', z)
        return out[species if species is not None else slice(None)]

    @flatarray()
    def p_ncdm(self, z, species=None):
        out = self._table('p_ncdm', z)
        return out[species if species is not None else slice(None)]

    @flatarray()
    def rho_fld(self, z):
        return self._table('rho_fld', z)

    @flatarray()
    def time(self, z):
        return self._table('time', z)

    @flatarray()
    def comoving_radial_distance(self, z):
        return self._table('comoving_radial_distance', z)

    @flatarray()
    def growth_factor(self, z, znorm=None):
        growthz = self._table('growth_factor', z)
        if znorm is not None:
            return (1.0 + znorm) * growthz
        return growthz / self._table('growth_factor', z.new_zeros(1))[..., :1]

    @flatarray()
    def growth_rate(self, z):
        return self._table('growth_rate', z)

    def __getstate__(self):
        """The tables on the default background z-grid, each batch + its
        shape ((N_ncdm, nz) for the ncdm tables), and that grid as 'z'
        (numpy, shared by the batch, as the Fourier state's grids)."""
        state = {'z': get_default_z_callable('background')}
        z = torch.from_numpy(state['z']).to(self.device)
        for name in _BACKGROUND_TABLES:
            try:
                value = getattr(self, name)(z)
            except (AttributeError, NotImplementedError, CosmologyError):
                continue
            state[name] = value.movedim(0, -2) if name in _SPECIES_TABLES else value
        return state

    def __setstate__(self, state):
        state = dict(state)
        z = state.pop('z')
        self._state = {}
        for name, value in state.items():
            value = _batched(value, self.h.shape, 2 if name in _SPECIES_TABLES else 1, self.device)
            self._state[name] = Interpolator1D(z, value.movedim(-1, 0), assume_sorted=True)


@register_section
@utils.addproperty('rs_drag', 'z_drag', 'rs_star', 'z_star', 'YHe')
class Thermodynamics(BaseSection):
    """Thermodynamics scalars from the emulator (the batch shape)."""

    def __init__(self, engine):
        super().__init__(engine)
        self.__setstate__(engine._predict(section='thermodynamics'))

    def __getstate__(self):
        """The scalars this section has, each the batch shape: those it
        holds as '_<name>' (the analytic engines) or defines as properties
        (the native engine computes them from its recombination history)."""
        return {name: getattr(self, name) for name in ['rs_drag', 'z_drag', 'rs_star', 'z_star', 'YHe']
                if hasattr(self, '_' + name) or isinstance(getattr(type(self), name, None), property)}

    def __setstate__(self, state):
        batch = self.engine['h'].shape
        for name in ['rs_drag', 'z_drag', 'rs_star', 'z_star', 'YHe']:
            setattr(self, '_' + name, _batched(state[name], batch, 0, self.device) if name in state else None)


@register_section
@utils.addproperty('k_pivot', 'n_s', 'alpha_s', 'beta_s')
class Primordial(BaseSection):
    """Primordial spectrum with emulated A_s."""

    def __init__(self, engine):
        super().__init__(engine)
        self.__setstate__(engine._predict(section='primordial'))
        for name in ['h', 'n_s', 'alpha_s', 'beta_s']:
            setattr(self, '_' + name, engine[name])
        self._k_pivot = engine['k_pivot'] / self._h
        self._rsigma8 = engine._rescale_sigma8()

    @property
    def A_s(self):
        return self._state['A_s'] * self._rsigma8 ** 2

    @property
    def ln_1e10_A_s(self):
        return torch.log(1e10 * self.A_s)

    @flatarray()
    def pk_k(self, k, mode='scalar'):
        """Primordial curvature spectrum in (Mpc/h)^3 at ``k`` (h/Mpc):
        batch + k.shape."""
        k_pivot = self.k_pivot[..., None]
        lnkkp = torch.log(k / k_pivot)
        return self._h[..., None] ** 3 * self.A_s[..., None] * (k / k_pivot) ** (
            self.n_s[..., None] - 1.0 + 0.5 * self.alpha_s[..., None] * lnkkp
            + self.beta_s[..., None] * lnkkp ** 2 / 6.0)

    def pk_interpolator(self, mode='scalar'):
        return PowerSpectrumInterpolator1D.from_callable(pk_callable=lambda k: self.pk_k(k, mode=mode),
                                                         device=self.device)

    def __getstate__(self):
        return {'A_s': self.A_s}

    def __setstate__(self, state):
        self._state = dict(state)


@register_section
class Harmonic(BaseSection):
    """CMB angular power spectra from the emulator: Cl tables of
    batch + (ellmax + 1,)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._rsigma8 = engine._rescale_sigma8()
        self.__setstate__(engine._predict(section='harmonic'))
        self.ellmax_cl = engine['ellmax_cl']

    def _cls(self, name, ellmax):
        if ellmax < 0:
            ellmax = self.ellmax_cl + 1 + ellmax
        return cl_table({key: value[..., :ellmax + 1] for key, value in self._state[name].items()})

    def unlensed_cl(self, ellmax=-1):
        return self._cls('unlensed_cl', ellmax)

    def lens_potential_cl(self, ellmax=-1):
        return self._cls('lens_potential_cl', ellmax)

    def lensed_cl(self, ellmax=-1):
        return self._cls('lensed_cl', ellmax)

    def __getstate__(self):
        state = {}
        for name in ['unlensed_cl', 'lens_potential_cl', 'lensed_cl']:
            try:
                table = getattr(self, name)()
            except Exception:
                continue
            for key in table.keys():
                if key != 'ell':
                    state[f'{name}.{key}'] = table[key]
        return state

    def __setstate__(self, state):
        self._state = {}
        tables = {}
        for keyname, value in state.items():
            name, key = keyname.split('.')
            tables.setdefault(name, {})[key] = value
        for name, value in tables.items():
            keys = list(value)
            table = cl_table()
            for key in keys:
                table[key] = _rescaled(_batched(value[key], self.engine['h'].shape, 1, self.device), self._rsigma8)
            table['ell'] = np.arange(np.shape(value[keys[0]])[-1])
            self._state[name] = table


def _of_tuple(of, size=2):
    if isinstance(of, str):
        of = (of,)
    of = list(of)
    of = of + [of[0]] * (size - len(of))
    return tuple(sorted(of))


@register_section
class Fourier(BaseSection):
    """Power spectrum tables from the emulator: batch + (nk, nz) on one
    (k, z) grid."""

    def __init__(self, engine):
        super().__init__(engine)
        self._h = engine['h']
        self._rsigma8 = engine._rescale_sigma8()
        state = engine._predict(section='fourier')
        # z-requiring nets give back a completion callable instead of tables
        self._callable = state if callable(state) else False
        if not self._callable:
            self.__setstate__(state)

    @property
    def sigma8_m(self):
        if not hasattr(self, '_sigma8_m'):
            self._sigma8_m = self.sigma8_z(0.0, of='delta_m')
        return self._sigma8_m

    def sigma_rz(self, r, z, of='delta_m', **kwargs):
        return self.pk_interpolator(non_linear=False, of=of, **kwargs).sigma_rz(r, z)

    def sigma8_z(self, z, of='delta_m'):
        return self.sigma_rz(8.0, z, of=of)

    def table(self, non_linear=False, of='delta_m'):
        of = _of_tuple(of)
        suffix = '_non_linear' if non_linear else ''
        return (self._state['k'], self._state['z' + suffix],
                _rescaled(self._state['pk' + suffix][of], self._rsigma8))

    def pk_interpolator(self, non_linear=False, of='delta_m', **kwargs):
        ka, za, pka = self.table(non_linear=non_linear, of=of)
        nk = np.shape(ka)[-1]
        return PowerSpectrumInterpolator2D(ka, za, pka.transpose(-1, -2) if pka.shape[-2] != nk else pka, **kwargs)

    def pk_kz(self, k, z, non_linear=False, of='delta_m'):
        return self.pk_interpolator(non_linear=non_linear, of=of)(k, z)

    def __getstate__(self):
        state = {'k': get_default_k_callable(), 'z': get_default_z_callable()}
        k, z = state['k'], state['z']
        ofs = ['delta_cb', 'delta_m', 'theta_cb', 'theta_m']
        done = set()
        for of1 in ofs:
            for of2 in ofs:
                of = tuple(sorted((of1, of2)))
                if of in done:
                    continue
                done.add(of)
                try:
                    state['pk.{}.{}'.format(*of)] = self.pk_interpolator(non_linear=False, of=of)(k, z)
                except Exception:
                    pass
        # non-linear tables only when the source cosmology requested them
        if getattr(self, '_non_linear', ''):
            znl = get_default_z_callable(non_linear=True)
            try:
                state['pk_non_linear.delta_m.delta_m'] = self.pk_interpolator(non_linear=True, of='delta_m')(k, znl)
                state['z_non_linear'] = znl
            except Exception:
                pass
        return state

    def __setstate__(self, state):
        self._state = {}
        for keyname, value in state.items():
            if keyname.startswith('pk'):
                name, *keys = keyname.split('.')
                self._state.setdefault(name, {})
                self._state[name][tuple(keys)] = _batched(value, self.engine['h'].shape, 2, self.device)
            else:
                self._state[keyname] = value


def get_train_dir():
    """Directory holding pretrained emulator files: COSMOPRIMO_EMULATOR_DIR
    if set, else ~/.cosmoprimo/emulators (nothing is downloaded)."""
    return os.getenv('COSMOPRIMO_EMULATOR_DIR',
                     os.path.join(os.path.expanduser('~'), '.cosmoprimo', 'emulators'))


@register_engine
class CAPSEEngine(EmulatedEngine):
    """Capse.jl pretrained Cl emulator (arXiv:2307.14339); requires the
    converted emulator file locally."""

    name = 'capse'
    path = os.path.join(get_train_dir(), 'capse', 'emulator.npy')


@register_engine
class CosmopowerBolliet2023Engine(EmulatedEngine):
    """cosmopower pretrained emulator (Bolliet et al. 2023); requires the
    converted emulator file locally."""

    name = 'cosmopower_bolliet2023'
    path = os.path.join(get_train_dir(), 'cosmopower_bolliet2023', 'emulator.npy')


@register_engine
class CambMnuW0WaCMBEngine(EmulatedEngine):
    """Pretrained CAMB base_mnu_w_wa thermodynamics + CMB Cl emulator
    (name ``emu_camb_mnu_w_wa_cmb``); requires the converted emulator file
    locally."""

    name = 'emu_camb_mnu_w_wa_cmb'
    path = os.path.join(get_train_dir(), 'camb_base_mnu_w_wa', 'emulator.npy')


@register_engine
class CosmopowerJense2024Engine(EmulatedEngine):
    """cosmopower pretrained emulator (Jense et al. 2024, the
    cosmopower_jense2024_* release family). Serve from a locally provided
    source, either a converted emulator file at
    ``$COSMOPRIMO_EMULATOR_DIR/cosmopower_jense2024/emulator.npy``, or the
    raw release directory (networks/*.npz), converted once with
    ``convert_cosmopower_release_to_cosmoprimo`` (emulators/conversion.py)
    and written to that path."""

    name = 'cosmopower_jense2024'
    path = os.path.join(get_train_dir(), 'cosmopower_jense2024', 'emulator.npy')
