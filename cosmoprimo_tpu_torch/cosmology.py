"""Cosmological parameter system, engine front-end and background
(cosmoprimo_tpu/cosmology.py): parameters, engines, ``Cosmology.solve``, the
state and its files, the sections' base classes and the default background.

Batch-first: every numeric parameter is a float64 tensor of one common batch
shape, () for one cosmology or (B,) for B of them, on one device. The
massive-neutrino species parameters ``m_ncdm`` and ``T_ncdm_over_cmb`` are
(N_ncdm,) + batch: one row per species, then the batch. Functions of
redshift return batch shape + z.shape (species first where there is a
species axis), the layout of the JAX package's vmapped output. Invalid
values make their rows NaN and never raise, so no check waits on the device.

Entry points run on the card: a cosmology is built on ``device`` if given,
else on the device of its tensor parameters, else on CUDA. Without a card,
a build that names no device raises; ``device='cpu'`` runs on the CPU.
"""

import functools
import sys
import warnings

import numpy as np
import torch

from . import constants, utils
from .ops import (Interpolator1D, batch_scalar, cumquad_rk4, exception_or_nan, flatarray, gauss_laguerre_nodes,
                  linear_ode2_rk4_prefix, romberg)
from .ops.roots import bisect, bracket, for_cond_loop

_Sections = ['Background', 'Thermodynamics', 'Primordial', 'Perturbations', 'Transfer', 'Harmonic', 'Fourier']


class CosmologyError(Exception):
    """Exception raised by :class:`Cosmology`."""


class CosmologyInputError(CosmologyError):
    """Error in the value of input parameters."""


class CosmologyComputationError(CosmologyError):
    """Error during a cosmology computation."""


# ----------------------------------------------------------------------------
# Neutrino phase-space integrals
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _laguerre_tensors(device):
    """The 100 Gauss-Laguerre nodes and weights on ``device``, copied once."""
    return tuple(torch.from_numpy(a).to(device) for a in gauss_laguerre_nodes(100))


def compute_ncdm_momenta(T_eff, m, z, out='rho'):
    r"""Energy density, pressure or d(rho)/dm of one massive-neutrino species
    by 100-point Gauss-Laguerre integration of the frozen Fermi-Dirac
    distribution, in :math:`10^{10} M_\odot / \mathrm{Mpc}^3` (per eV for
    'drhodm'). ``T_eff`` and ``m`` are tensors of the batch shape; the result
    is batch + z.shape."""
    z = torch.as_tensor(z, dtype=torch.float64, device=m.device)
    shape = z.shape
    a = 1.0 / (1.0 + z.reshape(-1))
    T_a = T_eff[..., None] / a
    over_T = constants.electronvolt_over_joule / (constants.Boltzmann * T_a)
    m2_T2 = (m[..., None] * over_T) ** 2
    m_T2 = m[..., None] * over_T ** 2
    q, w = _laguerre_tensors(m.device)
    q2 = q ** 2
    eps = torch.sqrt(q2 + m2_T2[..., None])
    # Laguerre absorbs e^{-q}: the integrand carries the 1/(1 + e^{-q}) remainder
    fd = 1.0 / (1.0 + torch.exp(-q))
    if out == 'rho':
        integ = q2 * eps * fd
    elif out == 'drhodm':
        integ = m_T2[..., None] * q2 / eps * fd
    elif out == 'p':
        integ = (1.0 / 3.0) * q ** 4 / eps * fd
    else:
        raise ValueError(f"out must be in ['rho', 'drhodm', 'p'], got {out}")
    val = torch.sum(integ * w, dim=-1)
    # Fermi-Dirac normalization and unit conversion to 1e10 Msun / Mpc^3
    val = (7.0 / 8.0 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann * T_a ** 4 * val
           / (7.0 * np.pi ** 4 / 120.0) / (1e10 * constants.msun_over_kg) * constants.megaparsec_over_m ** 3)
    return val.reshape(val.shape[:-1] + shape)


def _get_ncdm(params, z=0.0, species=None, out='rho'):
    """Comoving ncdm density or pressure in 1e10 Msun/h / (Mpc/h)^3 from the
    tensors h, T_cmb (batch), T_ncdm_over_cmb and m_ncdm ((N_ncdm,) + batch):
    (N_ncdm,) + batch + z.shape for ``species`` None or a list, batch +
    z.shape for one species."""
    T, m = params['T_ncdm_over_cmb'], params['m_ncdm']
    z = torch.as_tensor(z, dtype=torch.float64, device=m.device)
    h2 = params['h'] ** 2
    h2 = h2[(...,) + (None,) * z.dim()]

    def compute(s):
        return compute_ncdm_momenta(params['T_cmb'] * T[s], m[s], z=z, out=out) / (1 + z) ** 3 / h2

    if species is None:
        species = list(range(m.shape[0]))
    if isinstance(species, (list, tuple)):
        if not len(species):
            batch = torch.broadcast_shapes(h2.shape[:h2.dim() - z.dim()], m.shape[1:])
            return m.new_zeros((0,) + batch + z.shape)
        return torch.stack([compute(s) for s in species])
    return compute(species)


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


def _infer_device(params, device=None):
    """The device a cosmology is built on: ``device`` if given, else that
    of the first tensor among ``params`` (values, or species lists of
    values), else CUDA. Without a card and with no device named, raise:
    an entry point never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    for value in params.values():
        for item in (value if isinstance(value, (list, tuple)) else [value]):
            if isinstance(item, torch.Tensor):
                return item.device
    if not torch.cuda.is_available():
        raise CosmologyError("no CUDA device: the port runs on the card by default; pass device='cpu' to run on "
                             'the CPU')
    return torch.device('cuda')


def _asfloat(value, device):
    """``value`` as a float64 tensor on ``device``. A Python or numpy scalar
    is filled in on the device: a copy from host memory would wait for all
    the work already queued there."""
    if not isinstance(value, torch.Tensor) and np.ndim(value) == 0:
        return torch.full((), float(value), dtype=torch.float64, device=device)
    if isinstance(value, np.ndarray):
        value = value.copy()  # may be read-only; torch would share its memory
    return torch.as_tensor(value, dtype=torch.float64, device=device)


def _species(value):
    """(entries, single): a list, tuple or numpy array holds one entry per
    species; a scalar or a tensor (of the batch shape) is one species."""
    if value is None:
        return [], False
    if isinstance(value, (list, tuple)) or (isinstance(value, np.ndarray) and value.ndim):
        return list(value), False
    return [value], True


def _stack_species(values, device):
    """Per-species values (scalars or batch tensors) as one (N_ncdm,) +
    batch tensor."""
    if not len(values):
        return torch.zeros(0, dtype=torch.float64, device=device)
    return torch.stack(torch.broadcast_tensors(*[_asfloat(v, device) for v in values]))


def _to_batch(params, device):
    """Make every numeric parameter a float64 tensor on ``device``, and
    broadcast the per-cosmology ones to their common batch shape (after the
    species axis for ``m_ncdm`` and ``T_ncdm_over_cmb``)."""
    batch, species = {}, {}
    for name, value in params.items():
        if name in _SPECIES_PARAMS:
            species[name] = _asfloat(value, device)
        elif not (name in _STATIC_PARAMS or value is None or isinstance(value, (str, bool, list, tuple))):
            batch[name] = _asfloat(value, device)
    shape = torch.broadcast_shapes(*(value.shape for value in batch.values()),
                                   *(value.shape[1:] for value in species.values()))
    params.update({name: value.expand(shape) for name, value in batch.items()})
    for name, value in species.items():
        value = value.reshape(value.shape[:1] + (1,) * (len(shape) + 1 - value.dim()) + value.shape[1:])
        params[name] = value.expand(value.shape[:1] + shape)
    return params


def _invert_mass(omega, T_eff):
    """Newton inversion omega_ncdm -> m (eV) of one species, per row, to
    |omega - omega(m)| <= 1e-15 or 1000 steps, as the JAX package's loop."""
    omega, T_eff = torch.broadcast_tensors(omega, T_eff)

    def omega_of(m, out='rho'):
        return compute_ncdm_momenta(T_eff, m, z=0.0, out=out) / constants.rho_crit_over_Msunph_per_Mpcph3

    def body(i, state):
        m, check = state
        m = m + (omega - check) / omega_of(m, out='drhodm')
        return m, omega_of(m)

    def cond(i, state):
        return torch.abs(omega - state[1]) > 1e-15

    m_init = omega * 93.14
    m, _ = for_cond_loop(0, 1000, cond, body, (m_init, omega_of(m_init)))
    return m


def _split_hierarchy(total, masses, dm21, dm31):
    """Newton split of the mass sum ``total`` into three masses with the
    squared splittings dm21 and dm31, per row, from ``masses``."""
    def body(i, state):
        m0, m1, m2, s = state
        m0 = m0 + (total - s) / (1.0 + m0 / m1 + m0 / m2)
        m1 = torch.sqrt(m0 ** 2 + dm21)
        m2 = torch.sqrt(m0 ** 2 + dm31)
        return m0, m1, m2, m0 + m1 + m2

    def cond(i, state):
        return torch.abs(total - state[3]) > 1e-15

    masses = [torch.full_like(total, m) for m in masses]
    return list(for_cond_loop(0, 1000, cond, body, (*masses, masses[0] + masses[1] + masses[2]))[:3])


def _compute_rs_cosmomc(omega_b, omega_m, hubble_function_rows):
    """Sound horizon (proper Mpc) and z_star in the CosmoMC fitting-formula
    approximation, per row: ``hubble_function_rows`` maps batch + (m,)
    redshifts to H in km/s/Mpc."""
    zstar = 1048 * (1 + 0.00124 * omega_b ** (-0.738)) \
        * (1 + (0.0783 * omega_b ** (-0.238) / (1 + 39.5 * omega_b ** 0.763))
           * omega_m ** (0.560 / (1 + 21.1 * omega_b ** 1.81)))
    astar = 1.0 / (1 + zstar)

    def dsoundda(a):
        dtauda = 1.0 / (a ** 2 * hubble_function_rows(1 / a - 1.0) / (constants.c / 1e3))
        R = 3e4 * a * omega_b[..., None]
        return dtauda * (3 * (1 + R)) ** (-0.5)

    return romberg(dsoundda, 1e-8, astar, divmax=15, epsabs=1e-7, epsrel=1e-7), zstar


def compile_params(args, engine=None, device=None):
    """Normalize input parameters to the internal basis: H0->h, omega->Omega,
    logA->A_s, Omega_g->T_cmb; resolve the neutrino sector (the Omega_ncdm
    -> mass Newton inversion, the hierarchy split, N_ur from N_eff); apply
    positivity and dark-energy validation, poisoning the offending rows
    with NaN.

    Pure function: dict in, dict out (numeric values as batch tensors on
    ``device``, see :func:`_infer_device`).
    """
    params = dict(args)
    device = _infer_device(params, device)
    check_ignore = getattr(engine, '_check_ignore', ()) if engine is not None else ()

    def asfloat(value):
        return _asfloat(value, device)

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
            value = params.pop(name)
            entries, single = _species(value) if name == 'omega_ncdm' else ([value], True)
            value = [asfloat(v) / h ** 2 for v in entries]
            value = value[0] if single else value
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

    # ---------------- neutrino sector ----------------
    T_ncdm_over_cmb = params.pop('T_ncdm_over_cmb', None)

    def prepare_T(T, n):
        if T is None:
            T = constants.TNCDM_OVER_CMB
        if isinstance(T, torch.Tensor) or (not isinstance(T, (list, tuple)) and np.ndim(T) == 0):
            T = [T] * n
        T = list(T)
        if n and not len(T):
            T = [constants.TNCDM_OVER_CMB]
        if len(T) != n:
            raise TypeError(f'T_ncdm_over_cmb and m_ncdm must have the same length, found {len(T)} != {n}')
        return T

    if 'm_ncdm' in params:
        m_ncdm, single = _species(params.pop('m_ncdm'))
    elif 'Omega_ncdm' in params:
        Omega_ncdm, single = _species(params.pop('Omega_ncdm'))
        T_ncdm_over_cmb = prepare_T(T_ncdm_over_cmb, len(Omega_ncdm))
        m_ncdm = []
        for Om, T in zip(Omega_ncdm, T_ncdm_over_cmb):
            Om = asfloat(Om)
            # a massless row takes a dummy target, so that its Newton steps stay finite
            omega = torch.where(Om == 0.0, 1e-3, Om * h ** 2)
            m_ncdm.append(torch.where(Om == 0.0, 0.0, _invert_mass(omega, params['T_cmb'] * asfloat(T))))
    else:
        m_ncdm, single = [], False
    T_ncdm_over_cmb = prepare_T(T_ncdm_over_cmb, len(m_ncdm))

    neutrino_hierarchy = params.pop('neutrino_hierarchy', None)
    if neutrino_hierarchy is not None:
        if not single:
            raise CosmologyInputError('neutrino_hierarchy requires a single m_ncdm (the mass sum)')
        sum_ncdm = asfloat(m_ncdm[0])
        if 'm_ncdm' not in check_ignore:
            sum_ncdm = exception_or_nan(sum_ncdm, sum_ncdm < 0.0, None)
        # squared mass splittings, arXiv:1907.12598
        dm21 = 7.39e-5
        if neutrino_hierarchy == 'normal':
            dm31 = 2.525e-3
            sum_ncdm = exception_or_nan(sum_ncdm, sum_ncdm ** 2 < dm21 + dm31, None)
            m_ncdm = _split_hierarchy(sum_ncdm, (0.0, dm21, dm31), dm21, dm31)
        elif neutrino_hierarchy == 'inverted':
            dm32 = -2.512e-3
            dm31 = dm32 + dm21
            sum_ncdm = exception_or_nan(sum_ncdm, sum_ncdm ** 2 < -dm31 - dm32, None)
            m_ncdm = _split_hierarchy(sum_ncdm, (np.sqrt(-dm31), np.sqrt(-dm32), 1e-5), dm21, dm31)
        elif neutrino_hierarchy == 'degenerate':
            m_ncdm = [sum_ncdm / 3.0] * 3
        else:
            raise CosmologyInputError(f'unknown neutrino hierarchy {neutrino_hierarchy}')
        T_ncdm_over_cmb = [T_ncdm_over_cmb[0]] * 3

    N_ur = params.pop('N_ur', None)
    if 'Omega_ur' in params:
        T_ur = params['T_cmb'] * (4.0 / 11.0) ** (1.0 / 3.0)
        rho = 7.0 / 8.0 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann * T_ur ** 4
        N_ur = params.pop('Omega_ur') / (rho / (h ** 2 * constants.rho_crit_over_kgph_per_mph3))
    # N_ncdm is static: every species is kept, even a massless one
    params['m_ncdm'] = _stack_species(m_ncdm, device)
    params['T_ncdm_over_cmb'] = _stack_species(T_ncdm_over_cmb, device)
    N_eff = params.pop('N_eff', constants.NEFF)
    if N_ur is None:
        N_ur = N_eff - torch.sum(params['T_ncdm_over_cmb'] ** 4 * (4.0 / 11.0) ** (-4.0 / 3.0), dim=0)
    params['N_ur'] = asfloat(N_ur)
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
        ncdm = {name: asfloat(params[name]) for name in ('h', 'T_cmb', 'm_ncdm', 'T_ncdm_over_cmb')}
        nonrel = (torch.sum(_get_ncdm(ncdm, z=0.0, out='rho'), dim=0)
                  - 3 * torch.sum(_get_ncdm(ncdm, z=0.0, out='p'), dim=0)) / constants.rho_crit_over_Msunph_per_Mpcph3
        params['Omega_cdm'] = params.pop('Omega_m') - params['Omega_b'] - nonrel

    for name, default in {'w0_fld': -1.0, 'wa_fld': 0.0, 'cs2_fld': 1.0}.items():
        params[name] = asfloat(params.get(name, default))

    # w0 + wa >= 1/3 violates early radiation domination
    value = params['w0_fld'] + params['wa_fld']
    value = exception_or_nan(value, value >= 1.0 / 3.0, None)
    for name in ['w0_fld', 'wa_fld']:
        params[name] = torch.where(torch.isnan(value), torch.nan, params[name])

    params['use_ppf'] = bool(params.get('use_ppf', True))

    for basename in ['Omega_cdm', 'Omega_b', 'T_cmb', 'h', 'A_s', 'sigma8', 'm_ncdm', 'T_ncdm_over_cmb']:
        if basename in params and basename not in check_ignore:
            value = asfloat(params[basename])
            negative = value < 0.0
            if basename in _SPECIES_PARAMS:   # one negative species poisons its cosmology
                negative = negative.any(dim=0)
            params[basename] = exception_or_nan(value, negative, None)

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
            return params['T_ncdm_over_cmb'] * params['T_cmb']
        if name == 'Omega_ur':
            rho = params['N_ur'] * 7.0 / 8.0 * self.get('T_ur') ** 4 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
            return rho / (self.get('h') ** 2 * constants.rho_crit_over_kgph_per_mph3)
        if name == 'Omega_r':
            rho = (params['T_cmb'] ** 4 + params['N_ur'] * 7.0 / 8.0 * self.get('T_ur') ** 4) * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
            return rho / (self.get('h') ** 2 * constants.rho_crit_over_kgph_per_mph3) + self.get('Omega_pncdm_tot')
        if name == 'm_ncdm_tot':
            return torch.sum(params['m_ncdm'], dim=0)
        if name == 'Omega_ncdm':
            # one row per species, then the batch
            self._derived[name] = _get_ncdm(params, z=0.0, out='rho') / constants.rho_crit_over_Msunph_per_Mpcph3
            return self._derived[name]
        if name == 'Omega_pncdm':
            self._derived[name] = 3.0 * _get_ncdm(params, z=0.0, out='p') / constants.rho_crit_over_Msunph_per_Mpcph3
            return self._derived[name]
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
            return params['m_ncdm'].shape[0]
        if name == 'N_eff':
            return torch.sum(params['T_ncdm_over_cmb'] ** 4 * (4.0 / 11.0) ** (-4.0 / 3.0), dim=0) + params['N_ur']
        if name == 'theta_cosmomc':
            # the CosmoMC approximation, at each row's own z_star
            ba = self.get_background()
            rs, zstar = _compute_rs_cosmomc(self['omega_b'], self['omega_m'], ba.hubble_function_rows)
            self._derived[name] = rs * ba.h / ba.comoving_transverse_distance_rows(zstar[..., None])[..., 0]
            return self._derived[name]
        if name == 'theta_MC_100':
            return self.get('theta_cosmomc') * 100.0
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
    'eisenstein_hu_nowiggle': 'models.eisenstein_hu_nowiggle',
    'eisenstein_hu_nowiggle_variants': 'models.eisenstein_hu_nowiggle_variants',
    'bbks': 'models.bbks',
    'tabulated': 'models.tabulated',
    'astropy': 'models.astropy',
    'native': 'models.native',
    'class': 'models.classy',
    'classy': 'models.classy',
    'axiclass': 'models.classy',
    'axiclassy': 'models.classy',
    'mochiclass': 'models.classy',
    'mochiclassy': 'models.classy',
    'negnuclass': 'models.classy',
    'negnuclassy': 'models.classy',
    'dsclass': 'models.classy',
    'dsclassy': 'models.classy',
    'camb': 'models.camb',
    'isitgr': 'models.camb',
    'mgcamb': 'models.camb',
    'isitide': 'models.camb',
    'heftcamb': 'models.camb',
    'emulated': 'emulators.emulated',
    'capse': 'emulators.emulated',
    'cosmopower_bolliet2023': 'emulators.emulated',
    'emu_camb_mnu_w_wa_cmb': 'emulators.emulated',
    'cosmopower_jense2024': 'emulators.emulated',
}


def register_engine(cls):
    """Register an engine class. Section classes are discovered from the
    engine's module by name on first access."""
    _ENGINE_REGISTRY[cls.name] = cls
    return cls


def register_section(cls):
    """Mark a section class; the JAX package registers it as a pytree, the
    port needs nothing, so a module written for either runs here."""
    return cls


def _deepeq(obj1, obj2):
    """Equality of nested dicts, lists and arrays, tensors and numpy arrays
    comparing by value (a file round trip turns one into the other)."""
    arraylike = (np.ndarray, torch.Tensor)
    if isinstance(obj1, arraylike) and isinstance(obj2, arraylike):
        obj1 = torch.as_tensor(obj1)
        obj2 = torch.as_tensor(obj2).to(device=obj1.device, dtype=obj1.dtype)
        return torch.equal(obj1, obj2)
    if type(obj2) is type(obj1):
        if isinstance(obj1, dict):
            return obj2.keys() == obj1.keys() and all(_deepeq(obj1[k], obj2[k]) for k in obj1)
        if isinstance(obj1, (tuple, list)):
            return len(obj2) == len(obj1) and all(_deepeq(a, b) for a, b in zip(obj1, obj2))
        return obj2 == obj1
    return False


def _to_numpy(value):
    """``value`` with every tensor, also inside dicts, lists and tuples, as
    a numpy array on the host: the state format of the JAX package."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {name: _to_numpy(item) for name, item in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_numpy(item) for item in value)
    return value


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
        # engine-specific overrides (a variant engine swapping one section
        # while sharing its module's others)
        for name, Section in getattr(cls, '_section_overrides', {}).items():
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

    def __eq__(self, other):
        return type(other) == type(self) and _deepeq(other._params, self._params) and other._extra_params == self._extra_params

    def __hash__(self):
        return object.__hash__(self)


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
    broadcast to one batch shape, as float64 tensors on ``device``: by
    default the device of the first tensor given, else the CUDA card (see
    :func:`_infer_device`; ``device='cpu'`` runs on the CPU).
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
    def get_default_params(cls, of=None, include_conflicts=True):
        if of is None:
            out = cls.get_default_params(of='cosmology', include_conflicts=include_conflicts)
            out.update(cls.get_default_params(of='calculation', include_conflicts=include_conflicts))
            return out
        if of == 'cosmology':
            out = dict(DEFAULT_COSMOLOGICAL_PARAMETERS)
        elif of == 'calculation':
            out = dict(DEFAULT_CALCULATION_PARAMETERS)
        else:
            raise CosmologyInputError(f'No default parameters for {of}')
        if include_conflicts:
            for name in list(out):
                for conf in find_conflicts(name):
                    out[conf] = out[name]
        return out

    def get_params(self, of='base'):
        if of == 'derived':
            return dict(self._derived)
        if of == 'extra':
            return dict(self._extra_params)
        toret = dict(self._params)
        if of == 'base':
            return toret
        if of == 'input':
            return dict(self._input_params)
        if of in ('cosmology', 'calculation'):
            defaults = self.get_default_params(of=of)
            return {name: toret.get(name, value) for name, value in defaults.items()}
        if of == 'all':
            toret.update(self.get_params(of='derived'))
            toret.update(self.get_params(of='extra'))
            return toret
        raise CosmologyInputError(f'No parameters for {of}')

    def clone(self, base='input', engine=None, extra_params=None, **params):
        """A copy with updated parameters (and possibly engine), on this
        cosmology's device. ``base='input'`` updates the user-facing input
        basis; 'internal' updates the compiled h/Omega/m_ncdm basis."""
        check_params(params)
        if base == 'input':
            base_params = dict(self._input_params)
        elif base in ('internal', None):
            base_params = dict(self._params)
            for name in _SPECIES_PARAMS:   # the compiled (N_ncdm,) + batch tensors, one entry per species
                base_params[name] = list(base_params[name])
        else:
            raise CosmologyInputError(f'Unknown parameter base {base}')
        new = self.__class__.__new__(self.__class__)
        new._derived = {}
        new._engine = None
        new._extra_params = {}
        new._input_params = merge_params(base_params, params)
        if engine is None and self._engine is not None:
            engine = self._engine.__class__
        engine_cls = get_engine(engine) if engine is not None else None
        new._params = compile_params(new._input_params, engine=engine_cls, device=self.device)
        if engine_cls is not None:
            if extra_params is None:
                if engine_cls.name == getattr(self._engine, 'name', None):
                    extra_params = getattr(self._engine, '_extra_params', {})
                else:
                    extra_params = {}
            new.set_engine(engine_cls, **extra_params)
        return new

    def solve(self, param, func, target=0.0, limits=None, init=None, xtol=None, maxiter=25):
        """A clone where ``func(cosmo) == target``, varying the input
        parameter ``param``, per row.

        ``func`` is a callable cosmo -> value (of the batch shape) or the
        name of a derived parameter ('theta_MC_100' takes the CLASS guess of
        h or H0 from the target); ``target`` is a float or a tensor of the
        batch shape. Explicit ``limits`` = (lo, hi) skip the bracket search;
        otherwise ``init`` (by default the current value) and a first step
        scaled by the secant slope start it (:func:`ops.roots.bracket`).
        The root is then found by Ridders' method to ``xtol``
        (:func:`ops.roots.bisect`); a row without a sign change is NaN."""
        default_step = {'h': 0.01, 'H0': 1.0}
        default_tol = {'h': 1e-6, 'H0': 1e-4}
        if isinstance(target, (torch.Tensor, np.ndarray)):
            target = _asfloat(target, self.device)

        if isinstance(func, str):
            name = func

            def func(cosmo):
                return cosmo[name]

            if name == 'theta_MC_100' and init is None and limits is None and param in ('h', 'H0'):
                # CLASS's initial guess of h from 100 theta_MC (class_public fit)
                h_guess = 3.54 * target ** 2 - 5.455 * target + 2.548
                init = h_guess if param == 'h' else 100.0 * h_guess
        if not callable(func):
            raise CosmologyInputError(f'func must be a callable cosmo -> value or a derived-parameter name, got {func!r}')

        def f(value):
            return func(self.clone(base='input', **{param: value})) - target

        if xtol is None:
            xtol = default_tol.get(param, 1e-6)
        if limits is None:
            if init is None:
                init = self[param]
            if not isinstance(init, (tuple, list)):   # else (x0, dx) or (x0, dx, f0)
                x0 = init
                dx0 = default_step.get(param, None)
                if dx0 is None:
                    dx0 = 0.05 * torch.abs(_asfloat(x0, self.device))
                    dx0 = torch.where(dx0 == 0, 0.05, dx0)
                # the secant slope scales the first step of the bracket search
                f0 = f(x0)
                df = f(x0 + dx0) - f0
                init = (x0, torch.where(df == 0, dx0, f0 * dx0 / df), f0)
            limits = bracket(f, init=init, maxiter=maxiter)
        value = bisect(f, limits=tuple(limits), xtol=xtol, maxiter=maxiter)
        return self.clone(base='input', **{param: value})

    # ---- the state and files, in the JAX package's format
    def __getstate__(self):
        """The parameters ('params', 'input_params', 'derived') as dicts of
        numpy arrays and Python values, and the engine's name and extra
        parameters: the dict of ``cosmoprimo_tpu.Cosmology.__getstate__``."""
        state = {name: _to_numpy(getattr(self, '_' + name)) for name in ('params', 'input_params', 'derived')}
        state['engine'] = None
        if self._engine is not None:
            state['engine'] = {'name': self._engine.name, 'extra_params': _to_numpy(self._engine._extra_params)}
        return state

    def __setstate__(self, state):
        self._setstate(state, None)

    def _setstate(self, state, device):
        params = dict(state['params'])
        device = _infer_device(params, device)
        self._params = _to_batch(params, device)
        self._input_params = dict(state.get('input_params', {}))
        self._derived = {name: _asfloat(value, device) for name, value in state.get('derived', {}).items()}
        self._extra_params = {}
        self._engine = None
        if state.get('engine', None) is not None:
            self.set_engine(state['engine']['name'], **state['engine']['extra_params'])

    @classmethod
    def from_state(cls, state, device=None):
        """Build from a state of either package (:meth:`__getstate__`) on
        ``device`` (by default that of its tensors, else the CUDA card),
        with its compiled parameters taken as they are."""
        new = cls.__new__(cls)
        new._setstate(state, device)
        return new

    @classmethod
    def read(cls, filename, device=None):
        """Read a cosmology that :meth:`write` (of either package) wrote:
        '.json', else '.npy'."""
        return cls.from_state(utils.read_state(filename), device=device)

    def write(self, filename):
        """Write the state to ``filename``: JSON if it ends in '.json', else
        ``np.save``; the JAX package reads both."""
        utils.write_state(filename, self.__getstate__())

    @classmethod
    def load(cls, filename, device=None):
        """Deprecated. Use :meth:`read`."""
        warnings.warn('load() is deprecated, use read() instead.', DeprecationWarning, stacklevel=2)
        return cls.read(filename, device=device)

    def save(self, filename):
        """Deprecated. Use :meth:`write`."""
        warnings.warn('save() is deprecated, use write() instead.', DeprecationWarning, stacklevel=2)
        return self.write(filename)

    @classmethod
    def get_default_parameters(cls, *args, **kwargs):
        """Deprecated. Use :meth:`get_default_params`."""
        warnings.warn('get_default_parameters is deprecated, use get_default_params', DeprecationWarning, stacklevel=2)
        return cls.get_default_params(*args, **kwargs)

    def copy(self):
        """A shallow copy: the engine and the parameter dicts are shared."""
        new = self.__class__.__new__(self.__class__)
        new.__dict__.update(self.__dict__)
        return new

    # the state names no device: copies keep this cosmology's
    __copy__ = copy

    def __deepcopy__(self, memo):
        return self.from_state(self.__getstate__(), device=self.device)

    def __eq__(self, other):
        return type(other) == type(self) and _deepeq(other._params, self._params) and other._engine == self._engine

    def __hash__(self):
        return object.__hash__(self)

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
    def _ncdm_params(self):
        return {'h': self._h, 'T_cmb': self._T0_cmb, 'T_ncdm_over_cmb': self._T0_ncdm / self._T0_cmb,
                'm_ncdm': self._m_ncdm}

    @flatarray()
    def rho_ncdm(self, z, species=None):
        """Comoving density of the massive neutrinos: (N_ncdm,) + batch +
        z.shape, or batch + z.shape for one ``species``."""
        return _get_ncdm(self._ncdm_params(), z=z, species=species, out='rho')

    def rho_ncdm_tot(self, z):
        return torch.sum(self.rho_ncdm(z, species=None), dim=0)

    @flatarray()
    def p_ncdm(self, z, species=None):
        return _get_ncdm(self._ncdm_params(), z=z, species=species, out='p')

    def p_ncdm_tot(self, z):
        return torch.sum(self.p_ncdm(z, species=None), dim=0)

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

    def _closed(self, name, z):
        """The closed-form density ``name`` at ``z`` of either layout: (n,),
        every row at every redshift, or batch + (n,), each row at its own;
        batch + (n,) out."""
        return getattr(BaseBackground, name).__wrapped__(self, z)

    def _rho_tot(self, z, rho_ncdm_tot):
        """The sum of the background's content at ``z`` (either layout of
        :meth:`_closed`), the massive neutrinos' ``rho_ncdm_tot`` given in
        the layout of the result."""
        m = self._closed('rho_cdm', z) + self._closed('rho_b', z) + rho_ncdm_tot
        r = self._closed('rho_g', z) + self._closed('rho_ur', z)
        return m + r + self._closed('rho_de', z)

    def _efunc(self, z, rho_ncdm_tot):
        """E(z) from :meth:`_rho_tot` and the curvature, in the same layout."""
        rho_crit = self._rho_tot(z, rho_ncdm_tot) + self._closed('rho_k', z)
        return torch.sqrt(rho_crit * (1 + z) ** 3 / constants.rho_crit_over_Msunph_per_Mpcph3)

    @flatarray()
    def rho_tot(self, z):
        return self._rho_tot(z, self.rho_ncdm_tot(z))

    def rho_crit(self, z):
        return self.rho_tot(z) + self.rho_k(z)

    # ---- expansion
    @flatarray()
    def efunc(self, z):
        return self._efunc(z, self.rho_ncdm_tot(z))

    @flatarray()
    def hubble_function(self, z):
        return self.efunc(z) * self.H0[..., None]

    @flatarray()
    def T_cmb(self, z):
        return self.T0_cmb[..., None] * (1 + z)

    @flatarray()
    def T_ncdm(self, z, species=None):
        T0 = self.T0_ncdm if species is None else self.T0_ncdm[species]
        return T0[..., None] * (1 + z)

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

    def Omega_ncdm(self, z, species=None):
        return self.rho_ncdm(z, species=species) / self.rho_crit(z)

    def Omega_ncdm_tot(self, z):
        return self.rho_ncdm_tot(z) / self.rho_crit(z)

    def Omega_pncdm(self, z, species=None):
        return 3 * self.p_ncdm(z, species=species) / self.rho_crit(z)

    def Omega_pncdm_tot(self, z):
        return 3 * self.p_ncdm_tot(z) / self.rho_crit(z)

    def Omega_Lambda(self, z):
        return self.rho_Lambda(z) / self.rho_crit(z)

    def Omega_fld(self, z):
        return self.rho_fld(z) / self.rho_crit(z)

    def Omega_de(self, z):
        return self.rho_de(z) / self.rho_crit(z)

    # ---- distances
    def _curved(self, chi):
        """The curvature transverse function S_K of a comoving radial
        distance (batch + z.shape), K in (h/Mpc)^2, branchless."""
        K = self.K.reshape(self.K.shape + (1,) * (chi.dim() - self.K.dim()))
        sqrt_absK = torch.sqrt(torch.abs(K))
        safe = torch.where(sqrt_absK == 0, 1.0, sqrt_absK)
        closed = torch.sin(safe * chi) / safe
        open_ = torch.sinh(safe * chi) / safe
        return torch.where(K == 0, chi, torch.where(K > 0, closed, open_))

    @flatarray()
    def angular_diameter_distance(self, z):
        r"""Proper angular diameter distance, in Mpc/h (astro-ph/9905116 eq. 18)."""
        return self._curved(self.comoving_radial_distance(z)) / (1 + z)

    @flatarray(iargs=[0, 1])
    def angular_diameter_distance_2(self, z1, z2):
        r"""Angular diameter distance of z2 as seen from z1, in Mpc/h."""
        return self._curved(self.comoving_radial_distance(z2) - self.comoving_radial_distance(z1)) / (1 + z2)

    @flatarray()
    def comoving_transverse_distance(self, z):
        r"""Comoving transverse distance, in Mpc/h (astro-ph/9905116 eq. 16)."""
        return self.angular_diameter_distance(z) * (1.0 + z)

    comoving_angular_distance = comoving_transverse_distance

    @flatarray()
    def luminosity_distance(self, z):
        return self.angular_diameter_distance(z) * (1.0 + z) ** 2

    def rs(self, z):
        """Sound horizon at redshift ``z``, in Mpc/h (CAMB's dsoundda
        integrand, Romberg with 15 refinements): the batch shape. ``z`` is a
        scalar, or a tensor of the batch shape (one redshift per row, for a
        background with :meth:`hubble_function_rows`)."""
        rows = isinstance(z, torch.Tensor) and z.dim() > 0
        hubble = self.hubble_function_rows if rows else self.hubble_function

        def dsoundda(a):
            dtauda = 1.0 / (a ** 2 * hubble(1 / a - 1.0) / (constants.c / 1e3))
            R = 3 / 4.0 * a * (self.Omega0_b / self.Omega0_g)[..., None]
            return dtauda * (3 * (1 + R)) ** (-0.5)

        astar = 1.0 / (1 + z) if rows else 1.0 / (1 + float(z))
        return romberg(dsoundda, 1e-8, astar, divmax=15, epsabs=1e-7, epsrel=1e-7, device=self.device) * self.h

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
    """Background with interpolation tables for the expensive quantities
    (ncdm momenta, times, distances, growth), built on first access and
    cached on the section, on its device. Every table holds the whole batch:
    the knots first, then the species and the batch."""

    def __init__(self, engine):
        super().__init__(engine)
        self._cache = {}

    def _table(self, name, build):
        """The interpolator ``name`` of the cache, made by ``build()`` once."""
        if name not in self._cache:
            self._cache[name] = build()
        return self._cache[name]

    def _ncdm_interpolator(self, out):
        """The ncdm density ('rho') or pressure ('p') table: (N_ncdm,) + batch columns."""
        def build():
            zc = _z_interp_tensor(f'{out}_ncdm', self.device)
            fun = BaseBackground.rho_ncdm if out == 'rho' else BaseBackground.p_ncdm
            return Interpolator1D(zc, torch.movedim(fun(self, zc), -1, 0), extrap=True, assume_sorted=True)

        return self._table(f'{out}_ncdm', build)

    def _ncdm_table(self, out, z, species):
        if self.N_ncdm == 0:
            return z.new_zeros((0,) + self.h.shape + z.shape)
        out = torch.movedim(self._ncdm_interpolator(out)(z), 0, -1)
        return out if species is None else out[species]

    @flatarray()
    def rho_ncdm(self, z, species=None):
        return self._ncdm_table('rho', z, species)

    @flatarray()
    def p_ncdm(self, z, species=None):
        return self._ncdm_table('p', z, species)

    def _time_integral(self, name):
        """Cumulative c / ((1 + z) H(z)) on the 'time' z-grid: batch + (400,)."""
        zc = _z_interp_tensor(name, self.device)
        return zc, cumquad_rk4(lambda y, zz: constants.c / 1e3 / (1.0 + zz) / (100.0 * self.efunc(zz)), 0.0, zc)

    @flatarray()
    def time(self, z):
        r"""Proper time (age of the universe at z), in Gyr."""
        def build():
            zc, tmp = self._time_integral('time')
            tmp = (tmp[..., -1:] - tmp) / self.h[..., None] / constants.gigayear_over_megaparsec
            return Interpolator1D(zc, torch.movedim(tmp, -1, 0), assume_sorted=True)

        return torch.movedim(self._table('time', build)(z), 0, -1)

    @property
    def age(self):
        r"""Current age of the universe, in Gyr: the batch shape."""
        if 'age' not in self._cache:
            _, tmp = self._time_integral('age')
            self._cache['age'] = (tmp[..., -1] - tmp[..., 0]) / self.h / constants.gigayear_over_megaparsec
        return self._cache['age']

    def _distance_interpolator(self):
        def build():
            zc = _z_interp_tensor('comoving_radial_distance', self.device)
            tmp = cumquad_rk4(lambda y, zz: constants.c / 1e3 / (100.0 * self.efunc(zz)), 0.0, zc)
            return Interpolator1D(zc, torch.movedim(tmp, -1, 0), assume_sorted=True)

        return self._table('comoving_radial_distance', build)

    @flatarray()
    def comoving_radial_distance(self, z):
        r"""Comoving radial distance, in Mpc/h (astro-ph/9905116 eq. 15)."""
        return torch.movedim(self._distance_interpolator()(z), 0, -1)

    # ---- at redshifts that differ by row: ``z`` is batch + (m,), and so is
    # the result, row b at its own z[b] (the functions above evaluate every
    # row at every z)
    def efunc_rows(self, z):
        """E(z) = H(z)/H0 per row."""
        ncdm = z.new_zeros(z.shape)
        if self.N_ncdm:
            ncdm = torch.sum(self._ncdm_interpolator('rho').columns(z), dim=0)
        return self._efunc(z, ncdm)

    def hubble_function_rows(self, z):
        """H(z) per row, in km/s/Mpc."""
        return self.efunc_rows(z) * self.H0[..., None]

    def comoving_transverse_distance_rows(self, z):
        """Comoving transverse distance per row, in Mpc/h."""
        return self._curved(self._distance_interpolator().columns(z)) / (1 + z) * (1.0 + z)

    def _growth_tables(self, mass='m'):
        """Interpolators of D(z) and f(z) from the growth ODE
        D'' = 3/2 Omega_mass D + (-1 - a''/a) D' in eta = ln(a) on 201 steps
        from eta = -6, a linear system solved by
        :func:`ops.linear_ode2_rk4_prefix`."""
        name_factor, name_rate = f'growth_factor_{mass}', f'growth_rate_{mass}'
        if name_factor not in self._cache:
            if mass == 'm':
                Omega_mass = self.Omega_m
            elif mass == 'cb':
                def Omega_mass(z):
                    return self.Omega_cdm(z) + self.Omega_b(z)
            else:
                raise ValueError("mass must be one of ['m', 'cb']")

            def coeffs(eta):
                z = torch.exp(-eta) - 1.0
                w_fld = self.w0_fld[..., None] + z / (1.0 + z) * self.wa_fld[..., None]
                addot = -0.5 * (1.0 - self.Omega_k(z) + self.Omega_r(z) + 3 * w_fld * self.Omega_de(z))
                return 1.5 * Omega_mass(z), -1.0 - addot

            eta_np = np.linspace(-6.0, 0.0, 201)
            eta = torch.from_numpy(eta_np).to(self.device)
            zc = torch.from_numpy((np.exp(-eta_np) - 1.0)[::-1].copy()).to(self.device)
            D0 = float(np.exp(eta_np[0]))
            sol = linear_ode2_rk4_prefix(coeffs, [D0, D0], eta)          # batch + (201, 2)
            Dplus, Dplusp = sol[..., 0], sol[..., 1]
            self._cache[name_factor] = Interpolator1D(zc, torch.movedim(Dplus.flip(-1), -1, 0), assume_sorted=True)
            self._cache[name_rate] = Interpolator1D(zc, torch.movedim((Dplusp / Dplus).flip(-1), -1, 0),
                                                    assume_sorted=True)
        return self._cache[name_factor], self._cache[name_rate]

    @flatarray()
    def growth_factor(self, z, mass='m', znorm=None):
        r"""Linear growth factor D(z) from the growth ODE in ln(a) with
        w(z)-aware friction, normalized to D(0) = 1 (or to the matter-era
        (1 + znorm)/(1 + z) convention if ``znorm`` is given)."""
        factor, _ = self._growth_tables(mass=mass)
        growthz = torch.movedim(factor(z), 0, -1)
        if znorm is not None:   # a float, or one per row
            return batch_scalar(1.0 + znorm) * growthz
        return growthz / torch.movedim(factor(z.new_zeros(1)), 0, -1)

    @flatarray()
    def growth_rate(self, z, mass='m'):
        r"""Growth rate f(z) = dlnD/dlna."""
        _, rate = self._growth_tables(mass=mass)
        return torch.movedim(rate(z), 0, -1)
