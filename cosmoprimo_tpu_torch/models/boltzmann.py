"""Shared host-side Boltzmann machinery (cosmoprimo_tpu/models/boltzmann.py):
the parameter translations to CLASS and CAMB, the CAMB task graph and the
host-table redshift grid, all numpy, testable without the external codes.

The engines and their sections live in :mod:`.classy` (the CLASS family)
and :mod:`.camb` (the CAMB family); this module gives their classes by name
too. The external codes run one cosmology a call on the host:
:func:`host_params` refuses a batch and hands the translations plain
floats and numpy arrays.
"""

import numpy as np
import torch

from .. import constants
from ..cosmology import CosmologyInputError


def host_params(engine):
    """The engine's compiled parameters on the host: each tensor a float
    (one value) or a numpy array (the species). A batched cosmology raises:
    the external code computes one cosmology a call."""
    if engine.batch_shape != ():
        raise CosmologyInputError(
            f'engine {engine.name!r} wraps an external code that computes one cosmology a call; got a batch of shape '
            f'{tuple(engine.batch_shape)}: build one Cosmology a row')

    def host(value):
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
            return float(value) if value.ndim == 0 else value
        return value

    return {name: host(value) for name, value in engine._params.items()}


def device_table(value, device):
    """A host table (numpy, or anything numpy takes) as a float64 tensor on
    ``device``."""
    return torch.as_tensor(np.array(value, dtype=np.float64), device=device)


# ----------------------------------------------------------------------------
# Pure parameter translations
# ----------------------------------------------------------------------------

def translate_class_params(params, extra_params=None, A_s_fid=None, has_fld=False, N_ncdm=0):
    """Translate compiled cosmology parameters to CLASS input keys."""
    params = {**(extra_params or {}), **{k: v for k, v in params.items()}}
    lensing = params.pop('lensing')
    params['lensing'] = 'yes' if lensing else 'no'
    params['modes'] = ','.join(params['modes'])
    if 't' not in params['modes']:
        params.pop('r', None)
    params.setdefault('z_max_pk', float(np.max(params.pop('z_pk'))))
    params.setdefault('P_k_max_h/Mpc', params.pop('kmax_pk'))
    params.setdefault('l_max_scalars', params.pop('ellmax_cl'))
    non_linear = params.pop('non_linear', '')
    if non_linear:
        if non_linear in ('mead', 'hmcode'):
            params['non_linear'] = 'hmcode'
            params.setdefault('hmcode_min_k_max', params['P_k_max_h/Mpc'])
        elif non_linear == 'halofit':
            params['non_linear'] = 'halofit'
            params.setdefault('halofit_min_k_max', params['P_k_max_h/Mpc'])
        else:
            raise CosmologyInputError(f'Unknown non-linear code {non_linear}')
    else:
        if A_s_fid is not None:
            params['A_s'] = A_s_fid
        params.pop('sigma8', None)
    params['N_ncdm'] = N_ncdm
    params['T_ncdm'] = params.pop('T_ncdm_over_cmb')
    if not N_ncdm:
        params.pop('m_ncdm', None)
        params.pop('T_ncdm', None)
    params['use_ppf'] = 'yes' if params.get('use_ppf', True) else 'no'
    params.setdefault('fluid_equation_of_state', 'CLP')
    if has_fld:
        params['Omega_Lambda'] = 0.0  # forces a non-zero Omega_fld
    else:
        for name in ['w0_fld', 'wa_fld', 'cs2_fld', 'use_ppf', 'fluid_equation_of_state']:
            params.pop(name, None)
    if 't' not in params['modes']:
        params.pop('n_t', None)
        params.pop('alpha_t', None)
    if params.get('beta_s', 0.0):
        raise CosmologyInputError('class does not take beta_s')
    params.pop('beta_s', None)
    params.setdefault('k_per_decade_for_bao', 100)
    params.setdefault('k_per_decade_for_pk', 20)
    out = {}
    for name, value in params.items():
        if name != 'N_ncdm':
            try:
                value = float(value)
            except (TypeError, ValueError):
                pass
        out[name] = value
    return out


def translate_camb_params(params, extra_params=None, A_s_fid=None, has_fld=False, use_ppf=True, N_eff=None):
    """Translate compiled cosmology parameters to camb.set_params keys.
    Returns (set_params kwargs, post-settings dict applied to CAMBparams
    attributes)."""
    base = {k: v for k, v in params.items()}
    base['ombh2'] = base.pop('Omega_b') * base['h'] ** 2
    base['omch2'] = base.pop('Omega_cdm') * base['h'] ** 2
    base['H0'] = 100.0 * base.pop('h')
    for name, rename in {'tau_reio': 'tau', 'z_reio': 'zrei', 'Omega_k': 'omk', 'T_cmb': 'TCMB',
                         'A_L': 'Alens', 'n_s': 'ns', 'alpha_s': 'nrun', 'beta_s': 'nrunrun',
                         'r': 'r', 'n_t': 'nt', 'alpha_t': 'ntrun'}.items():
        if name in base:
            base[rename] = base.pop(name)
    if base.get('YHe', None) == 'BBN':
        base['YHe'] = None
    if N_eff is not None:
        base['nnu'] = N_eff
    base['As'] = base.pop('A_s', A_s_fid)
    base['pivot_tensor'] = base['pivot_scalar'] = base.pop('k_pivot')
    base['parameterization'] = 'tensor_param_rpivot'
    base['standard_neutrino_neff'] = constants.NEFF
    de = {rename: base.pop(name) for name, rename in
          {'w0_fld': 'w', 'wa_fld': 'wa', 'cs2_fld': 'cs2'}.items() if name in base}
    base['Want_CMB_lensing'] = base['DoLensing'] = base.pop('lensing')
    base['lmax'] = base.pop('ellmax_cl')
    base['redshifts'] = np.sort(np.asarray(base.pop('z_pk')))[::-1]
    base['kmax'] = base.pop('kmax_pk') * base['H0'] / 100.0
    for name in ['use_ppf', 'modes', 'T_ncdm_over_cmb', 'N_ur', 'm_ncdm', 'reionization_width', 'sigma8']:
        base.pop(name, None)
    non_linear = base.pop('non_linear', '')
    base = {**(extra_params or {}), **base}
    post = {'de_params': de, 'has_fld': has_fld, 'use_ppf': use_ppf, 'non_linear': non_linear}
    return base, post


def camb_nu_degeneracies(T_ncdm_over_cmb, m_ncdm):
    """CAMB neutrino degeneracy factors matching CLASS's effective
    temperatures, g = (T_ncdm_over_cmb / (4/11)^(1/3))^4, and the mass
    fractions."""
    g = np.asarray(T_ncdm_over_cmb, dtype=np.float64) ** 4 * (4.0 / 11.0) ** (-4.0 / 3.0)
    m = np.asarray(m_ncdm, dtype=np.float64)
    f = np.full_like(m, 1.0 / 3.0) if m.sum() == 0.0 else m / m.sum()
    return g, f


def background_z_grid():
    """Dense z-grid for importing host background tables: linear at low z,
    log-spaced up to z ~ 1e4. Shared by the CLASS and CAMB engine
    families."""
    return np.concatenate([np.linspace(0.0, 0.3, 30)[:-1],
                           1.0 / np.geomspace(1e-4, 1.0 / 1.3, 160)[::-1] - 1.0])


def build_task_dependency(tasks):
    """Complete a CAMB task list with its dependencies."""
    if not isinstance(tasks, (tuple, list)):
        tasks = [tasks]
    tasks = set(tasks)
    if 'thermodynamics' in tasks:
        tasks.discard('background')
    if 'harmonic' in tasks:
        tasks.add('fourier')
    if 'fourier' in tasks:
        tasks.add('transfer')
    return list(tasks)


def __getattr__(name):
    """The engine classes by name, from their family's module."""
    class_names = {'ClassEngine', 'AxiClassEngine', 'MochiClassEngine', 'NegNuClassEngine', 'DSClassEngine'}
    camb_names = {'CambEngine', 'ISiTGREngine', 'MGCambEngine', 'ISiTIDEEngine', 'HEFTCambEngine'}
    if name in class_names:
        from . import classy
        return getattr(classy, name)
    if name in camb_names:
        from . import camb
        return getattr(camb, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
