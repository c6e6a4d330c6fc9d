"""Production training recipes (cosmoprimo_tpu/emulators/train/recipes.py),
as data: the reference's per-engine driver scripts (train_classy.py,
train_camb.py, train_axiclassy.py) and the repo's own 'native-base',
consumed by train_boltzmann.py, so `--recipe classy-base_mnu_w_wa --section
fourier` regenerates an emulator with the reference's parameter boxes,
per-section x/y operation chains and staged fit schedules in one command.
Equal to the JAX package's recipes.

Every recipe is a plain dict:

``engine``            registered engine name the samples come from
``cosmo``             DESI-clone kwargs shared by all sections
``theta``             (lo, hi) to sample theta_MC_100 instead of h
``sampler``           QMC engine + seed
``yoperations``       emulator-level operation chain (applied at fit time
                      for the sections that need it)
``sections``          per-section dict:
    ``params``              the sampled parameter box
    ``cosmo``               extra clone kwargs (non_linear, lensing, ...)
    ``calculator_sections`` sections the calculator must compute
    ``save_every``          checkpoint cadence while sampling
    ``exclude``             X columns dropped before the fit
    ``prepare``             named samples transform ('omega_to_Omega_m'
                            replaces omega_b/omega_cdm by Omega_m, as the
                            reference's background fits do)
    ``engines``             pattern -> MLP spec dict(nhidden, activation,
                            yoperation names); 'per_column' uses the
                            array/scalar split of the reference background
                            fits
    ``fit``                 staged schedule kwargs for Emulator.fit
"""

import numpy as np


def _op_cl_norm():
    """Divide out the primordial amplitude/optical-depth scaling so the Cl
    nets learn an O(1) shape (reference train_classy.py:115)."""
    from ..operations import Operation
    return Operation("v / jnp.exp(X['logA'] - 3.) / jnp.exp(-2 * X['tau_reio'])",
                     inverse="v * jnp.exp(X['logA'] - 3.) * jnp.exp(-2 * X['tau_reio'])")


def _op_cl_norm_tilt(ellmax=9500):
    """The camb-recipe Cl normalization: amplitude, optical depth AND the
    primordial tilt via (ell/500)^(n_s - 0.96) (reference train_camb.py:112)."""
    from ..operations import Operation
    ellnorm = np.maximum(np.arange(ellmax + 1), 1) / 500.0
    return Operation(
        "v / jnp.exp(X['logA'] - 3.) / jnp.exp(-2 * X['tau_reio']) / ellnorm ** (X['n_s'] - 0.96)",
        inverse="v * jnp.exp(X['logA'] - 3.) * jnp.exp(-2 * X['tau_reio']) * ellnorm ** (X['n_s'] - 0.96)",
        locals={'ellnorm': ellnorm})


_OPS = {'log10': 'log10', 'cl_norm': _op_cl_norm, 'cl_norm_tilt': _op_cl_norm_tilt}


def resolve_yoperations(names):
    """Operation spec names -> instances ('log10' resolves through the
    engine's own registry; callables here build parameterized Operations)."""
    out = []
    for name in names:
        op = _OPS.get(name, name)
        out.append(op() if callable(op) else op)
    return out


# ---- classy recipe (reference train_classy.py) ---------------------------

_CLASSY_SECTIONS = {
    'background': dict(
        params={'h': (0.2, 1.0), 'omega_cdm': (0.01, 0.90), 'omega_b': (0.005, 0.05),
                'm_ncdm': (0.0, 5.0), 'w0_fld': (-3.0, 1.0), 'wa_fld': (-3.0, 2.0)},
        cosmo={}, calculator_sections=['background'], save_every=100,
        exclude=['X.logA', 'X.n_s', 'X.tau_reio'], prepare='omega_to_Omega_m',
        engines={'per_column': dict(array=dict(nhidden=(64,) * 12, activation='silu'),
                                    scalar=dict(nhidden=(20,)))},
        fit=dict(batch_frac=[1.0] * 6, learning_rate=[1e-3, 1e-4, 1e-5, 1e-6, 1e-7],
                 batch_norm=True, learning_rate_scheduling=False, epochs=50000, patience=10000)),
    'thermodynamics': dict(
        params={'h': (0.2, 1.0), 'omega_cdm': (0.01, 0.90), 'omega_b': (0.005, 0.05),
                'm_ncdm': (0.0, 5.0), 'w0_fld': (-2.0, 0.0), 'wa_fld': (-3.0, 2.0)},
        cosmo={}, calculator_sections=['thermodynamics'], save_every=100,
        exclude=['X.logA', 'X.n_s', 'X.tau_reio'],
        engines={'thermodynamics.*': dict(nhidden=(10,) * 5, activation='tanh')},
        fit=dict(batch_frac=[0.02, 0.05, 0.1, 0.2, 0.4, 0.5],
                 learning_rate=[1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-7],
                 patience=5000, epochs=50000)),
    'primordial': dict(
        params={'logA': (1.5, 4.0), 'n_s': (0.8, 1.2)},
        cosmo={}, calculator_sections=['primordial'], save_every=100,
        include=['X.logA', 'X.n_s'],
        engines={'primordial.*': dict(nhidden=(20,) * 2)},
        fit=dict(batch_frac=(0.2, 0.4, 1.0), learning_rate=(1e-2, 1e-4, 1e-6), epochs=1000)),
    'fourier': dict(
        params={'h': (0.5, 0.9), 'omega_cdm': (0.03, 0.3), 'logA': (1.5, 4.0),
                'n_s': (0.8, 1.2), 'omega_b': (0.005, 0.04), 'm_ncdm': (0.0, 3.0),
                'w0_fld': (-2.0, 1.0), 'wa_fld': (-3.0, 2.0)},
        cosmo={'non_linear': 'mead'},
        calculator_sections=['background', 'thermodynamics', 'primordial', 'fourier'],
        save_every=10, exclude=['X.tau_reio'],
        # glob first, specific override last: expand_dict is last-match-wins
        engines={'fourier.*': dict(nhidden=(64,) * 5, activation='silu', yoperation=['log10']),
                 'fourier.pk.delta_cb.delta_cb': dict(nhidden=(64,) * 5, activation='silu')},
        yoperations=['fourier_norm'],
        fit=dict(batch_frac=[0.2, 0.3, 0.3, 0.4, 0.5, 1.0],
                 learning_rate=[1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-7],
                 batch_norm=False, learning_rate_scheduling=False, epochs=10000, patience=1000)),
    'harmonic': dict(
        params={'logA': (2.5, 3.5), 'n_s': (0.88, 1.06), 'h': (0.5, 0.9),
                'omega_b': (0.019, 0.026), 'omega_cdm': (0.08, 0.2), 'm_ncdm': (0.0, 0.6),
                'Omega_k': (-0.1, 0.1), 'w0_fld': (-2.0, 1.0), 'wa_fld': (-3.0, 2.0),
                'tau_reio': (0.02, 0.12)},
        cosmo={'lensing': True},
        calculator_sections=['background', 'thermodynamics', 'primordial', 'harmonic'],
        save_every=2,
        engines={'harmonic.*': dict(nhidden=(64,) * 6, yoperation=['cl_norm'])},
        fit=dict(batch_frac=[0.2, 0.3, 0.3, 0.4, 0.5, 1.0],
                 learning_rate=[1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-7],
                 patience=1000, epochs=50000)),
}


# ---- camb recipe (reference train_camb.py) -------------------------------

_CAMB_BOX = {'logA': (2.9, 3.2), 'n_s': (0.9, 1.04), 'omega_b': (0.019, 0.025),
             'omega_cdm': (0.09, 0.16), 'tau_reio': (0.02, 0.13),
             'w0_fld': (-2.0, 0.0), 'wa_fld': (-3.0, 2.0)}

def _camb_sections(mnu):
    box = dict(_CAMB_BOX)
    if mnu:
        box['m_ncdm'] = (0.0, 1.0)
    common = dict(
        params=box,
        cosmo={'lensing': True, 'non_linear': 'hmcode'},
        extra_params={'kmax_pk': 10.0, 'ellmax_cl': 9500, 'YHe': 'BBN'},
        calculator_sections=['background', 'thermodynamics', 'primordial', 'harmonic', 'fourier'],
        save_every=10)
    return {
        'background': dict(common, exclude=['X.logA', 'X.n_s', 'X.tau_reio'],
                           prepare='omega_to_Omega_m',
                           engines={'per_column': dict(array=dict(nhidden=(64,) * 4, activation='tanh'),
                                                       scalar=dict(nhidden=(20,)))},
                           fit=dict(batch_frac=[0.5, 0.8, 0.8], learning_rate=[1e-2, 1e-3, 1e-4],
                                    patience=1000, epochs=50000)),
        'thermodynamics': dict(common, exclude=['X.logA', 'X.n_s', 'X.tau_reio'],
                               engines={'thermodynamics.*': dict(nhidden=(10,) * 5, activation='tanh')},
                               fit=dict(batch_frac=[0.5, 0.8, 0.8, 1.0],
                                        learning_rate=[1e-2, 1e-3, 1e-4, 1e-5],
                                        patience=1000, epochs=50000)),
        'primordial': dict(common, include=['X.logA', 'X.n_s'],
                           engines={'primordial.*': dict(nhidden=(20,) * 2)},
                           fit=dict(batch_frac=(0.2, 0.4, 1.0), learning_rate=(1e-2, 1e-4, 1e-6),
                                    epochs=1000)),
        'fourier': dict(common, exclude=['X.tau_reio'],
                        engines={'fourier.*': dict(nhidden=(64,) * 5, activation='silu',
                                                   yoperation=['log10']),
                                 'fourier.pk.delta_cb.delta_cb': dict(nhidden=(64,) * 5,
                                                                      activation='silu')},
                        yoperations=['fourier_norm'],
                        fit=dict(batch_frac=[0.2, 0.3, 0.3, 0.4, 0.5, 1.0],
                                 learning_rate=[1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-7],
                                 batch_norm=False, learning_rate_scheduling=False,
                                 epochs=10000, patience=1000)),
        'harmonic': dict(common,
                         engines={'harmonic.*': dict(nhidden=(128,) * 3, activation='tanh',
                                                     yoperation=['cl_norm_tilt'])},
                         fit=dict(batch_frac=[0.8, 0.8, 1.0], learning_rate=[1e-2, 1e-3, 1e-3],
                                  patience=1000, epochs=5000)),
    }


# ---- axiclassy recipe (reference train_axiclassy.py) ---------------------

_AXICLASS_PRECISION = {
    'recombination': 'HyRec', 'l_max_scalars': 9500, 'delta_l_max': 1800,
    'P_k_max_h/Mpc': 100.0, 'l_logstep': 1.025, 'l_linstep': 20,
    'perturbations_sampling_stepsize': 0.05, 'l_switch_limber': 30.0,
    'hyper_sampling_flat': 32.0, 'l_max_g': 40, 'l_max_ur': 35, 'l_max_pol_g': 60,
    'ur_fluid_approximation': 2, 'ur_fluid_trigger_tau_over_tau_k': 130.0,
    'radiation_streaming_approximation': 2,
    'radiation_streaming_trigger_tau_over_tau_k': 240.0,
    'hyper_flat_approximation_nu': 7000.0,
    'transfer_neglect_delta_k_S_t0': 0.17, 'transfer_neglect_delta_k_S_t1': 0.05,
    'transfer_neglect_delta_k_S_t2': 0.17, 'transfer_neglect_delta_k_S_e': 0.17,
    'accurate_lensing': True,
    'start_small_k_at_tau_c_over_tau_h': 0.0004,
    'start_large_k_at_tau_h_over_tau_k': 0.05,
    'tight_coupling_trigger_tau_c_over_tau_h': 0.005,
    'tight_coupling_trigger_tau_c_over_tau_k': 0.008,
    'start_sources_at_tau_c_over_tau_h': 0.006,
    'l_max_ncdm': 30, 'tol_ncdm_synchronous': 1e-06,
}

_AXICLASS_SCF = {
    'scf_potential': 'axion', 'n_axion': 3.0, 'log10_axion_ac': -3.562,
    'fraction_axion_ac': 0.122, 'scf_parameters__1': 2.83, 'scf_parameters__2': 0.0,
    'scf_evolve_as_fluid': False, 'scf_evolve_like_axionCAMB': False,
    'scf_has_perturbations': True, 'attractor_ic_scf': False,
    'compute_phase_shift': False, 'include_scf_in_delta_m': True,
    'include_scf_in_delta_cb': True,
}

_AXICLASSY_SECTIONS = dict(
    _CLASSY_SECTIONS,
    harmonic=dict(
        params={'logA': (2.5, 3.5), 'n_s': (0.88, 1.06), 'h': (0.4, 1.0),
                'omega_b': (0.019, 0.025), 'omega_cdm': (0.08, 0.2),
                'tau_reio': (0.02, 0.12), 'log10_axion_ac': (-3.9, -3.2),
                'fraction_axion_ac': (0.0, 0.3), 'scf_parameters__1': (0.0, 3.2)},
        cosmo={'lensing': True, 'non_linear': 'hmcode'},
        extra_params={'YHe': 'BBN', **_AXICLASS_PRECISION, **_AXICLASS_SCF},
        calculator_sections=['background', 'thermodynamics', 'primordial', 'harmonic'],
        save_every=2,
        engines={'harmonic.*': dict(nhidden=(64,) * 6, yoperation=['cl_norm'])},
        fit=dict(batch_frac=[0.2, 0.3, 0.3, 0.4, 0.5, 1.0],
                 learning_rate=[1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-7],
                 patience=1000, epochs=50000)),
)


# ---- native recipe: self-contained end-to-end training -------------------
# The truth engine is the in-repo Einstein-Boltzmann solver
# (boltzmann/perturbations.py), so sample -> fit -> serve runs with no
# external C/Fortran code. Boxes are restricted to the native solver's
# validated domain: flat geometries, one (combined) massive neutrino
# species, background-only w0/wa dark energy (models/native.py).

_NATIVE_BASE = {'logA': (2.8, 3.3), 'n_s': (0.88, 1.06), 'h': (0.55, 0.82),
                'omega_b': (0.019, 0.026), 'omega_cdm': (0.08, 0.20)}

_NATIVE_SECTIONS = {
    'background': dict(
        params={'h': (0.5, 0.9), 'omega_cdm': (0.05, 0.30), 'omega_b': (0.015, 0.035),
                'm_ncdm': (0.0, 1.0), 'w0_fld': (-2.0, -0.3), 'wa_fld': (-2.0, 1.5)},
        cosmo={}, calculator_sections=['background'], save_every=100,
        exclude=['X.logA', 'X.n_s', 'X.tau_reio'], prepare='omega_to_Omega_m',
        engines={'per_column': dict(array=dict(nhidden=(64,) * 8, activation='silu'),
                                    scalar=dict(nhidden=(20,)))},
        fit=dict(batch_frac=[1.0] * 5, learning_rate=[1e-3, 1e-4, 1e-5, 1e-6, 1e-7],
                 batch_norm=True, learning_rate_scheduling=False, epochs=50000, patience=10000)),
    'thermodynamics': dict(
        params={'h': (0.5, 0.9), 'omega_cdm': (0.05, 0.30), 'omega_b': (0.015, 0.035),
                'm_ncdm': (0.0, 1.0), 'tau_reio': (0.02, 0.13)},
        cosmo={}, calculator_sections=['thermodynamics'], save_every=100,
        exclude=['X.logA', 'X.n_s'],
        engines={'thermodynamics.*': dict(nhidden=(10,) * 5, activation='tanh')},
        fit=dict(batch_frac=[0.1, 0.2, 0.4, 1.0],
                 learning_rate=[1e-2, 1e-3, 1e-5, 1e-7],
                 patience=5000, epochs=50000)),
    'fourier': dict(
        params={**_NATIVE_BASE, 'm_ncdm': (0.0, 0.6),
                'w0_fld': (-1.5, -0.5), 'wa_fld': (-1.5, 1.0)},
        cosmo={},
        calculator_sections=['background', 'thermodynamics', 'primordial', 'fourier'],
        save_every=10, exclude=['X.tau_reio'],
        engines={'fourier.*': dict(nhidden=(64,) * 5, activation='silu', yoperation=['log10']),
                 'fourier.pk.delta_cb.delta_cb': dict(nhidden=(64,) * 5, activation='silu')},
        yoperations=['fourier_norm'],
        fit=dict(batch_frac=[0.2, 0.3, 0.5, 1.0],
                 learning_rate=[1e-2, 1e-3, 1e-5, 1e-7],
                 batch_norm=False, learning_rate_scheduling=False, epochs=10000, patience=1000)),
    'harmonic': dict(
        params={**_NATIVE_BASE, 'm_ncdm': (0.0, 0.6), 'tau_reio': (0.02, 0.12)},
        cosmo={'lensing': True},
        calculator_sections=['background', 'thermodynamics', 'primordial', 'harmonic'],
        save_every=2,
        engines={'harmonic.*': dict(nhidden=(64,) * 6, yoperation=['cl_norm'])},
        fit=dict(batch_frac=[0.2, 0.3, 0.5, 1.0],
                 learning_rate=[1e-2, 1e-3, 1e-5, 1e-7],
                 patience=1000, epochs=50000)),
}


RECIPES = {
    'classy-base_mnu_w_wa': dict(
        engine='class', cosmo={'neutrino_hierarchy': 'degenerate'},
        sampler=dict(engine='lhs', seed=42), sections=_CLASSY_SECTIONS),
    'camb-base_w_wa': dict(
        engine='camb', cosmo={},
        sampler=dict(engine='lhs', seed=5), theta=(1.02, 1.06),
        sections=_camb_sections(mnu=False)),
    'camb-base_mnu_w_wa': dict(
        engine='camb', cosmo={'neutrino_hierarchy': 'degenerate'},
        sampler=dict(engine='lhs', seed=5), theta=(1.02, 1.06),
        sections=_camb_sections(mnu=True)),
    'axiclassy-base': dict(
        engine='axiclass', cosmo={},
        sampler=dict(engine='lhs', seed=42), sections=_AXICLASSY_SECTIONS),
    'native-base': dict(
        engine='native', cosmo={},
        sampler=dict(engine='lhs', seed=7), sections=_NATIVE_SECTIONS),
}


def build_engines(spec, samples=None):
    """Engine-spec dicts -> {pattern: MLPEmulatorEngine}.  The 'per_column'
    spec (reference background fits) picks the array/scalar architecture per
    Y column of ``samples``."""
    from .. import MLPEmulatorEngine
    out = {}
    for pattern, cfg in spec.items():
        if pattern == 'per_column':
            if samples is None:
                continue
            for name in samples:
                if not name.startswith('Y.'):
                    continue
                sub = cfg['array'] if np.ndim(samples[name]) > 1 else cfg['scalar']
                out[name[2:]] = _mlp(sub)
        else:
            out[pattern] = _mlp(cfg)
    return out


def _mlp(cfg):
    from .. import MLPEmulatorEngine
    kwargs = dict(cfg)
    yoperation = kwargs.pop('yoperation', None)
    if yoperation is not None:
        kwargs['yoperation'] = resolve_yoperations(yoperation)
    return MLPEmulatorEngine(**kwargs)
