"""Training driver for Boltzmann-engine emulators
(cosmoprimo_tpu/emulators/train/train_boltzmann.py): one CLI covering
sample -> fit -> plot for any registered engine, with the reference's named
parameter-space configs, the production recipes (recipes.py, 'native-base'
among them) and the theta_MC_100 reparametrization (sampling the CMB
acoustic-scale parameter instead of ``h``).

Everything runs on the CUDA card unless ``--device cpu`` says otherwise.
Sampling is batch-first: the calculator takes ``--chunk-size`` points a
call, and the theta_MC_100 reparametrization solves h for a whole chunk
with the batched ``Cosmology.solve``. The MLP fits run on the card in
float64. Interrupted sampling resumes with ``--resume``. Files are .npy.

Usage (any analytic engine works for smoke tests):
    python -m cosmoprimo_tpu_torch.emulators.train.train_boltzmann \\
        --todo sample --recipe native-base --section thermodynamics --stop 256
    python -m cosmoprimo_tpu_torch.emulators.train.train_boltzmann \\
        --todo fit --recipe native-base --section thermodynamics
"""

import argparse
import os

import numpy as np
import torch

# Parameter boxes of the reference configs (train_classy.py:28-60,
# train_camb.py:28-60): Planck/DESI-wide priors; 'mnu' adds degenerate
# massive neutrinos, 'w_wa' opens the dark-energy equation of state.
_BASE = {'logA': (2.9, 3.2), 'n_s': (0.9, 1.04), 'h': (0.57, 0.80),
         'omega_b': (0.019, 0.025), 'omega_cdm': (0.09, 0.16), 'tau_reio': (0.02, 0.13)}
_MNU = {'m_ncdm': (0.0, 1.0)}
_W_WA = {'w0_fld': (-2.0, 0.0), 'wa_fld': (-3.0, 2.0)}

CONFIGS = {
    'base': dict(_BASE),
    'base_mnu': {**_BASE, **_MNU},
    'base_w_wa': {**_BASE, **_W_WA},
    'base_mnu_w_wa': {**_BASE, **_MNU, **_W_WA},
}


def make_reparam(cosmo, pnames, limits=(1.02, 1.06)):
    """Replace the ``h`` box by a ``theta_MC_100`` box: returns the updated
    params dict transform and a map of a chunk of points (name -> (n,)
    tensor) that solves h(theta) for every row at once with the batched
    ``Cosmology.solve``. A row whose h could not be found raises
    CalculatorComputationError, which sends the chunk row by row, so that
    only that row becomes NaN."""
    from ..samples import CalculatorComputationError

    pnames = [name for name in pnames if name not in ('h', 'theta_MC_100')]

    def update_params(params):
        params = dict(params)
        params.pop('h', None)
        params['theta_MC_100'] = tuple(limits)
        return params

    def reparam(X):
        X = dict(X)
        theta = X.pop('theta_MC_100')
        h = cosmo.clone(**{name: X[name] for name in pnames}).solve('h', 'theta_MC_100', target=theta)['h']
        if not bool(torch.isfinite(h).all()):
            raise CalculatorComputationError(f'theta_MC_100 = {theta} could not be inverted')
        X['h'] = h
        return X

    return update_params, reparam


def build_cosmology(engine, config, device=None, **extra_params):
    """Fiducial DESI cosmology cloned onto the requested engine/config."""
    from ...fiducial import DESI
    kwargs = {}
    if 'mnu' in config:
        kwargs['neutrino_hierarchy'] = 'degenerate'
    return DESI(engine=engine, extra_params=extra_params or None, device=device, **kwargs)


def _recipe_section(args):
    """(recipe, section dict) for --recipe runs; each section carries its
    own parameter box / cosmology / operations (recipes.py)."""
    from .recipes import RECIPES
    recipe = RECIPES[args.recipe]
    if not args.section:
        raise SystemExit(f'--recipe {args.recipe} needs --section '
                         f'(one of {sorted(recipe["sections"])})')
    return recipe, recipe['sections'][args.section]


def sample(args):
    """Sample the calculator over the box, write and return the samples."""
    from .. import QMCSampler, get_calculator

    if args.recipe:
        from ...fiducial import DESI
        recipe, section = _recipe_section(args)
        extra_params = dict(section.get('extra_params', {}))
        cosmo = DESI(engine=args.engine or recipe['engine'], extra_params=extra_params or None, device=args.device,
                     **{**recipe.get('cosmo', {}), **section.get('cosmo', {})})
        params = dict(section['params'])
        qmc = dict(recipe.get('sampler', {'engine': 'rqrs'}))
        if args.seed is not None:
            qmc['seed'] = args.seed
        calculator_sections = section.get('calculator_sections', [args.section])
        # engine overrides (e.g. analytic smoke runs) may not provide every
        # section the production engine does: keep the available subset
        available = list(cosmo.engine._Section_classes)
        calculator_sections = [s for s in calculator_sections if s in available]
        save_every = section.get('save_every', args.save_every)
        reparam = None
        if recipe.get('theta'):
            update_params, reparam = make_reparam(cosmo, list(params), limits=recipe['theta'])
            params = update_params(params)
    else:
        cosmo = build_cosmology(args.engine, args.config, device=args.device)
        params = CONFIGS[args.config]
        qmc = dict(engine='rqrs', seed=args.seed)
        calculator_sections = args.section or None
        save_every = args.save_every
        reparam = None
        if args.theta:
            update_params, reparam = make_reparam(cosmo, list(params))
            params = update_params(params)

    calculator = get_calculator(cosmo, section=calculator_sections)
    sampler = QMCSampler(calculator, params, reparam=reparam, save_fn=args.samples_fn, save_every=save_every,
                         chunk_size=args.chunk_size, **qmc)
    samples = sampler.run(niterations=args.stop - args.start,
                          resume_from=args.samples_fn if args.resume else None)
    samples.write(args.samples_fn)
    print(f'{samples.size} samples -> {args.samples_fn}')
    return samples


def _engines_for(section, nhidden_scale=1):
    """Per-section MLP architectures following the reference's choices
    (train_camb.py:105-115): small tanh nets for smooth scalar sections,
    wide silu nets for pk, Cl nets normalized by the primordial amplitude."""
    from .. import MLPEmulatorEngine, Operation

    s = int(nhidden_scale)
    engine = {}
    engine['background.*'] = MLPEmulatorEngine(nhidden=(64 * s,) * 4, activation='tanh')
    engine['thermodynamics.*'] = MLPEmulatorEngine(nhidden=(10 * s,) * 5, activation='tanh')
    engine['primordial.*'] = MLPEmulatorEngine(nhidden=(20 * s,) * 2)
    engine['fourier.*'] = MLPEmulatorEngine(nhidden=(64 * s,) * 5, activation='silu',
                                            yoperation=['log10'])
    # Cl's: divide out the primordial amplitude exp(logA) e^{-2 tau} and the
    # tilt before fitting, so the net learns an O(1) shape
    yop = Operation("v / jnp.exp(X['logA'] - 3.) / jnp.exp(-2 * X['tau_reio'])",
                    inverse="v * jnp.exp(X['logA'] - 3.) * jnp.exp(-2 * X['tau_reio'])")
    engine['harmonic.*'] = MLPEmulatorEngine(nhidden=(128 * s,) * 3, activation='tanh',
                                             yoperation=[yop])
    return engine


_FIT_SCHEDULES = {
    # section -> (batch_frac, learning_rate, epochs, patience): the
    # reference's staged large-batch annealing (train_camb.py:130-170)
    'background': ((0.5, 0.8, 0.8), (1e-2, 1e-3, 1e-4), 2000, 1000),
    'thermodynamics': ((0.5, 0.8, 0.8, 1.0), (1e-2, 1e-3, 1e-4, 1e-5), 2000, 1000),
    'primordial': ((0.2, 0.4, 1.0), (1e-2, 1e-4, 1e-6), 1000, 1000),
    'fourier': ((0.2, 0.3, 0.5, 1.0), (1e-2, 1e-3, 1e-5, 1e-7), 2000, 1000),
    'harmonic': ((0.8, 0.8, 1.0), (1e-2, 1e-3, 1e-3), 1000, 1000),
}


def _prepare_samples(samples, prepare):
    """Named sample transforms of the reference fits: Omega_m
    reparametrization of the background inputs (train_classy.py:122-124,
    train_camb.py:127)."""
    if prepare in ('omega_to_Omega_m', 'add_Omega_m'):
        samples['X.Omega_m'] = ((np.asarray(samples['X.omega_cdm']) + np.asarray(samples['X.omega_b']))
                                / np.asarray(samples['X.h']) ** 2)
        if prepare == 'omega_to_Omega_m':
            del samples['X.omega_cdm']
            del samples['X.omega_b']
    elif prepare:
        raise ValueError(f'unknown prepare transform {prepare!r}')
    return samples


def _read_emulator(args):
    """The emulator file to add the fit to, or a new emulator, on the
    run's device."""
    from .. import Emulator
    emulator = Emulator.read(args.emulator_fn) if os.path.exists(args.emulator_fn) else Emulator()
    emulator.device = args.device
    return emulator


def fit_recipe(args):
    """Fit one section with the recipe's operation layout and staged
    schedule (reference train_classy.py:95-180 / train_camb.py:104-170);
    write and return the emulator."""
    from .. import FourierNormOperation, Samples
    from .recipes import build_engines

    recipe, section = _recipe_section(args)
    samples = Samples.read(args.samples_fn)
    keep = [name for name in samples if name.startswith(('X.', f'Y.{args.section}.'))]
    include = section.get('include')
    if include:
        keep = [name for name in keep if not name.startswith('X.') or name in include]
    for name in section.get('exclude', []):
        if name in keep:
            keep.remove(name)
    samples.pop('X.theta_MC_100', None)
    sub = Samples({name: samples[name] for name in keep if name in samples}, attrs=samples.attrs)
    mask = sub.isfinite()
    if not mask.all():
        print(f'{args.section}: dropping {int((~mask).sum())}/{mask.size} non-finite samples')
        sub = sub.select(mask)
    sub = _prepare_samples(sub, section.get('prepare'))

    emulator = _read_emulator(args)
    emulator.set_engine(build_engines(section['engines'], samples=sub))
    emulator.yoperations = ([FourierNormOperation(ref_pk_name='fourier.pk.delta_cb.delta_cb')]
                            if 'fourier_norm' in section.get('yoperations', []) else [])
    emulator.set_samples(samples=sub)
    schedule = dict(section['fit'])
    if args.epochs:
        schedule['epochs'] = args.epochs
        schedule['patience'] = min(schedule.get('patience', args.epochs), args.epochs)
    emulator.fit(name=f'{args.section}.*', **schedule)
    emulator.write(args.emulator_fn)
    print(f'{args.section} [{args.recipe}] -> {args.emulator_fn}')
    return emulator


def fit(args):
    """Fit the section (all by default) of the samples; write and return
    the emulator."""
    from .. import FourierNormOperation, Samples

    if args.recipe:
        return fit_recipe(args)
    samples = Samples.read(args.samples_fn)
    emulator = _read_emulator(args)
    emulator.set_engine(_engines_for(args.section, nhidden_scale=args.nhidden_scale))
    sections = [args.section] if args.section else list(_FIT_SCHEDULES)
    for section in sections:
        keep = [name for name in samples if name.startswith(('X.', f'Y.{section}.'))]
        if not any(name.startswith('Y.') for name in keep):
            print(f'no {section} samples in {args.samples_fn}, skipping')
            continue
        sub = Samples({name: samples[name] for name in keep}, attrs=samples.attrs)
        # drop failed evaluations (recorded as NaN rows by the sampler), the
        # reference's load_samples isfinite selection (train_camb.py:80-86)
        mask = sub.isfinite()
        if not mask.all():
            print(f'{section}: dropping {int((~mask).sum())}/{mask.size} non-finite samples')
            sub = sub.select(mask)
        bfrac, lr, epochs, patience = _FIT_SCHEDULES[section]
        # factorize the pk tables by the reference spectrum before fitting
        # (reference train_camb.py:106), only while fitting fourier samples
        emulator.yoperations = ([FourierNormOperation(ref_pk_name='fourier.pk.delta_cb.delta_cb')]
                                if section == 'fourier' else [])
        emulator.set_samples(samples=sub)
        emulator.fit(name=f'{section}.*', batch_frac=bfrac, learning_rate=lr,
                     epochs=args.epochs or epochs, patience=patience)
        emulator.write(args.emulator_fn)
        print(f'{section} -> {args.emulator_fn}')
    return emulator


def plot(args):
    """Residual bands of each section of the samples against the emulator
    file (needs matplotlib)."""
    from .. import Samples
    from ..plotting import (plot_residual_background, plot_residual_fourier,
                            plot_residual_harmonic, plot_residual_thermodynamics)
    from ...cosmology import Cosmology

    samples = Samples.read(args.samples_fn)
    cosmo = Cosmology(engine='emulated', extra_params={'path': args.emulator_fn}, device=args.device)
    outdir = os.path.dirname(args.emulator_fn) or '.'
    plotters = {'background': plot_residual_background, 'thermodynamics': plot_residual_thermodynamics,
                'fourier': plot_residual_fourier, 'harmonic': plot_residual_harmonic}
    for section, plotter in plotters.items():
        if any(name.startswith(f'Y.{section}.') for name in samples):
            plotter(samples, emulated_samples=cosmo, fn=os.path.join(outdir, f'{section}.png'))


def main(argv=None):
    """Run the CLI; returns what the --todo step returns (the samples, the
    emulator, or None for plot)."""
    from ..samples import CHUNK_SIZE, resolve_device
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--todo', required=True, choices=['sample', 'fit', 'plot'])
    parser.add_argument('--recipe', default=None,
                        help='named production recipe (recipes.py: classy-base_mnu_w_wa, '
                             'camb-base_w_wa, camb-base_mnu_w_wa, axiclassy-base, native-base) carrying the '
                             "parameter boxes, operation chains and fit schedules; overrides --engine/--config")
    parser.add_argument('--engine', default=None, help='any registered engine (native; eisenstein_hu etc. '
                        'for smoke tests)')
    parser.add_argument('--config', default='base_w_wa', choices=sorted(CONFIGS))
    parser.add_argument('--section', default=None,
                        choices=[None, 'background', 'thermodynamics', 'primordial', 'fourier', 'harmonic'])
    parser.add_argument('--theta', action='store_true',
                        help='sample theta_MC_100 instead of h (solved for each chunk)')
    parser.add_argument('--start', type=int, default=0)
    parser.add_argument('--stop', type=int, default=100000)
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--save-every', type=int, default=100)
    parser.add_argument('--resume', action='store_true')
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--nhidden-scale', type=int, default=1)
    parser.add_argument('--samples-fn', default=None)
    parser.add_argument('--emulator-fn', default=None)
    parser.add_argument('--outdir', default='_train')
    parser.add_argument('--device', default=None, help='torch device of the sampling and the fits '
                        '(default: the CUDA card; cpu opts out)')
    parser.add_argument('--chunk-size', type=int, default=CHUNK_SIZE,
                        help='points given to the calculator in one batch-first call')
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)

    if args.recipe:
        from .recipes import RECIPES
        if args.recipe not in RECIPES:
            raise SystemExit(f'unknown recipe {args.recipe!r}; choose from {sorted(RECIPES)}')
        if args.engine is None:
            args.engine = RECIPES[args.recipe]['engine']
        tag = args.recipe + (f'_{args.section}' if args.section else '')
    else:
        if args.engine is None:
            args.engine = 'class'
        tag = f'{args.engine}_{args.config}'
    if args.samples_fn is None:
        args.samples_fn = os.path.join(args.outdir, tag, 'samples.npy')
    if args.emulator_fn is None:
        args.emulator_fn = os.path.join(args.outdir, tag, 'emulator.npy')
    os.makedirs(os.path.dirname(args.samples_fn), exist_ok=True)

    return {'sample': sample, 'fit': fit, 'plot': plot}[args.todo](args)


if __name__ == '__main__':
    main()
