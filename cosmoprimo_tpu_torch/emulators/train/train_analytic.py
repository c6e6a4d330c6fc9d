"""Train MLP emulators of the analytic-engine sections over a wide
parameter box (QMC sampling + per-section MLP fits + residual diagnostics),
cosmoprimo_tpu/emulators/train/train_analytic.py on the CUDA card: the
sampler calls the engine batch-first, the fit runs in float64 on the
card, and ``--device cpu`` opts out.

Usage:
    python -m cosmoprimo_tpu_torch.emulators.train.train_analytic \\
        --section background --niterations 2000 --output emulator.npy
"""

import argparse

import numpy as np


def main(argv=None):
    """Run the CLI; returns the fitted emulator."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--section', nargs='+', default=['background', 'thermodynamics', 'primordial'])
    parser.add_argument('--engine', default='eisenstein_hu')
    parser.add_argument('--emulator-engine', default='mlp', choices=['mlp', 'taylor', 'point'])
    parser.add_argument('--niterations', type=int, default=2000)
    parser.add_argument('--epochs', type=int, default=500)
    parser.add_argument('--output', default='emulator.npy')
    parser.add_argument('--samples', default=None, help='precomputed samples file (skip sampling)')
    parser.add_argument('--save-samples', default=None)
    parser.add_argument('--nparams', type=int, default=5, help='number of varied parameters (prefix of the box)')
    parser.add_argument('--device', default=None, help='torch device of the sampling and the fit (default: the '
                        'CUDA card; cpu opts out)')
    args = parser.parse_args(argv)

    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.emulators import (Emulator, MLPEmulatorEngine, PointEmulatorEngine, QMCSampler,
                                                Samples, TaylorEmulatorEngine, get_calculator)
    from cosmoprimo_tpu_torch.emulators.plotting import compute_residuals
    from cosmoprimo_tpu_torch.emulators.samples import resolve_device

    device = resolve_device(args.device)
    # wide box around Planck/DESI (reference train_classy.py parameter space)
    params = {'omega_cdm': (0.08, 0.20), 'omega_b': (0.019, 0.026), 'h': (0.5, 0.9),
              'logA': (2.5, 3.5), 'n_s': (0.88, 1.06)}
    params = dict(list(params.items())[:max(1, args.nparams)])

    cosmo = Cosmology(engine=args.engine, device=device)
    calculator = get_calculator(cosmo, section=args.section)

    if args.samples:
        samples = Samples.read(args.samples)
    else:
        sampler = QMCSampler(calculator, params, engine='rqrs', save_fn=args.save_samples)
        samples = sampler.run(niterations=args.niterations)

    engine = {'mlp': MLPEmulatorEngine(nhidden=(64, 64, 64)),
              'taylor': TaylorEmulatorEngine(order=3),
              'point': PointEmulatorEngine()}[args.emulator_engine]
    emulator = Emulator(engine=engine, device=device)
    emulator.set_samples(samples=samples)
    if args.emulator_engine == 'mlp':
        emulator.fit(epochs=args.epochs)
    else:
        emulator.fit()
    emulator.write(args.output)

    # quick residual report on fresh points, one batch
    residuals = compute_residuals(emulator, calculator, params, ntest=20, seed=7)
    print('max relative residuals over 20 test points:')
    for name, value in sorted(residuals.items()):
        print(f'  {name}: {float(np.max(value)):.3e}')
    print(f'emulator written to {args.output}')
    return emulator


if __name__ == '__main__':
    main()
