"""Residual diagnostics for trained emulators
(cosmoprimo_tpu/emulators/plotting.py). The compute part runs headless and
returns numpy arrays; the ``plot_*`` functions need matplotlib, imported
when they are called (the card's machine has none: they raise an
ImportError that names it)."""

import os

import numpy as np
import torch

from .. import utils
from .samples import calculator_device, evaluate_rows


def _pyplot():
    try:
        from matplotlib import pyplot as plt
    except ImportError as exc:
        raise ImportError('the plot_* functions need matplotlib, which is not installed; compute_residuals '
                          'gives the residuals without it') from exc
    return plt


def compute_residuals(emulator, calculator, params_box, ntest=50, seed=7, device=None):
    """Relative residuals |pred - truth| / max|truth| (per test point) for
    each emulated quantity over ``ntest`` random points in ``params_box``,
    the JAX package's draws; the batch-first ``calculator`` and the
    emulator are each called once on the batch of test points, on
    ``device`` (by default the calculator's, else the CUDA card). Returns
    name -> (ntest,) + the quantity's shape."""
    rng = np.random.default_rng(seed)
    rows = [{name: rng.uniform(*box) for name, box in params_box.items()} for _ in range(ntest)]
    points = {name: np.array([row[name] for row in rows]) for name in params_box}
    device = calculator_device(calculator, device)
    truth = evaluate_rows(calculator, points, device)
    pred = emulator.predict({name: torch.as_tensor(value, device=device) for name, value in points.items()})
    residuals = {}
    for name, value in pred.items():
        if name not in truth:
            continue
        t = truth[name]
        q = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        if t[0].size == 0:
            continue
        q = np.broadcast_to(q, t.shape)
        scale = np.maximum(np.abs(t).reshape(len(t), -1).max(axis=-1), 1e-30)
        residuals[name] = np.abs(q - t) / scale.reshape((-1,) + (1,) * (t.ndim - 1))
    return residuals


def plot_residuals(residuals, fn=None, quantiles=(0.68, 0.95, 1.0)):
    """Plot per-quantity residual quantile bands; returns the figure
    (requires matplotlib)."""
    plt = _pyplot()
    names = list(residuals)
    fig, axes = plt.subplots(len(names), 1, figsize=(6, 2.5 * len(names)), squeeze=False)
    for ax, name in zip(axes[:, 0], names):
        res = residuals[name]
        if res.ndim == 1:
            res = res[:, None]
        x = np.arange(res.shape[-1])
        for q in quantiles:
            ax.fill_between(x, 0, np.quantile(res, q, axis=0), alpha=0.3, label=f'{100 * q:.0f}%')
        ax.set_yscale('log')
        ax.set_title(name, fontsize=9)
        ax.legend(fontsize=7)
    fig.tight_layout()
    if fn:
        utils.mkdir(os.path.dirname(str(fn)))
        fig.savefig(fn, dpi=120)
    return fig


def _emulated_predictions(emulated_samples, X, section, take=None, device=None):
    """Predictions of ``emulated_samples`` at input points ``X`` (name ->
    (n,) numpy array).

    ``emulated_samples`` may be a Samples (columns read directly, sliced by
    ``take``: absolute row indices matching ``X``), a Cosmology (its
    ``section`` computed for the whole batch through get_calculator, row by
    row where the batch raises) or a batch-first calculator.
    """
    from . import Samples, get_calculator
    from .samples import InputSampler
    if isinstance(emulated_samples, Samples) or (hasattr(emulated_samples, 'keys')
                                                 and not hasattr(emulated_samples, 'get_background')):
        take = take if take is not None else slice(None)
        return {name[2:]: np.asarray(emulated_samples[name])[take] for name in emulated_samples
                if str(name).startswith('Y.')}
    calculator = get_calculator(emulated_samples, section=[section])
    samples = InputSampler(calculator, samples=X, device=device).run()
    return {name[2:]: value for name, value in samples.items() if name.startswith('Y.')}


def _plot_residual_section(ref_samples, emulated_samples, section, quantities=None,
                           subsample=1.0, q=(0.68, 0.95, 0.99), fn=None, relative=True):
    """Quantile bands of the (relative) emulation error per quantity of a
    section, evaluated at the reference sample points."""
    ntotal = ref_samples.size if hasattr(ref_samples, 'size') else len(next(iter(ref_samples.values())))
    finite = ref_samples.isfinite() if hasattr(ref_samples, 'isfinite') else np.ones(ntotal, dtype=bool)
    X = {name[2:]: np.asarray(ref_samples[name])[finite] for name in ref_samples if str(name).startswith('X.')}
    ref_samples = {name: np.asarray(value)[finite] for name, value in ref_samples.items()}
    npoints = len(next(iter(X.values())))
    if subsample < 1.0:
        rng = np.random.default_rng(11)
        index = np.sort(rng.choice(npoints, size=max(1, int(subsample * npoints)), replace=False))
        X = {name: value[index] for name, value in X.items()}
    else:
        index = np.arange(npoints)
    # absolute row indices into the unfiltered samples, for column-served
    # prediction sources
    take = np.flatnonzero(finite)[index]
    pred = _emulated_predictions(emulated_samples, X, section, take=take)
    residuals = {}
    for name in ref_samples:
        name = str(name)
        if not name.startswith(f'Y.{section}.'):
            continue
        qname = name[2:]
        if quantities is not None and qname[len(section) + 1:] not in quantities:
            continue
        if qname not in pred:
            continue
        truth = np.asarray(ref_samples[name])[index]
        guess = np.asarray(pred[qname])
        if truth.size == 0 or guess.shape != truth.shape:
            continue
        scale = np.maximum(np.abs(truth), 1e-30) if relative else 1.0
        residuals[qname] = np.abs(guess - truth) / scale
    return plot_residuals(residuals, fn=fn, quantiles=q)


def plot_residual_background(ref_samples, emulated_samples, quantities=None, subsample=1.0,
                             q=(0.68, 0.95, 0.99), color='C0', fn=None):
    """Background-section residual bands."""
    return _plot_residual_section(ref_samples, emulated_samples, 'background',
                                  quantities=quantities, subsample=subsample, q=q, fn=fn)


def plot_residual_thermodynamics(ref_samples, emulated_samples, quantities=None, subsample=1.0,
                                 q=(0.68, 0.95, 0.99), color='C0', fn=None):
    """Thermodynamics-section residual bands."""
    return _plot_residual_section(ref_samples, emulated_samples, 'thermodynamics',
                                  quantities=quantities, subsample=subsample, q=q, fn=fn)


def plot_residual_primordial(ref_samples, emulated_samples, quantities=None, subsample=1.0, fn=None):
    """Primordial-section residual bands."""
    return _plot_residual_section(ref_samples, emulated_samples, 'primordial',
                                  quantities=quantities, subsample=subsample, fn=fn)


def plot_residual_harmonic(ref_samples, emulated_samples, quantities=None, fsky=1.0, subsample=1.0,
                           q=(0.68, 0.95, 0.99), color='C0', fn=None):
    """Cl residual bands; ``fsky`` kept for the reference's signature."""
    return _plot_residual_section(ref_samples, emulated_samples, 'harmonic',
                                  quantities=quantities, subsample=subsample, q=q, fn=fn)


def plot_residual_fourier(ref_samples, emulated_samples, quantities=None, iz=0, volume=1e9,
                          kstep=5e-3, subsample=1.0, q=(0.68, 0.95, 0.99), color='C0', fn=None):
    """pk residual bands; ``iz``/``volume``/``kstep`` kept for the
    reference's signature."""
    return _plot_residual_section(ref_samples, emulated_samples, 'fourier',
                                  quantities=quantities, subsample=subsample, q=q, fn=fn)
