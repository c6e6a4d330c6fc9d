"""The port's samplers and ``get_calculator``
(cosmoprimo_tpu_torch/emulators/samples.py, emulators/__init__.py) against
the JAX package's, on the CPU.

- Points (rqrs, sobol, halton, lhs, grid, diff, input): equal exactly,
  numpy in both packages.
- Runs of a batch-first calculator against the JAX package's per-point
  runs of the same function: X columns equal exactly, Y within 1e-14 of
  each row's max (torch and numpy sin/exp; measured <= 4.0e-16); NaN rows
  in the same places, a chunk with one failing row included; the same
  checkpoint file after an interrupted run, and the same samples after
  resuming from it; ``reparam`` as the JAX package's own test writes one;
  the port's files read by the JAX ``Samples``; one call per chunk equal
  to one call per row.
- ``get_calculator`` on eisenstein_hu (every section) and the EH99
  variants engine (fourier): the same names and shapes, each row against
  the JAX calculator at that point within 1e-10 of its max (measured
  <= 1.1e-15); a call leaves no reference cycle that holds a tensor.
"""

import gc

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from cosmoprimo_tpu import Cosmology as JCosmology  # noqa: E402
from cosmoprimo_tpu.emulators import get_calculator as jget_calculator  # noqa: E402
from cosmoprimo_tpu.emulators import samples as jsamples  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology  # noqa: E402
from cosmoprimo_tpu_torch.emulators import (CalculatorComputationError, DiffSampler, GridSampler,  # noqa: E402
                                            InputSampler, QMCSampler, get_calculator)
from cosmoprimo_tpu_torch.emulators import samples  # noqa: E402

PARAMS = {'a': (0.8, 1.2), 'b': (-0.2, 0.2)}
Y_BAR = 1e-14
CALCULATOR_BAR = 1e-10


def toy(a, b):
    """Batch-first: each parameter (n,), each output (n,) + its shape."""
    x = torch.linspace(0.0, 1.0, 10, dtype=torch.float64, device=a.device)
    return {'x': x.expand(a.shape + (10,)), 'y': a[:, None] * torch.sin(3 * x) + b[:, None] * x ** 2,
            'z': a ** 2 + torch.exp(b)}


def jtoy(a=1.0, b=0.0):
    """The JAX package's per-point form of :func:`toy`."""
    x = np.linspace(0.0, 1.0, 10)
    return {'x': x, 'y': a * np.sin(3 * x) + b * x ** 2, 'z': a ** 2 + np.exp(b)}


def failing(threshold, jax_side=False):
    """:func:`toy` (or :func:`jtoy`) raising CalculatorComputationError for
    a > threshold: a batch raises if one of its rows would."""
    if jax_side:
        def calc(a=1.0, b=0.0):
            if a > threshold:
                raise jsamples.CalculatorComputationError
            return jtoy(a, b)
        return calc

    def calc(a, b):
        if bool((a > threshold).any()):
            raise CalculatorComputationError
        return toy(a, b)
    return calc


def assert_same_samples(got, ref):
    assert set(got) == set(ref)
    for name in ref:
        g, r = np.asarray(got[name]), np.asarray(ref[name])
        assert g.shape == r.shape, name
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        if name.startswith('X.'):
            np.testing.assert_array_equal(g, r)
        else:
            finite = ~np.isnan(r.reshape(len(r), -1)).any(axis=-1)
            g, r = g[finite].reshape(finite.sum(), -1), r[finite].reshape(finite.sum(), -1)
            if r.size:
                assert np.max(np.abs(g - r).max(axis=-1) / np.abs(r).max(axis=-1)) <= Y_BAR, name


@pytest.mark.parametrize('engine,seed', [('rqrs', None), ('sobol', 3), ('halton', 4), ('lhs', 7)])
def test_qmc_points_equal(engine, seed):
    params = {'a': (0.8, 1.2), 'b': (-0.2, 0.2), 'c': (2.0, 3.0)}
    got = QMCSampler(toy, params, engine=engine, seed=seed, device='cpu').points(niterations=32)
    ref = jsamples.QMCSampler(jtoy, params, engine=engine, seed=seed).points(niterations=32)
    for name in params:
        np.testing.assert_array_equal(got[name], ref[name])


def test_grid_diff_input_points_equal():
    got, ref = GridSampler(toy, PARAMS, device='cpu').points(ngrid=4), jsamples.GridSampler(jtoy, PARAMS).points(ngrid=4)
    for name in PARAMS:
        np.testing.assert_array_equal(got[name], ref[name])
    sampler, jsampler = DiffSampler(toy, PARAMS, device='cpu'), jsamples.DiffSampler(jtoy, PARAMS)
    got, ref = sampler.points(order=3, accuracy=2), jsampler.points(order=3, accuracy=2)
    for name in PARAMS:
        np.testing.assert_array_equal(got[name], ref[name])
        assert sampler.center[name] == jsampler.center[name] and sampler.deltas[name] == jsampler.deltas[name]
    np.testing.assert_array_equal(sampler.offsets, jsampler.offsets)
    points = {'a': np.array([0.9, 1.1]), 'b': np.array([0.0, 0.1])}
    got = InputSampler(toy, samples=points, device='cpu').run()
    ref = jsamples.InputSampler(jtoy, samples=points).run()
    assert_same_samples(got, ref)


@pytest.mark.parametrize('chunk_size', [1, 5, 64])
def test_runs_against_per_point(chunk_size):
    """One call a chunk of 1, 5 or all rows: the JAX package's per-point
    samples; the attrs too."""
    got = QMCSampler(toy, PARAMS, engine='lhs', seed=2, chunk_size=chunk_size, device='cpu').run(niterations=23)
    ref = jsamples.QMCSampler(jtoy, PARAMS, engine='lhs', seed=2).run(niterations=23)
    assert_same_samples(got, ref)
    assert got.attrs == ref.attrs


@pytest.mark.parametrize('chunk_size', [1, 4, 100])
def test_nan_rows(chunk_size):
    """Rows whose calculator raises become NaN rows; a chunk holding one
    failing row keeps its other rows."""
    got = QMCSampler(failing(1.1), PARAMS, chunk_size=chunk_size, device='cpu').run(niterations=17)
    ref = jsamples.QMCSampler(failing(1.1, jax_side=True), PARAMS).run(niterations=17)
    nan = np.isnan(got['Y.z'])
    assert 0 < nan.sum() < 17 and not np.isnan(got['X.a']).any()
    assert_same_samples(got, ref)
    with pytest.raises(ValueError, match='All calculator evaluations failed'):
        QMCSampler(failing(0.0), PARAMS, chunk_size=chunk_size, device='cpu').run(niterations=5)


class Interrupt(Exception):
    pass


def interrupted(calc, after, jax_side=False):
    """``calc`` raising Interrupt once ``after`` points have been computed."""
    done = [0]

    def wrapper(**params):
        n = 1 if jax_side else len(params['a'])
        if done[0] + n > after:
            raise Interrupt
        done[0] += n
        return calc(**params)
    return wrapper


def test_checkpoint_and_resume(tmp_path):
    """An interrupted run leaves the same checkpoint as the JAX package's
    (save_every counts points; chunks of 2 here), and resuming from it
    gives the uninterrupted run's samples."""
    files = {}
    for side, make in (('port', lambda calc, fn: QMCSampler(calc, PARAMS, save_fn=fn, save_every=4, chunk_size=2,
                                                            device='cpu')),
                       ('jax', lambda calc, fn: jsamples.QMCSampler(calc, PARAMS, save_fn=fn, save_every=4))):
        fn = str(tmp_path / f'{side}.npy')
        with pytest.raises(Interrupt):
            make(interrupted(toy if side == 'port' else jtoy, 10, jax_side=side == 'jax'), fn).run(niterations=13)
        files[side] = fn
    checkpoint, jcheckpoint = samples.Samples.read(files['port']), jsamples.Samples.read(files['jax'])
    assert checkpoint.size == jcheckpoint.size == 8
    assert_same_samples(checkpoint, jcheckpoint)
    got = QMCSampler(toy, PARAMS, save_fn=files['port'], save_every=4, chunk_size=2,
                     device='cpu').run(niterations=13, resume_from=files['port'])
    ref = jsamples.QMCSampler(jtoy, PARAMS).run(niterations=13)
    assert got.size == 13
    assert_same_samples(got, ref)


def test_reparam():
    """The X columns record the sampled coordinates; the calculator sees
    reparam(X); the JAX package's test writes this per-point function."""
    def reparam(X):
        X = dict(X)
        X['b'] = X.pop('bp') - 1.0
        return X

    box = {'a': (0.8, 1.2), 'bp': (0.9, 1.1)}
    got = QMCSampler(toy, box, engine='rqrs', reparam=reparam, chunk_size=3, device='cpu').run(niterations=8)
    ref = jsamples.QMCSampler(jtoy, box, engine='rqrs', reparam=reparam).run(niterations=8)
    assert 'X.bp' in got and 'X.b' not in got
    assert_same_samples(got, ref)


def test_files_read_by_jax(tmp_path):
    got = QMCSampler(failing(1.1), PARAMS, device='cpu').run(niterations=9)
    fn = str(tmp_path / 'samples.npy')
    got.write(fn)
    ref = jsamples.Samples.read(fn)
    assert ref.attrs == got.attrs
    for name in got:
        np.testing.assert_array_equal(ref[name], got[name])


def test_default_device_is_the_card(monkeypatch):
    """Without a device named, a sampler runs on the CUDA card, and raises
    without one."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        QMCSampler(toy, PARAMS).run(niterations=2)


def check_calculator(engine, section, points):
    jcalc = jget_calculator(JCosmology(engine=engine), section=section)
    calc = get_calculator(Cosmology(engine=engine, device='cpu'), section=section)
    assert calc.device == torch.device('cpu')
    got = calc(**{name: torch.from_numpy(value) for name, value in points.items()})
    n = len(next(iter(points.values())))
    for i in range(n):
        ref = jcalc(**{name: float(value[i]) for name, value in points.items()})
        assert set(got) == set(ref)
        for name, value in ref.items():
            value = np.asarray(value)
            row = got[name][i].numpy()
            assert row.shape == value.shape, name
            if value.size:
                assert np.max(np.abs(row - value)) <= CALCULATOR_BAR * np.max(np.abs(value)), name
    return got


def test_get_calculator_against_jax():
    """eisenstein_hu, every section (its fixed grids expanded to the batch),
    and the variants engine's fourier, on 2 points each."""
    points = {'omega_cdm': np.array([0.11, 0.13]), 'h': np.array([0.65, 0.72]), 'logA': np.array([3.0, 3.1])}
    got = check_calculator('eisenstein_hu', None, points)
    assert {'background.z', 'thermodynamics.rs_drag', 'primordial.A_s', 'fourier.k'} <= set(got)
    assert got['fourier.k'].shape[0] == 2
    check_calculator('eisenstein_hu_nowiggle_variants', ['fourier'], {name: value[:1] for name, value in points.items()})
    with pytest.raises(CalculatorComputationError):
        get_calculator(Cosmology(engine='eisenstein_hu', device='cpu'), section=['background'])(
            omega_b=torch.tensor([0.02, 0.022], dtype=torch.float64), Omega_b=torch.tensor([0.04, 0.05], dtype=torch.float64))


def test_get_calculator_leaves_no_cycle():
    """A call's sections and engine are freed when the call returns, not at
    the collector's next full pass: with the collector off, a call leaves
    no garbage in cycles that holds a tensor (each row of a sampling loop
    on the card would otherwise keep its tables until then)."""
    calculator = get_calculator(Cosmology(engine='eisenstein_hu', device='cpu'))
    h = torch.tensor([0.65, 0.72], dtype=torch.float64)
    gc.collect()
    gc.disable()
    try:
        got = calculator(h=h)
        del got
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [type(o).__name__ for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
        gc.collect()
    assert held == []
