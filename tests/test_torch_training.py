"""The port's emulator training surface (cosmoprimo_tpu_torch/emulators/
base.py ``Emulator.set_samples``/``fit``, taylor.py, plotting.py,
train/recipes.py, train/train_boltzmann.py, train/train_analytic.py)
against the JAX package's, on the CPU.

- Taylor: derivatives, powers and center fitted by both packages on the
  same DiffSampler samples, within 1e-12 of each array's max (measured 0:
  the same numpy fit); the Point engine's prediction equal.
- ``Emulator.set_samples`` with the emulator-level FourierNormOperation on
  eisenstein_hu fourier samples (the batch-first form in the port, the
  JAX package's vmap over rows): the processed tables per row within 1e-12
  of each row's max (measured <= 7.2e-14), the same fixed outputs.
- The recipes equal the JAX package's (data, operation states, engines).
- ``train_boltzmann`` sample + fit (eisenstein_hu thermodynamics, --stop 6
  --epochs 3 --device cpu), and the 'native-base' recipe's thermodynamics
  on eisenstein_hu: the file read by the JAX ``Emulator.read``, whose
  predictions agree with the port's within 1e-12 of each row's max
  (measured <= 1.3e-16); ``--todo plot`` (where matplotlib is installed); the CLI in a process where ``import jax`` fails;
  without --device the CLI runs on the card, and raises without one.
- ``train_analytic`` at a tiny size (MLP and Point), its file read by the
  JAX package.
- ``compute_residuals`` against the JAX package's on the same emulator
  file and calculator, within 1e-12 (measured 0, both numpy); the plot
  helpers on a NaN row, and their ImportError without matplotlib.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from cosmoprimo_tpu.emulators import Emulator as JEmulator  # noqa: E402
from cosmoprimo_tpu.emulators import FourierNormOperation as JFourierNorm  # noqa: E402
from cosmoprimo_tpu.emulators import MLPEmulatorEngine as JMLPEngine  # noqa: E402
from cosmoprimo_tpu.emulators import PointEmulatorEngine as JPointEngine  # noqa: E402
from cosmoprimo_tpu.emulators import Samples as JSamples  # noqa: E402
from cosmoprimo_tpu.emulators import TaylorEmulatorEngine as JTaylorEngine  # noqa: E402
from cosmoprimo_tpu.emulators.plotting import compute_residuals as jcompute_residuals  # noqa: E402
from cosmoprimo_tpu.emulators.train import recipes as jrecipes  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology  # noqa: E402
from cosmoprimo_tpu_torch.emulators import (Emulator, FourierNormOperation, MLPEmulatorEngine,  # noqa: E402
                                            PointEmulatorEngine, Samples, TaylorEmulatorEngine, get_calculator)
from cosmoprimo_tpu_torch.emulators.plotting import compute_residuals  # noqa: E402
from cosmoprimo_tpu_torch.emulators.train import recipes, train_analytic, train_boltzmann  # noqa: E402

REPO = chip_smoke.__file__.rsplit('/', 1)[0]
BAR = 1e-12
PARAMS = {'a': (0.8, 1.2), 'b': (-0.2, 0.2)}


def toy(a, b):
    x = torch.linspace(0.0, 1.0, 10, dtype=torch.float64, device=a.device)
    return {'x': x.expand(a.shape + (10,)), 'y': a[:, None] * torch.sin(3 * x) + b[:, None] * x ** 2,
            'z': a ** 2 + torch.exp(b)}


def jtoy(a=1.0, b=0.0):
    x = np.linspace(0.0, 1.0, 10)
    return {'x': x, 'y': a * np.sin(3 * x) + b * x ** 2, 'z': a ** 2 + np.exp(b)}


def rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def row_err(got, ref):
    got, ref = np.asarray(got).reshape(len(ref), -1), np.asarray(ref).reshape(len(ref), -1)
    return float(np.max(np.max(np.abs(got - ref), axis=1) / np.max(np.abs(ref), axis=1)))


def predictions(fn, points):
    """(port, JAX) predictions of the emulator file ``fn`` at ``points``."""
    got = Emulator.read(fn).predict({name: torch.from_numpy(value) for name, value in points.items()})
    ref = jax.vmap(JEmulator.read(fn).predict)({name: jnp.asarray(value) for name, value in points.items()})
    return got, ref


def test_taylor_and_point_against_jax():
    emulator = Emulator(calculator=toy, params=PARAMS, engine=TaylorEmulatorEngine(order=3), device='cpu')
    samples, _ = emulator.set_samples()
    emulator.fit()
    jemulator = JEmulator(engine=JTaylorEngine(order=3))
    jemulator.set_samples(samples=JSamples(dict(samples), attrs=samples.attrs))
    jemulator.fit()
    # the port's samples are the JAX package's DiffSampler points
    jsamples, _ = JEmulator(calculator=jtoy, params=PARAMS, engine=JTaylorEngine(order=3)).set_samples()
    np.testing.assert_array_equal(samples['X.a'], jsamples['X.a'])
    assert samples.attrs == jsamples.attrs
    for name in ('y', 'z'):
        engine, jengine = emulator.engines[name], jemulator.engines[name]
        np.testing.assert_array_equal(engine.powers, jengine.powers)
        assert rel(engine.center, jengine.center) == 0.0
        assert rel(engine.derivatives, jengine.derivatives) <= BAR
    assert set(emulator.fixed) == {'x'}
    # Point: the first sample, served
    point = Emulator(calculator=toy, params=PARAMS, engine=PointEmulatorEngine(), device='cpu')
    point.set_samples()
    point.fit()
    jpoint = JEmulator(calculator=jtoy, params=PARAMS, engine=JPointEngine())
    jpoint.set_samples()
    jpoint.fit()
    np.testing.assert_allclose(point.engines['y'].point, jpoint.engines['y'].point, rtol=1e-15)


def fourier_samples(n=3):
    calc = get_calculator(Cosmology(engine='eisenstein_hu', device='cpu'), section=['fourier'])
    rng = np.random.default_rng(4)
    X = {'omega_cdm': rng.uniform(0.1, 0.14, n), 'h': rng.uniform(0.6, 0.75, n), 'logA': rng.uniform(2.9, 3.1, n)}
    state = calc(**{name: torch.from_numpy(value) for name, value in X.items()})
    return Samples({**{'X.' + name: value for name, value in X.items()},
                    **{'Y.' + name: value.numpy() for name, value in state.items()}})


def test_set_samples_fourier_norm_against_jax():
    """The emulator-level FourierNormOperation applied to the whole batch
    (the port) and to each row under jax.vmap (the JAX package)."""
    samples = fourier_samples()
    emulator = Emulator(engine={'fourier.*': MLPEmulatorEngine(nhidden=(4,))}, device='cpu')
    emulator.yoperations = [FourierNormOperation()]
    _, processed = emulator.set_samples(samples=samples)
    jemulator = JEmulator(engine={'fourier.*': JMLPEngine(nhidden=(4,))})
    jemulator.yoperations = [JFourierNorm()]
    _, jprocessed = jemulator.set_samples(samples=JSamples(dict(samples)))
    assert set(processed) == set(jprocessed) and set(emulator.fixed) == set(jemulator.fixed)
    assert {'fourier.k', 'fourier.z'} <= set(emulator.fixed)
    for name, value in jemulator.fixed.items():
        np.testing.assert_allclose(emulator.fixed[name], value, rtol=BAR, atol=0)
    assert set(emulator._init_engines) == set(jemulator._init_engines)
    assert emulator.yoperations[0].norm_pk_names == jemulator.yoperations[0].norm_pk_names
    for name in jprocessed:
        assert processed[name].shape == jprocessed[name].shape, name
        assert row_err(processed[name], jprocessed[name]) <= BAR, name


def test_recipes_equal_jax():
    assert recipes.RECIPES == jrecipes.RECIPES
    assert recipes._OPS.keys() == jrecipes._OPS.keys()
    ops = ['log10', 'cl_norm', 'cl_norm_tilt', 'fourier_norm']
    for op, jop in zip(recipes.resolve_yoperations(ops), jrecipes.resolve_yoperations(ops)):
        if isinstance(op, str):
            assert op == jop
        else:
            state, jstate = op.__getstate__(), jop.__getstate__()
            assert state.keys() == jstate.keys() and state['_direct'] == jstate['_direct']
            for name, value in jstate['_locals'].items():
                np.testing.assert_array_equal(state['_locals'][name], value)
    samples = {'Y.background.time': np.zeros((2, 5)), 'Y.background.z_star': np.zeros(2), 'X.h': np.zeros(2)}
    for spec in (recipes.RECIPES['native-base']['sections'][section]['engines'] for section in ('background',
                                                                                              'fourier')):
        engines, jengines = recipes.build_engines(spec, samples=samples), jrecipes.build_engines(spec, samples=samples)
        assert engines.keys() == jengines.keys()
        for name, engine in engines.items():
            jengine = jengines[name]
            assert (engine.nhidden, engine.activation) == (jengine.nhidden, jengine.activation)
            assert [op.name for op in engine.yoperations] == [op.name for op in jengine.yoperations]


def test_train_boltzmann_cli(tmp_path):
    """Sample and fit through the CLI entry on the CPU; the JAX package
    reads the file and predicts what the port does."""
    out = str(tmp_path)
    common = ['--engine', 'eisenstein_hu', '--config', 'base', '--section', 'thermodynamics', '--outdir', out,
              '--device', 'cpu']
    samples = train_boltzmann.main(['--todo', 'sample', '--stop', '6', '--chunk-size', '4'] + common)
    fn = tmp_path / 'eisenstein_hu_base' / 'samples.npy'
    assert samples.size == 6 and 'Y.thermodynamics.rs_drag' in Samples.read(str(fn))
    np.testing.assert_array_equal(JSamples.read(str(fn))['X.h'], samples['X.h'])
    emulator = train_boltzmann.main(['--todo', 'fit', '--epochs', '3'] + common)
    assert [h['epochs'] for h in emulator.engines['thermodynamics.rs_drag'].history] == [3] * 4
    points = {name: np.linspace(lo, hi, 3) for name, (lo, hi) in train_boltzmann.CONFIGS['base'].items()}
    got, ref = predictions(str(tmp_path / 'eisenstein_hu_base' / 'emulator.npy'), points)
    for name in ('thermodynamics.rs_drag', 'thermodynamics.z_drag'):
        assert np.isfinite(got[name].numpy()).all() and row_err(got[name].numpy()[:, None], ref[name][:, None]) <= BAR
    if importlib.util.find_spec('matplotlib') is not None:
        # the residual bands of the samples against the file served as engine='emulated'
        train_boltzmann.main(['--todo', 'plot'] + common)
        assert (tmp_path / 'eisenstein_hu_base' / 'thermodynamics.png').exists()


def test_native_base_recipe_on_analytic_engine(tmp_path):
    """The recipe path (its box, sampler, schedule) with --engine
    eisenstein_hu: the fit's four stages and a file the JAX package reads."""
    common = ['--recipe', 'native-base', '--section', 'thermodynamics', '--engine', 'eisenstein_hu', '--outdir',
              str(tmp_path), '--device', 'cpu']
    samples = train_boltzmann.main(['--todo', 'sample', '--stop', '12'] + common)
    assert set(samples.columns('X.*')) == {'X.' + name for name in
                                           recipes.RECIPES['native-base']['sections']['thermodynamics']['params']}
    emulator = train_boltzmann.main(['--todo', 'fit', '--epochs', '2'] + common)
    assert [len(e.history) for e in emulator.engines.values()] == [4, 4]
    box = recipes.RECIPES['native-base']['sections']['thermodynamics']['params']
    got, ref = predictions(str(tmp_path / 'native-base_thermodynamics' / 'emulator.npy'),
                           {name: np.linspace(lo, hi, 2) for name, (lo, hi) in box.items()})
    assert row_err(got['thermodynamics.rs_drag'].numpy()[:, None], ref['thermodynamics.rs_drag'][:, None]) <= BAR


def test_cli_default_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_boltzmann.main(['--todo', 'sample', '--engine', 'eisenstein_hu', '--stop', '2', '--outdir',
                              str(tmp_path)])


def test_cli_without_jax(tmp_path):
    code = ('import sys, json; sys.modules["jax"] = None\n'
            'from cosmoprimo_tpu_torch.emulators.train import train_boltzmann\n'
            f'args = ["--engine", "eisenstein_hu", "--config", "base", "--section", "thermodynamics", "--outdir", '
            f'{str(tmp_path)!r}, "--device", "cpu"]\n'
            'train_boltzmann.main(["--todo", "sample", "--stop", "4"] + args)\n'
            'train_boltzmann.main(["--todo", "fit", "--epochs", "2"] + args)\n'
            'bad = [m for m, module in sys.modules.items() if module is not None and (m in ("jax", "flax", "optax",\n'
            '       "cosmoprimo_tpu") or m.startswith(("jax.", "flax.", "optax.", "cosmoprimo_tpu.")))]\n'
            'print(json.dumps(bad))\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, 'PYTHONPATH': REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert (tmp_path / 'eisenstein_hu_base' / 'emulator.npy').exists()


@pytest.mark.parametrize('kind', ['mlp', 'point'])
def test_train_analytic(tmp_path, kind):
    fn = str(tmp_path / 'emulator.npy')
    emulator = train_analytic.main(['--section', 'thermodynamics', '--niterations', '8', '--epochs', '2',
                                    '--nparams', '2', '--emulator-engine', kind, '--output', fn, '--device', 'cpu'])
    assert set(emulator.engines) == {'thermodynamics.rs_drag', 'thermodynamics.z_drag'}
    got, ref = predictions(fn, {'omega_cdm': np.array([0.1, 0.15]), 'omega_b': np.array([0.02, 0.022])})
    assert row_err(got['thermodynamics.rs_drag'].numpy()[:, None], ref['thermodynamics.rs_drag'][:, None]) <= BAR


def test_compute_residuals_against_jax(tmp_path):
    emulator = Emulator(calculator=toy, params=PARAMS, engine=TaylorEmulatorEngine(order=2), device='cpu')
    emulator.set_samples()
    emulator.fit()
    fn = str(tmp_path / 'toy.npy')
    emulator.write(fn)
    got = compute_residuals(Emulator.read(fn), toy, PARAMS, ntest=7, seed=3, device='cpu')
    ref = jcompute_residuals(JEmulator.read(fn), jtoy, PARAMS, ntest=7, seed=3)
    assert set(got) == set(ref) == {'x', 'y', 'z'}
    for name in ref:
        assert got[name].shape == ref[name].shape
        assert np.max(np.abs(got[name] - ref[name])) <= BAR


def test_residual_plots(tmp_path, monkeypatch):
    """The plot helpers with a NaN reference row and a column-served
    prediction source (the JAX package's test of them); without matplotlib
    they raise an ImportError that names it."""
    pytest.importorskip('matplotlib')
    from cosmoprimo_tpu_torch.emulators import plotting
    ref = Samples({'X.omega_cdm': np.array([0.11, 0.12, 0.13]),
                   'Y.thermodynamics.rs_drag': np.array([148.0, np.nan, 146.0])})
    emu = Samples({'X.omega_cdm': np.array([0.11, 0.12, 0.13]),
                   'Y.thermodynamics.rs_drag': np.array([148.1, 147.0, 145.8])})
    plotting.plot_residual_thermodynamics(ref, emu, fn=str(tmp_path / 'thermo.png'))
    assert (tmp_path / 'thermo.png').exists()
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='matplotlib'):
        plotting.plot_residuals({'a': np.ones((2, 3))})
