"""The port's MLP network and its training (cosmoprimo_tpu_torch/emulators/
mlp.py) against the JAX package's flax network, optax's Adam and the
engine's staged fit, on the CPU, weights carried across as numpy.

- Forward: the module against flax ``MLP.apply`` for every activation and
  with batch normalization, in training and in evaluation mode, the running
  averages after training steps included. Bar 1e-13 of each output's max
  (measured <= 8.3e-16). One departure: evaluating with the untouched
  float32 running averages (before any training step) takes rsqrt(1 + 1e-5)
  in float32, where XLA's float32 rsqrt is one ulp off the correctly
  rounded value that torch gives; bar 1e-6, a few float32 ulps, there
  (measured <= 1.4e-7).
- Adam: 10 steps on contiguous batches from the same weights, with a
  constant rate and with the cosine schedule, against optax's adam: every
  parameter and running average within 1e-12 of its tensor's max (measured
  <= 9.3e-14).
- The staged fit: ``_fit_no_operation`` with the port's initializer patched
  to load the flax initialization, two stages, the second stopping early:
  the same splits, batch sizes and epochs run in each stage, and the
  exported operations within 1e-9 of each array's max (measured <= 2.9e-13,
  with batch normalization).
- flax's initialization distribution; ``mesh=`` refused; a fit in a process
  where ``import jax`` fails.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import chip_smoke  # noqa: E402
from cosmoprimo_tpu.emulators import mlp as jmlp  # noqa: E402
from cosmoprimo_tpu_torch.emulators import mlp  # noqa: E402

REPO = chip_smoke.__file__.rsplit('/', 1)[0]
FORWARD_BAR = 1e-13
FLOAT32_START_BAR = 1e-6
ADAM_BAR = 1e-12
EXPORT_BAR = 1e-9
ACTIVATIONS = ('silu', 'relu', 'tanh', 'identity-silu')


def data(seed=0, n=64, nin=3, nout=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, nin)), rng.normal(size=(n, nout))


def networks(activation, batch_norm, X, seed=1):
    """(flax module, its numpy params and batch_stats, the port's module
    carrying them); identity-silu's alpha, beta moved off their zero
    start."""
    jm = jmlp.MLP(features=(8, 8, 5), activation=(activation,) * 2, batch_norm=batch_norm)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(X[:1]))
    params = jax.tree_util.tree_map(np.asarray, variables['params'])
    stats = jax.tree_util.tree_map(np.asarray, variables.get('batch_stats', {}))
    if activation == 'identity-silu':
        params.update(alpha_0=np.array(0.7), beta_0=np.array(0.4), alpha_1=np.array(-0.3), beta_1=np.array(1.2))
    model = mlp.load_flax_variables(mlp.MLP(X.shape[1], (8, 8, 5), (activation,) * 2, batch_norm=batch_norm),
                                    params, stats)
    return jm, params, stats, model


def rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def tree_err(got, ref):
    """max over leaves of :func:`rel`, the two trees of the same layout."""
    leaves, refs = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)
    assert len(leaves) == len(refs)
    return max(rel(g, r) for g, r in zip(leaves, refs))


@pytest.mark.parametrize('activation', ACTIVATIONS)
@pytest.mark.parametrize('batch_norm', [False, True])
def test_forward_against_flax(activation, batch_norm):
    X, Y = data()
    jm, params, stats, model = networks(activation, batch_norm, X)
    model.eval()
    ref = jm.apply({'params': params, 'batch_stats': stats}, jnp.asarray(X))
    got = model(torch.from_numpy(X)).detach().numpy()
    assert rel(got, ref) <= (FLOAT32_START_BAR if batch_norm else FORWARD_BAR)
    if not batch_norm:
        return
    # training mode: the batch's statistics, and the running averages they move
    model.train()
    variables = {'params': params, 'batch_stats': stats}
    for i in range(3):
        x = jnp.asarray(X[16 * i:16 * (i + 1)])
        ref, mutated = jm.apply(variables, x, train=True, mutable=['batch_stats'])
        variables = {'params': params, 'batch_stats': mutated['batch_stats']}
        got = model(torch.from_numpy(X[16 * i:16 * (i + 1)])).detach().numpy()
        assert rel(got, ref) <= FORWARD_BAR
        assert tree_err(mlp.flax_variables(model)[1], mutated['batch_stats']) <= FORWARD_BAR
    # evaluation on the moved (float64) running averages
    model.eval()
    assert rel(model(torch.from_numpy(X)).detach().numpy(), jm.apply(variables, jnp.asarray(X))) <= FORWARD_BAR


@pytest.mark.parametrize('activation,batch_norm', [('silu', False), ('tanh', True), ('identity-silu', True)])
@pytest.mark.parametrize('schedule', [False, True])
def test_adam_against_optax(activation, batch_norm, schedule):
    """10 Adam steps on contiguous batches of 8 rows, from the same weights."""
    X, Y = data(seed=2)
    jm, params, stats, model = networks(activation, batch_norm, X)
    lr = 1e-2
    tx = optax.adam(optax.cosine_decay_schedule(lr, 10) if schedule else lr)
    jparams, jstats = jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, stats)
    opt_state = tx.init(jparams)
    jstep = jmlp.make_train_step(jm, tx)
    rate = mlp.cosine_decay_schedule(lr, 10) if schedule else lr
    step = mlp.make_train_step(model, mlp.make_adam(model, rate), rate)
    model.train()
    for i in range(10):
        sl = slice(8 * (i % 8), 8 * (i % 8 + 1))
        jparams, jstats, opt_state, _ = jstep(jparams, jstats, opt_state, jnp.asarray(X[sl]), jnp.asarray(Y[sl]))
        step(torch.from_numpy(X[sl]), torch.from_numpy(Y[sl]))
    got_params, got_stats = mlp.flax_variables(model)
    assert tree_err(got_params, jparams) <= ADAM_BAR
    if batch_norm:
        assert tree_err(got_stats, jstats) <= ADAM_BAR


def test_cosine_schedule_against_optax():
    schedule, ref = mlp.cosine_decay_schedule(3e-2, 17), optax.cosine_decay_schedule(3e-2, 17)
    for count in (0, 1, 8, 16, 17, 30):
        assert abs(schedule(count) - float(ref(count))) <= 1e-17


def fit_both(batch_norm, monkeypatch):
    """(JAX engine, its steps per stage, port engine) fitted with the same
    schedule; the port's initializer loads the flax initialization."""
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(60, 2))
    Y = np.stack([np.sin(3 * X[:, 0]) + X[:, 1] ** 2, np.cos(2 * X[:, 1]) * X[:, 0], X[:, 0] * X[:, 1]], axis=-1)
    kwargs = dict(batch_frac=(0.25, 1.0), epochs=(40, 30), learning_rate=(3e-2, 0.2), patience=(40, 3),
                  batch_norm=batch_norm, seed=5, learning_rate_scheduling=True)
    steps = []
    make_train_step = jmlp.make_train_step

    def counting(*args, **kw):
        step = make_train_step(*args, **kw)
        steps.append(0)

        def counted(*a):
            steps[-1] += 1
            return step(*a)
        return counted

    monkeypatch.setattr(jmlp, 'make_train_step', counting)
    jengine = jmlp.MLPEmulatorEngine(nhidden=(8, 8), activation='tanh')
    jengine.initialize(['a', 'b'])
    jengine._fit_no_operation(X, Y, {}, **kwargs)

    variables = jmlp.MLP(features=(8, 8, 3), activation=('tanh', 'tanh'), batch_norm=batch_norm).init(
        jax.random.PRNGKey(5), jnp.ones((1, 2)))
    params = jax.tree_util.tree_map(np.asarray, variables['params'])
    stats = jax.tree_util.tree_map(np.asarray, variables.get('batch_stats', {}))
    monkeypatch.setattr(mlp, 'init_mlp', lambda model, generator: mlp.load_flax_variables(model, params, stats))
    engine = mlp.MLPEmulatorEngine(nhidden=(8, 8), activation='tanh')
    engine.initialize(['a', 'b'], device='cpu')
    engine._fit_no_operation(X, Y, {}, **kwargs)
    return jengine, steps, engine


@pytest.mark.parametrize('batch_norm', [False, True])
def test_staged_fit_against_jax(batch_norm, monkeypatch):
    jengine, steps, engine = fit_both(batch_norm, monkeypatch)
    history = engine.history
    # stage 1 runs its 40 epochs of 3 batches of 14 rows (54 training rows,
    # a partial batch dropped); stage 2 (one batch) stops early
    assert [h['nvalidation'] for h in history] == [6, 6] and [h['batch_size'] for h in history] == [14, 54]
    assert [h['steps'] for h in history] == steps
    assert history[0]['epochs'] == 40 and history[1]['epochs'] < 30
    assert all(np.isfinite(h['best_loss']) for h in history)
    assert len(engine.model_operations) == len(jengine.model_operations)
    for op, jop in zip(engine.model_operations, jengine.model_operations):
        assert op._direct == jop._direct and set(op._locals) == set(jop._locals)
        for name in jop._locals:
            assert rel(op._locals[name], jop._locals[name]) <= EXPORT_BAR


def test_initialization():
    """flax's lecun_normal: kernels within 2 std of sqrt(1 / fan_in) / .8796,
    std near the lecun value; biases zero; the same seed, the same net."""
    model = mlp.MLP(64, (256, 256, 3), ('silu', 'identity-silu'), batch_norm=True)
    mlp.init_mlp(model, torch.Generator().manual_seed(0))
    params, stats = mlp.flax_variables(model)
    kernel = params['layer_1']['kernel']
    std = np.sqrt(1.0 / 256) / 0.87962566103423978
    assert np.abs(kernel).max() <= 2 * std and abs(kernel.std() / np.sqrt(1.0 / 256) - 1) < 0.01
    assert not params['layer_1']['bias'].any() and params['alpha_1'] == 0 and params['beta_1'] == 0
    assert stats['batch_1']['var'].dtype == np.float32 and (stats['batch_1']['var'] == 1).all()
    again = mlp.flax_variables(mlp.init_mlp(mlp.MLP(64, (256, 256, 3), ('silu', 'identity-silu'), batch_norm=True),
                                            torch.Generator().manual_seed(0)))[0]
    np.testing.assert_array_equal(again['layer_0']['kernel'], params['layer_0']['kernel'])


def test_mesh_refused():
    engine = mlp.MLPEmulatorEngine(nhidden=(4,))
    engine.initialize(['a'], device='cpu')
    with pytest.raises(NotImplementedError, match='6c'):
        engine._fit_no_operation(np.zeros((10, 1)), np.zeros((10, 1)), {}, mesh=object())


def test_fit_without_jax(tmp_path):
    """Sample, fit, write, read and predict in a process where ``import
    jax`` fails; nothing of JAX or of the JAX package is imported."""
    code = ('import sys, json; sys.modules["jax"] = None\n'
            'import numpy as np, torch\n'
            'from cosmoprimo_tpu_torch.emulators import Emulator, MLPEmulatorEngine\n'
            'def calc(a, b):\n'
            '    x = torch.linspace(0, 1, 6, dtype=torch.float64)\n'
            '    return {"y": a[:, None] * torch.sin(3 * x) + b[:, None] * x}\n'
            'emu = Emulator(calculator=calc, params={"a": (0.8, 1.2), "b": (-0.2, 0.2)},\n'
            '               engine=MLPEmulatorEngine(nhidden=(8, 8)), device="cpu")\n'
            'emu.set_samples(niterations=40)\n'
            'emu.fit(epochs=5, batch_frac=(0.5, 1.0), learning_rate=(1e-2, 1e-3))\n'
            f'emu.write({str(tmp_path / "emu.npy")!r})\n'
            f'pred = Emulator.read({str(tmp_path / "emu.npy")!r})'
            '.predict({"a": torch.tensor([1.0]), "b": torch.tensor([0.1])})\n'
            'assert pred["y"].shape == (1, 6) and bool(torch.isfinite(pred["y"]).all())\n'
            'bad = [m for m, module in sys.modules.items() if module is not None and (m in ("jax", "flax", "optax",\n'
            '       "cosmoprimo_tpu") or m.startswith(("jax.", "flax.", "optax.", "cosmoprimo_tpu.")))]\n'
            'print(json.dumps(bad))\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**__import__('os').environ, 'PYTHONPATH': REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
