"""The port's emulator engines, files and converters
(cosmoprimo_tpu_torch/emulators/base.py, mlp.py, taylor.py, samples.py,
conversion.py, parallel/distributed.py) against the JAX package's, on
states and weights made from a seed with numpy (no training).

- Samples and Emulator files both ways between the packages (.npy always,
  .h5 with h5py), and a JAX-written .npy served in a process where
  ``import jax`` fails.
- MLP (silu, tanh, relu, identity-silu, folded batch norm), Taylor and
  Point engines, and the cosmopower and jaxcapse chains of the converters,
  predicting a batch in one call against the JAX package one cosmology at
  a time (jax.vmap), with the batch as long as the inputs or the outputs
  (trap: an expression read on a batch mis-broadcasts there). Bar:
  max|d| / max|ref| <= 1e-12 in every row (measured <= 1.6e-15 for the
  MLP, Taylor and Point engines, <= 1.7e-14 for the converted chains).
- The converters make the JAX converters' states (array for array).
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from cosmoprimo_tpu.emulators import Emulator as JEmulator  # noqa: E402
from cosmoprimo_tpu.emulators import Samples as JSamples  # noqa: E402
from cosmoprimo_tpu.emulators import conversion as jconversion  # noqa: E402
from cosmoprimo_tpu.emulators.mlp import MLPEmulatorEngine as JMLPEngine  # noqa: E402
from cosmoprimo_tpu_torch.emulators import Emulator, Samples, batch_vmap, conversion  # noqa: E402
from cosmoprimo_tpu_torch.emulators.taylor import fd_coefficients  # noqa: E402

REPO = chip_smoke.__file__.rsplit('/', 1)[0]
BAR = 1e-12
PARAMS = {'a': (0.5, 1.5), 'b': (-1.0, 1.0), 'c': (2.0, 3.0), 'd': (0.0, 0.1)}


def row_err(got, ref):
    """max|got - ref| / max|ref| of each row (leading axis), the worst."""
    got, ref = np.asarray(got).reshape(len(ref), -1), np.asarray(ref).reshape(len(ref), -1)
    return np.max(np.max(np.abs(got - ref), axis=1) / np.max(np.abs(ref), axis=1))


def deep_equal(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(deep_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        return len(a) == len(b) and all(deep_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def draw(names, B, seed=0):
    rng = np.random.default_rng(seed)
    return {name: rng.uniform(*PARAMS[name], B) for name in names}


def predict_both(state, params, names=None):
    """(port, JAX) predictions of the emulator ``state``: the port on the
    batch in one call, the JAX package one row at a time (jit, vmap)."""
    emu, jemu = Emulator.from_state(state), JEmulator.from_state(state)
    got = emu.predict({name: torch.from_numpy(value) for name, value in params.items()})
    ref = jax.jit(jax.vmap(jemu.predict))({name: jnp.asarray(value) for name, value in params.items()})
    names = names or list(ref)
    return {name: got[name].numpy() for name in names}, {name: np.asarray(ref[name]) for name in names}


def mlp_state(activation, batch_norm, nin=4, yshape=(5,), seed=0):
    """An MLP engine state from chip_smoke.mlp_engine_state (the port's export),
    whose chain is the JAX package's export of the same weights."""
    params = {name: PARAMS[name] for name in list(PARAMS)[:nin]}
    state = chip_smoke.mlp_engine_state(np.random.default_rng(seed), params, (8, 8, 8), activation, yshape,
                                        [np.zeros(yshape), np.ones(yshape)], batch_norm=batch_norm)
    jengine = JMLPEngine(nhidden=(8, 8, 8), activation=activation)
    jengine.batch_norm = batch_norm
    rng = np.random.default_rng(seed)
    weights, stats = chip_smoke.mlp_weights(rng, [nin, 8, 8, 8, int(np.prod(yshape))], activation, batch_norm)
    assert deep_equal([op.__getstate__() for op in jengine._export_operations(weights, stats)],
                      state['model_operations'])
    return state


@pytest.mark.parametrize('activation,batch_norm', [('silu', False), ('tanh', False), ('relu', False),
                                                   ('identity-silu', False), ('silu', True), ('tanh', True)])
@pytest.mark.parametrize('B', [4, 5])
def test_mlp_engine_against_jax(activation, batch_norm, B):
    """An MLP engine (4 inputs, 5 outputs) on a batch of 4 or 5 rows."""
    state = {'engines': {'y': mlp_state(activation, batch_norm)}, 'fixed': {'x': np.linspace(0.0, 1.0, 5)}}
    got, ref = predict_both(state, draw('abcd', B), names=['y'])
    assert got['y'].shape == ref['y'].shape == (B, 5)
    assert row_err(got['y'], ref['y']) <= BAR


def taylor_state(seed=1):
    """A Taylor engine of order 2 in (a, b) with a (3, 2) output."""
    rng = np.random.default_rng(seed)
    powers = np.array([(i, j) for i in range(3) for j in range(3) if i + j <= 2])
    return {'name': 'taylor', 'params': ['a', 'b'], 'xshape': (2,), 'yshape': (3, 2), 'attrs': {},
            'xoperations': [], 'yoperations': [], 'sampler_options': {'order': 2, 'accuracy': 2},
            'center': np.array([1.0, 0.0]), 'powers': powers, 'derivatives': rng.normal(size=(len(powers), 6))}


@pytest.mark.parametrize('B', [2, 3])
def test_taylor_and_point_against_jax(B):
    """Taylor (batch as long as its inputs or its first output axis) and
    Point engines, and the fixed outputs."""
    point = {'name': 'point', 'params': ['a'], 'xshape': (1,), 'yshape': (4,), 'attrs': {}, 'xoperations': [],
             'yoperations': [{'name': 'log10', '_direct': 'jnp.log10(v)', '_inverse': '10**v', '_locals': {}}],
             'point': np.array([0.1, 0.2, 0.3, 0.4])}
    state = {'engines': {'t': taylor_state(), 'p': point}, 'fixed': {'f': np.arange(3.0)}}
    got, ref = predict_both(state, draw('ab', B))
    assert got['t'].shape == (B, 3, 2) and got['p'].shape == (B, 4)
    for name in ('t', 'p'):
        assert row_err(got[name], ref[name]) <= BAR
    np.testing.assert_array_equal(got['f'], np.arange(3.0))
    np.testing.assert_allclose(fd_coefficients(2, 5, 0.1), jax_fd_coefficients(2, 5, 0.1), rtol=1e-15)


def jax_fd_coefficients(*args):
    from cosmoprimo_tpu.emulators.taylor import fd_coefficients as jfd
    return jfd(*args)


def emulator_state():
    return {'engines': {'y': mlp_state('tanh', True), 't': taylor_state()}, 'fixed': {'x': np.linspace(0.0, 1.0, 5)},
            'xoperations': [], 'yoperations': [], 'defaults': {'c': 2.5}}


@pytest.mark.parametrize('ext', ['npy', 'h5'])
def test_emulator_files_both_ways(tmp_path, ext):
    """The JAX package reads what the port writes and the port what the
    JAX package writes; the states and the predictions agree."""
    if ext == 'h5':
        pytest.importorskip('h5py')
    state = emulator_state()
    params = draw('abcd', 3)
    _, ref = predict_both(state, params)
    for writer, reader in ((Emulator, JEmulator), (JEmulator, Emulator)):
        fn = tmp_path / f'{writer.__module__.split(".")[0]}.{ext}'
        writer.from_state(state).write(fn)
        emu = reader.read(fn)
        assert set(emu.engines) == {'y', 't'} and deep_equal(emu.defaults, {'c': 2.5})
        if reader is Emulator:
            got = emu.predict({name: torch.from_numpy(value) for name, value in params.items()})
        else:
            got = jax.vmap(emu.predict)({name: jnp.asarray(value) for name, value in params.items()})
        for name in ('y', 't'):
            assert row_err(np.asarray(got[name]), ref[name]) <= BAR
    # the port's state round trip
    assert deep_equal(Emulator.from_state(state).__getstate__()['engines']['t'], state['engines']['t'])


@pytest.mark.parametrize('ext', ['npy', 'h5'])
def test_samples_files_both_ways(tmp_path, ext):
    if ext == 'h5':
        pytest.importorskip('h5py')
    rng = np.random.default_rng(2)
    data = {'X.a': rng.uniform(size=6), 'Y.y': rng.uniform(size=(6, 3))}
    samples = Samples(data, attrs={'order': 2, 'center': {'a': 1.0}})
    assert samples.columns('X.*') == ['X.a'] and samples.size == 6 and samples.isfinite().all()
    assert Samples.concatenate([samples, samples.select(slice(0, 2))]).size == 8
    for writer, reader in ((Samples, JSamples), (JSamples, Samples)):
        fn = tmp_path / f'{writer.__module__.split(".")[0]}.{ext}'
        writer(data, attrs=samples.attrs).write(fn)
        loaded = reader.read(fn)
        assert deep_equal(dict(loaded), data) and loaded.attrs == samples.attrs


def test_jax_written_npy_without_jax(tmp_path):
    """A JAX-written .npy emulator (a pickle) loads and serves in a process
    where ``import jax`` fails, and predicts what the JAX package does."""
    state = emulator_state()
    fn = tmp_path / 'jax.npy'
    JEmulator.from_state(state).write(fn)
    params = draw('abcd', 3)
    _, ref = predict_both(state, params)
    code = ('import sys, json; sys.modules["jax"] = None\n'
            'import numpy as np, torch\n'
            'from cosmoprimo_tpu_torch.emulators import Emulator\n'
            f'params = {json.dumps({k: v.tolist() for k, v in params.items()})}\n'
            f'out = Emulator.read({str(fn)!r}).predict({{k: torch.tensor(v, dtype=torch.float64) '
            'for k, v in params.items()})\n'
            'assert not any(m == "jax" or m.startswith(("jax.", "cosmoprimo_tpu.")) or m == "cosmoprimo_tpu"'
            ' for m in sys.modules if sys.modules[m] is not None)\n'
            'print(json.dumps({k: out[k].tolist() for k in ("y", "t")}))\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ('y', 't'):
        assert row_err(np.array(got[name]), ref[name]) <= BAR


def jaxace_dir(path, folder, rng, n_in, n_out, hidden=(16, 16), activation='silu', k=None):
    """A synthetic jaxace (jaxcapse / jaxmapse) network directory."""
    sizes = [n_in] + list(hidden) + [n_out]
    weights = []
    for i in range(len(sizes) - 1):
        weights += [(rng.normal(size=(sizes[i + 1], sizes[i])) * 0.3).ravel(order='F'),
                    rng.normal(size=sizes[i + 1]) * 0.1]
    d = path / folder
    d.mkdir(parents=True)
    np.save(d / 'weights.npy', np.concatenate(weights))
    np.save(d / 'nminmax.npy', np.stack([np.full(n_in, 0.5), np.full(n_in, 1.5)], axis=-1))
    np.save(d / 'outminmax.npy', np.stack([np.full(n_out, 2.0), np.full(n_out, 6.0)], axis=-1))
    if k is not None:
        np.save(d / 'k.npy', k)
    with open(d / 'nn_setup.json', 'w') as f:
        json.dump({'n_input_features': n_in, 'n_output_features': n_out,
                   'layers': {f'layer_{i + 1}': {'n_neurons': h, 'activation_function': activation}
                              for i, h in enumerate(hidden)}}, f)


def cosmopower_arrays(rng, n_in, n_out, nhidden=12, nlayers=2):
    sizes = [n_in] + [nhidden] * (nlayers - 1) + [n_out]
    arrays = {'n_layers': nlayers}
    for i in range(nlayers):
        arrays[f'W_{i}'] = rng.normal(size=(sizes[i], sizes[i + 1])) * 0.3
        arrays[f'b_{i}'] = rng.normal(size=sizes[i + 1]) * 0.1
    for i in range(nlayers - 1):
        arrays[f'alphas_{i}'], arrays[f'betas_{i}'] = rng.normal(size=nhidden), rng.normal(size=nhidden)
    return arrays


def converted(kind, path):
    """(port emulator, JAX emulator, inputs) of a synthetic foreign net."""
    rng = np.random.default_rng(7)
    if kind == 'jaxcapse':
        for folder in ('TT', 'PP'):
            jaxace_dir(path, folder, rng, 6, 12)
        args = (path,)
        fun = 'convert_jaxcapse_to_cosmoprimo'
    elif kind == 'jaxmapse':
        jaxace_dir(path, 'plin', rng, 5, 12, k=np.geomspace(1e-4, 10.0, 12))
        args, fun = (path,), 'convert_jaxmapse_to_cosmoprimo'
    elif kind == 'cosmopower':
        fn = path / 'net.npz'
        np.savez(fn, param_train_mean=np.full(4, 0.5), param_train_std=np.full(4, 2.0),
                 feature_train_mean=np.full(12, -1.0), feature_train_std=np.full(12, 0.2),
                 parameters_=np.array(['omega_b', 'omega_cdm', 'h', 'logA']), modes=np.arange(2, 14),
                 **cosmopower_arrays(rng, 4, 12))
        args, fun = (fn,), 'convert_cosmopower_to_cosmoprimo'
    else:
        version = kind[-1]
        params = np.array(['ombh2', 'omch2', 'H0', 'logA', 'ns', 'tau'])
        common = dict(parameters=params, param_train_mean=np.linspace(0.5, 1.5, 6),
                      param_train_std=np.full(6, 0.2))
        nets = {'TT': 12, 'TE': 12, 'DER': 14 if version == '1' else 10, 'PK': 500 if version == '1' else 1000}
        base = path / ('cosmopower_bolliet2023_base' if version == '1' else 'cosmopower_jense2024_base')
        for name, n_out in nets.items():
            arrays = dict(common, feature_train_mean=np.full(n_out, 0.1 if name != 'PK' else 3.0),
                          feature_train_std=np.full(n_out, 0.05),
                          **cosmopower_arrays(rng, 6, n_out))
            if version == '1':
                folder = base / {'TT': 'TTTEEE', 'TE': 'TTTEEE', 'DER': 'derived-parameters', 'PK': 'PK'}[name]
                folder.mkdir(parents=True, exist_ok=True)
                np.savez(folder / f'{name}_net.npz', arr_0=np.array(arrays, dtype=object))
            else:
                folder = base / 'networks'
                folder.mkdir(parents=True, exist_ok=True)
                label = {'TT': 'Cl_tt', 'TE': 'Cl_te', 'DER': 'derived', 'PK': 'Pk_lin'}[name]
                np.savez(folder / f'jense_{label}_net.npz', **arrays)
        args, fun = (base,), 'convert_cosmopower_release_to_cosmoprimo'
    return getattr(conversion, fun)(*args), getattr(jconversion, fun)(*args)


INPUTS = {'logA': (2.9, 3.1), 'n_s': (0.93, 0.99), 'H0': (64.0, 72.0), 'h': (0.64, 0.72), 'omega_b': (0.021, 0.023),
          'omega_cdm': (0.11, 0.13), 'tau_reio': (0.04, 0.08)}


@pytest.mark.parametrize('kind', ['jaxcapse', 'jaxmapse', 'cosmopower', 'cosmopower_release_v1',
                                  'cosmopower_release_v2'])
def test_converters_against_jax(tmp_path, kind):
    """Each converter's state equals the JAX converter's, and the converted
    emulator predicts a batch as long as its inputs (6 for jaxcapse and the
    releases, whose jaxcapse 'kernel @ v + bias' takes (out, in) kernels)
    as the JAX package does per row, through its output chain (the
    ell = 0, 1 rows, 10**, the cl / ell(ell + 1) factors, the packed
    derived vector and the Mpc -> Mpc/h conversions of k and P(k), each row
    its own k / h)."""
    emu, jemu = converted(kind, tmp_path)
    assert deep_equal(emu.__getstate__(), jemu.__getstate__())
    names = emu.params
    rng = np.random.default_rng(8)
    params = {name: rng.uniform(*INPUTS[name], len(names)) for name in names}
    got = emu.predict({name: torch.from_numpy(value) for name, value in params.items()})
    ref = jax.jit(jax.vmap(jemu.predict))({name: jnp.asarray(value) for name, value in params.items()})
    assert set(got) == set(ref)
    for name, value in ref.items():
        value = np.asarray(value)
        out = np.broadcast_to(got[name].numpy(), value.shape)   # a fixed output is shared by the rows
        assert row_err(out, value) <= BAR, name


def test_batch_vmap_and_helpers():
    """batch_vmap in chunks (pytrees in and out), mask_subsample and
    smoothstep as the JAX package's, the single-rank communicator."""
    from cosmoprimo_tpu.emulators import mask_subsample as jmask, smoothstep as jsmooth
    from cosmoprimo_tpu.parallel.distributed import split_ranks as jsplit
    from cosmoprimo_tpu_torch.emulators import mask_subsample, smoothstep
    from cosmoprimo_tpu_torch.parallel import FakeComm, get_comm, split_ranks
    x = torch.arange(10.0, dtype=torch.float64)
    out = batch_vmap(lambda v: {'sq': v ** 2, 'lin': 3 * v}, batch_size=3)(x)
    np.testing.assert_allclose(out['sq'].numpy(), np.arange(10.0) ** 2)
    np.testing.assert_allclose(out['lin'].numpy(), 3 * np.arange(10.0))
    np.testing.assert_allclose(batch_vmap(lambda a, b: a + b['y'])(x, {'y': 2 * x}).numpy(), 3 * np.arange(10.0))
    np.testing.assert_array_equal(mask_subsample(50, 0.3), jmask(50, 0.3))
    np.testing.assert_array_equal(mask_subsample(50, 7), jmask(50, 7))
    t = np.linspace(-0.5, 1.5, 41)
    np.testing.assert_allclose(smoothstep(t, 0.2, 0.8, order=3), jsmooth(t, 0.2, 0.8, order=3), rtol=0, atol=0)
    comm = get_comm()
    assert isinstance(comm, FakeComm) and comm.Get_size() == 1 and comm.allgather(3) == [3]
    comm.send('x', tag=2)
    assert comm.recv(tag=2) == 'x' and comm.scatter([5]) == 5
    assert split_ranks(10, 1, 3) == jsplit(10, 1, 3)
