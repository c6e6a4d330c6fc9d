"""The port's sharded paths (cosmoprimo_tpu_torch/parallel/mesh.py, the
sharded fit of emulators/mlp.py) in two- and four-process gloo worlds on
the CPU: this file runs as a script, ``python test_torch_sharded.py PORT
NPROC RANK OUTDIR``, each world within a 120 s timeout.

- ``shard_array``/``gather_array`` give an uneven array back exactly, and
  ``replicate`` gives every rank rank 0's pytree (2 and 4 ranks).
- The dp-sharded EH headline and halofit pipelines (nk = 256, 5 rows over
  2 ranks), gathered, against the JAX package's batched pipeline on the
  same rows, at the bars of test_torch_pipelines.py (xi 1e-12 of each
  row's max, chi and sigma8 rtol 1e-13) and test_torch_halofit.py (xi
  1e-11); measured xi 4.3e-14 and 5.8e-14, chi and sigma8 4.4e-16.
- The sharded MLP fit on meshes dp = 2, tp = 2 (2 ranks) and dp x tp =
  2 x 2 (4 ranks), with and without batch normalization (identity-silu
  scalars on tp-split features; odd and even layer counts), a two-stage
  schedule whose second stage stops early: every rank's exported
  operations within 1e-10 of each array's max of the port's unsharded fit
  (measured <= 3.8e-15 without and <= 1.0e-13 with batch normalization:
  the sums in another order), the same epochs in each stage.
- The port's unsharded fit against the JAX package's
  ``fit(mesh=make_mesh())`` on the 8-device virtual mesh, the port loading
  the flax initialization: 1e-10 of each array's max (measured 5.2e-15
  and 1.5e-13), the same steps.
"""

import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed_multiprocess import run_world  # noqa: E402

FIT_BAR = 1e-10
XI_BAR, HALOFIT_BAR, RTOL = 1e-12, 1e-11, 1e-13
NK, B_PIPE = 256, 5
FIT = dict(batch_frac=(0.25, 1.0), epochs=(40, 30), learning_rate=(3e-2, 0.2), patience=(40, 3), seed=5,
           learning_rate_scheduling=True)
# (hidden widths, activations, batch norm): three layers (the last one
# column-parallel, gathered) with identity-silu on split features; four
# layers with batch normalization on split and on whole features
NETS = {False: ((8, 8), ('identity-silu', 'tanh')), True: ((8, 8, 8), ('silu', 'silu', 'tanh'))}
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}


def fit_data():
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(60, 2))
    Y = np.stack([np.sin(3 * X[:, 0]) + X[:, 1] ** 2, np.cos(2 * X[:, 1]) * X[:, 0], X[:, 0] * X[:, 1],
                  X[:, 0] - X[:, 1] ** 3], axis=-1)
    return X, Y


def pipe_args():
    rng = np.random.default_rng(0)
    return (rng.uniform(0.11, 0.13, B_PIPE), rng.uniform(0.021, 0.023, B_PIPE), rng.uniform(0.65, 0.70, B_PIPE),
            rng.uniform(0.94, 0.98, B_PIPE), rng.uniform(2.9, 3.1, B_PIPE))


def port_fit(batch_norm, mesh=None):
    from cosmoprimo_tpu_torch.emulators import mlp
    nhidden, activation = NETS[batch_norm]
    engine = mlp.MLPEmulatorEngine(nhidden=nhidden, activation=activation)
    engine.initialize(['a', 'b'], device='cpu')
    X, Y = fit_data()
    engine._fit_no_operation(X, Y, {}, batch_norm=batch_norm, mesh=mesh, **FIT)
    return {'ops': [(op._direct, {name: np.asarray(value) for name, value in op._locals.items()})
                    for op in engine.model_operations],
            'epochs': [h['epochs'] for h in engine.history], 'steps': [h['steps'] for h in engine.history]}


def worker(port, nproc, rank, outdir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}', world_size=nproc, rank=rank)
    try:
        out = run_worker(nproc, rank)
    finally:
        dist.destroy_process_group()
    np.save(os.path.join(outdir, f'out.{rank}.npy'), out, allow_pickle=True)
    with open(os.path.join(outdir, f'ok.{rank}'), 'w') as f:
        f.write('ok')


def run_worker(nproc, rank):
    import torch
    from cosmoprimo_tpu_torch.parallel import gather_array, make_mesh, replicate, shard_array
    out = {}
    mesh = make_mesh(devices='cpu')
    assert mesh.size == nproc and mesh.device == torch.device('cpu')
    # round trips: an uneven leading axis, and rank 0's pytree everywhere
    x = np.arange(7 * 3, dtype=np.float64).reshape(7, 3)
    local = shard_array(x, mesh)
    assert np.array_equal(gather_array(local, mesh).numpy(), x)
    tree = {'w': np.full((2, 3), 1.5), 'list': [np.arange(4), (np.ones(2),)]} if rank == 0 else None
    rep = replicate(tree, mesh)
    assert float(rep['w'].sum()) == 9.0 and rep['list'][0].tolist() == [0, 1, 2, 3]
    assert isinstance(rep['list'][1], tuple) and rep['list'][1][0].device == mesh.device
    if nproc == 2:
        # the dp-sharded pipelines, gathered in rank order
        from cosmoprimo_tpu_torch import make_pk_to_xi_pipeline_batched
        for non_linear in ('', 'halofit'):
            fn, _, _ = make_pk_to_xi_pipeline_batched(nk=NK, z=(0.0,), non_linear=non_linear)
            outputs = fn(*[shard_array(a, mesh) for a in pipe_args()])
            out[f'pipeline{non_linear}'] = [gather_array(o, mesh).numpy() for o in outputs]
    for shape in MESHES[nproc]:
        mesh = make_mesh(devices='cpu', shape=shape)
        for batch_norm in (False, True):
            out[f'fit{shape}{batch_norm}'] = port_fit(batch_norm, mesh=mesh)
    return out


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """The outputs of every rank of the 2- and 4-process worlds."""
    out = {}
    for nproc in (2, 4):
        path = tmp_path_factory.mktemp(f'world{nproc}')
        run_world(__file__, nproc, path)
        out[nproc] = [np.load(path / f'out.{rank}.npy', allow_pickle=True).item() for rank in range(nproc)]
    return out


@functools.lru_cache(maxsize=None)
def unsharded(batch_norm):
    return port_fit(batch_norm)


def export_err(got, ref):
    assert [direct for direct, _ in got] == [direct for direct, _ in ref]
    err = 0.0
    for (_, locals_got), (_, locals_ref) in zip(got, ref):
        assert set(locals_got) == set(locals_ref)
        for name, value in locals_ref.items():
            err = max(err, float(np.max(np.abs(locals_got[name] - value)) / max(np.max(np.abs(value)), 1e-300)))
    return err


@pytest.mark.parametrize('nproc,shape', [(2, (2, 1)), (2, (1, 2)), (4, (2, 2))])
@pytest.mark.parametrize('batch_norm', [False, True])
def test_sharded_fit_against_unsharded(worlds, nproc, shape, batch_norm):
    ref = unsharded(batch_norm)
    assert ref['epochs'][0] == FIT['epochs'][0] and ref['epochs'][1] < FIT['epochs'][1]
    for rank, outputs in enumerate(worlds[nproc]):
        got = outputs[f'fit{shape}{batch_norm}']
        assert got['epochs'] == ref['epochs'] and got['steps'] == ref['steps']
        err = export_err(got['ops'], ref['ops'])
        print(f'sharded fit {shape} batch_norm={batch_norm}, rank {rank}: {err:.3e}')
        assert err <= FIT_BAR, f'rank {rank}: {err:.3e}'


@pytest.mark.parametrize('non_linear', ['', 'halofit'])
def test_sharded_pipelines_against_jax(worlds, non_linear):
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from cosmoprimo_tpu.pipelines import make_pk_to_xi_pipeline_batched as jmake
    fn, _, _ = jmake(nk=NK, z=jnp.asarray([0.0]), non_linear=non_linear or None)
    xi_ref, chi_ref, sigma8_ref = [np.asarray(o) for o in jax.jit(fn)(*[jnp.asarray(a) for a in pipe_args()])]
    for outputs in worlds[2]:
        xi, chi, sigma8 = outputs[f'pipeline{non_linear}']
        assert xi.shape == (B_PIPE, 1, NK)
        xi_ref_ = xi_ref.reshape(xi.shape)
        err = (np.abs(xi - xi_ref_).max(axis=-1) / np.abs(xi_ref_).max(axis=-1)).max()
        print(f'sharded pipeline {non_linear!r}: xi {err:.3e}, chi {np.max(np.abs(chi / chi_ref - 1)):.3e}, '
              f'sigma8 {np.max(np.abs(sigma8 / sigma8_ref - 1)):.3e}')
        assert err <= (HALOFIT_BAR if non_linear else XI_BAR), err
        np.testing.assert_allclose(chi, chi_ref, rtol=RTOL)
        np.testing.assert_allclose(sigma8, sigma8_ref, rtol=RTOL)


@pytest.mark.parametrize('batch_norm', [False, True])
def test_unsharded_fit_against_jax_mesh_fit(batch_norm, monkeypatch):
    jax = pytest.importorskip('jax')
    import jax.numpy as jnp
    from cosmoprimo_tpu.emulators import mlp as jmlp
    from cosmoprimo_tpu.parallel import make_mesh as jmake_mesh
    from cosmoprimo_tpu_torch.emulators import mlp
    nhidden, activation = NETS[batch_norm]
    X, Y = fit_data()
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
    jengine = jmlp.MLPEmulatorEngine(nhidden=nhidden, activation=activation)
    jengine.initialize(['a', 'b'])
    jengine._fit_no_operation(X, Y, {}, batch_norm=batch_norm, mesh=jmake_mesh(), **FIT)
    variables = jmlp.MLP(features=nhidden + (Y.shape[1],), activation=activation, batch_norm=batch_norm).init(
        jax.random.PRNGKey(FIT['seed']), jnp.ones((1, X.shape[1])))
    params = jax.tree_util.tree_map(np.asarray, variables['params'])
    stats = jax.tree_util.tree_map(np.asarray, variables.get('batch_stats', {}))
    monkeypatch.setattr(mlp, 'init_mlp', lambda model, generator: mlp.load_flax_variables(model, params, stats))
    got = port_fit(batch_norm)
    assert got['steps'] == steps
    ref = [(op._direct, {name: np.asarray(value) for name, value in op._locals.items()})
           for op in jengine.model_operations]
    err = export_err(got['ops'], ref)
    print(f'unsharded fit against the JAX mesh fit, batch_norm={batch_norm}: {err:.3e}')
    assert err <= FIT_BAR, err


if __name__ == '__main__':
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
