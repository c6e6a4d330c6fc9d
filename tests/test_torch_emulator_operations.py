"""The port's emulator operation algebra (cosmoprimo_tpu_torch/emulators/
operations.py and the norm operations of emulators/__init__.py) against
the JAX package's, on the same inputs made from a seed with numpy.

- The restricted evaluator makes the JAX package's rejections
  (tests/test_emulators.py::test_operation_evaluate_restricted).
- Every registered operation, both directions, built from the JAX
  package's state: the expression operations for one cosmology, under
  torch.func.vmap over a batch whose size equals the trailing length (a
  batch read as one cosmology would mis-broadcast there), against jax.vmap
  of the JAX operation, per row; the typed dict operations and the
  Harmonic/Fourier norm operations batch-first against the JAX operation
  one row at a time. Bar: max|d| / max|ref| <= 1e-13 in every row
  (measured <= 2.9e-16 for the expressions, <= 1.1e-14 for the norm
  operations' per-row splines; the Harmonic norm's inverse from X, where
  each package computes theta_cosmomc itself, 1.1e-13 against its bar of
  1e-12: see its test).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from cosmoprimo_tpu.emulators import FourierNormOperation as JFourierNorm  # noqa: E402
from cosmoprimo_tpu.emulators import HarmonicNormOperation as JHarmonicNorm  # noqa: E402
from cosmoprimo_tpu.emulators import operations as jops  # noqa: E402
from cosmoprimo_tpu_torch.emulators import FourierNormOperation, HarmonicNormOperation  # noqa: E402
from cosmoprimo_tpu_torch.emulators import operations as ops  # noqa: E402

BAR = 1e-13


def row_err(got, ref):
    """max|got - ref| / max|ref| of each row (leading axis), the worst."""
    got, ref = np.asarray(got).reshape(len(ref), -1), np.asarray(ref).reshape(len(ref), -1)
    return np.max(np.max(np.abs(got - ref), axis=1) / np.max(np.abs(ref), axis=1))


def test_evaluate_restricted():
    """The rejections of the JAX package's evaluator, and what it admits."""
    np.testing.assert_allclose(float(ops.evaluate('jnp.log10(v) + s', {'v': 100.0, 's': 1.0})), 3.0)
    out = ops.evaluate('v @ kernel + bias', {'v': torch.ones((1, 2), dtype=torch.float64),
                                             'kernel': torch.ones((2, 2), dtype=torch.float64),
                                             'bias': torch.zeros(2, dtype=torch.float64)})
    np.testing.assert_allclose(out.numpy(), [[2.0, 2.0]])
    for evil in ["().__class__.__mro__[1].__subclasses__()", "v.__class__", "_secret", "[x for x in (1,)]",
                 "lambda: 1", "jnp.__loader__", "f'{v}'", "getattr(v, 'real')", "open('/etc/passwd')", "exec",
                 "eval"]:
        with pytest.raises((ValueError, SyntaxError, NameError)):
            ops.evaluate(evil, {'v': 1.0})
    for name in ('os', 'subprocess.check_output', 'jax', 'jax.numpy'):
        with pytest.raises(ImportError):
            ops._guarded_import(name)
    assert ops._guarded_import('torch') is torch
    np.testing.assert_allclose(float(ops.evaluate('jnp.linalg.norm(v)', {'v': torch.tensor([3.0, 4.0])})), 5.0)
    zeros = ops.evaluate('jnp.concatenate([jnp.zeros(2), v])', {'v': torch.ones(3, dtype=torch.float64)})
    assert zeros.dtype == torch.float64 and zeros.tolist() == [0, 0, 1, 1, 1]
    op = ops.Operation.from_state(jops.Operation('jnp.exp(v)', inverse='jnp.log(v)').__getstate__())
    np.testing.assert_allclose(float(op.inverse(op(torch.tensor(1.5, dtype=torch.float64)))), 1.5, rtol=1e-12)


def initialized(name, samples, **kwargs):
    op = getattr(jops, name)(**kwargs)
    op.initialize(samples)
    return op


def expression_cases():
    """(label, JAX operation, its X or None, the one-cosmology shape of v)."""
    rng = np.random.default_rng(0)
    nin, nout = 6, 12
    samples = rng.uniform(0.5, 2.0, size=(40, nin))
    kernel, bias = rng.normal(size=(nin, nout)), rng.normal(size=nout)
    ell = np.maximum(np.arange(nout), 1) / 500.0
    limits = np.stack([rng.uniform(0.0, 1.0, nout), rng.uniform(2.0, 3.0, nout)])
    X = {'logA': rng.uniform(2.9, 3.1), 'tau_reio': rng.uniform(0.04, 0.08), 'n_s': rng.uniform(0.9, 1.0)}
    Op = jops.Operation
    return [
        ('log10', jops.Log10Operation(), None, (nin,)),
        ('arcsinh', jops.ArcsinhOperation(), None, (nin,)),
        ('scale', initialized('ScaleOperation', samples), None, (nin,)),
        ('norm', initialized('NormOperation', samples), None, (nin,)),
        ('pca', initialized('PCAOperation', samples, npcs=3), None, (nin,)),
        ('chebyshev', initialized('ChebyshevOperation', samples, order=4), None, (nin,)),
        ('dense', Op('v @ kernel + bias', locals={'kernel': kernel, 'bias': bias}), None, (nin,)),
        ('dense_transposed', Op('kernel @ v + bias', locals={'kernel': kernel.T, 'bias': bias}), None, (nin,)),
        ('silu', Op('v / (1 + jnp.exp(-v))'), None, (nin,)),
        ('relu', Op('jnp.maximum(v, 0.)'), None, (nin,)),
        ('tanh', Op('jnp.tanh(v)'), None, (nin,)),
        ('identity_silu', Op('((1 - beta) + beta / (1 + jnp.exp(-alpha * v))) * v',
                             locals={'beta': rng.normal(), 'alpha': rng.normal()}), None, (nin,)),
        ('cosmopower_activation', Op('(beta + (1 - beta) / (1 + jnp.exp(-alpha * v))) * v',
                                     locals={'alpha': rng.normal(size=nin), 'beta': rng.normal(size=nin)}), None,
         (nin,)),
        ('batch_norm', Op('scale * (v - mean) + bias', locals={'scale': rng.normal(size=nin),
                                                               'mean': rng.normal(size=nin),
                                                               'bias': rng.normal(size=nin)}), None, (nin,)),
        ('jaxcapse_output', Op('((v - limits[0]) / (limits[1] - limits[0]))[:2]',
                               inverse='jnp.concatenate([jnp.zeros(2), v * (limits[1] - limits[0]) + limits[0]])',
                               locals={'limits': limits}), None, (nout,)),
        ('cl_norm', Op("v / jnp.exp(X['logA'] - 3.) / jnp.exp(-2 * X['tau_reio'])",
                       inverse="v * jnp.exp(X['logA'] - 3.) * jnp.exp(-2 * X['tau_reio'])"), X, (nout,)),
        ('cl_norm_tilt', Op("v / jnp.exp(X['logA'] - 3.) / jnp.exp(-2 * X['tau_reio']) / ellnorm ** (X['n_s'] - 0.96)",
                            inverse="v * jnp.exp(X['logA'] - 3.) * jnp.exp(-2 * X['tau_reio']) "
                                    "* ellnorm ** (X['n_s'] - 0.96)", locals={'ellnorm': ell}), X, (nout,)),
    ]


CASES = [(case, direction) for case in expression_cases() for direction in ('direct', 'inverse')
         if direction == 'direct' or case[1]._inverse is not None or case[0] in ('pca', 'chebyshev')]


@pytest.mark.parametrize('case,direction', CASES, ids=[f'{case[0]}-{direction}' for case, direction in CASES])
def test_expression_operations_against_jax(case, direction):
    """One cosmology's expression under torch.func.vmap over a batch of the
    trailing length, against jax.vmap of the JAX operation, per row."""
    label, jop, X, shape = case
    op = ops.Operation.from_state(jop.__getstate__())
    assert type(op).__name__ == type(jop).__name__
    rng = np.random.default_rng(1)
    batch = shape[-1]
    v = rng.uniform(0.5, 2.0, size=(batch,) + shape)
    Xb = None if X is None else {name: value + 0.01 * rng.normal(size=batch) for name, value in X.items()}
    if direction == 'inverse':
        if label != 'jaxcapse_output':   # its direct form keeps two entries: invert the (nout,) outputs
            v = np.asarray(jax.vmap(lambda a, x: jop(a, X=x) if X is not None else jop(a))(jnp.asarray(v), Xb))
        jfun, fun = jop.inverse, op.inverse
    else:
        jfun, fun = jop, op
    if X is None:
        ref = jax.vmap(jfun)(jnp.asarray(v))
        got = torch.func.vmap(fun)(torch.from_numpy(v))
    else:
        ref = jax.vmap(lambda a, x: jfun(a, X=x))(jnp.asarray(v), Xb)
        got = torch.func.vmap(lambda a, x: fun(a, X=x))(torch.from_numpy(v),
                                                       {name: torch.from_numpy(x) for name, x in Xb.items()})
    assert tuple(got.shape) == np.shape(ref)
    assert row_err(got.numpy(), ref) <= BAR


def batch_X(B=3, seed=2):
    rng = np.random.default_rng(seed)
    return dict(omega_cdm=rng.uniform(0.11, 0.13, B), omega_b=rng.uniform(0.021, 0.023, B),
                h=rng.uniform(0.62, 0.74, B), A_s=rng.uniform(1.9e-9, 2.2e-9, B), n_s=rng.uniform(0.94, 0.98, B))


def torch_X(X):
    return {name: torch.from_numpy(value) for name, value in X.items()}


def jax_rows(fun, v, X, shared=()):
    """The JAX operation ``fun`` one row at a time, jitted and vmapped:
    the entries of ``v`` named in ``shared`` are the same for every row."""
    in_v = {name: None if name in shared else 0 for name in v}
    out = jax.jit(jax.vmap(lambda a, x: fun(a, X=x), in_axes=(in_v, 0)))(
        {name: jnp.asarray(value) for name, value in v.items()}, {k: jnp.asarray(x) for k, x in X.items()})
    return {name: np.asarray(value) for name, value in out.items()}


@pytest.mark.parametrize('direction', ['direct', 'inverse'])
def test_typed_dict_operations_against_jax(direction):
    """SplitDerivedOperation and FourierUnitOperation (the cosmopower
    release conventions), batch-first against the JAX operations per row,
    with the packed derived vector as long as the batch."""
    from cosmoprimo_tpu.emulators.conversion import _COSMOPOWER_DERIVED_INDEX
    rng = np.random.default_rng(3)
    B = 10
    X = {'h': rng.uniform(0.6, 0.8, B)}
    k = np.geomspace(1e-4, 1.0, 7)
    v = {'thermodynamics.all': rng.uniform(1.0, 2.0, size=(B, 10)), 'fourier.k': k,
         'fourier.pk.delta_m.delta_m': rng.uniform(1.0, 2.0, size=(B, 7))}
    for jop in (jops.SplitDerivedOperation(conversion=_COSMOPOWER_DERIVED_INDEX['2']),
                jops.FourierUnitOperation(pk_h3=True)):
        op = ops.Operation.from_state(jop.__getstate__())
        name = 'inverse' if direction == 'inverse' else '__call__'
        ref = jax_rows(getattr(jop, name), v, X, shared=('fourier.k',))
        got = getattr(op, name)({key: torch.from_numpy(value) for key, value in v.items()}, X=torch_X(X))
        assert set(got) == set(ref)
        for key, value in ref.items():
            # an entry the operation leaves alone stays shared (jax.vmap broadcasts it)
            assert np.broadcast_shapes(tuple(got[key].shape), value.shape) == value.shape, key
            assert row_err(np.broadcast_to(got[key].numpy(), value.shape), value) <= BAR, key


@pytest.mark.parametrize('direction', ['direct', 'inverse'])
def test_harmonic_norm_against_jax(direction):
    """HarmonicNormOperation on a batch of 3 cosmologies (each its own
    theta_cosmomc, so its own warped ell grid, unsorted per row in the
    inverse) against the JAX operation per row: on the same theta_cosmomc
    and A_s (``cosmo``) at 1e-13; and from ``X``, each package computing
    the BBKS theta_cosmomc itself: those differ by <= 9e-16, which the
    inverse's warped grid (knots 4e-4 apart) amplifies to 1.1e-13, so the
    bar there is 1e-12."""
    rng = np.random.default_rng(4)
    X = batch_X()
    ell = np.arange(201)
    v = {f'harmonic.lensed_cl.{name}': (1.0 + 0.1 * rng.normal(size=(3, ell.size))) * 1e-10 / (1.0 + ell) ** scale
         for name, scale in (('tt', 1.0), ('ee', 1.5))}
    jop = JHarmonicNorm()
    jop.initialize({name: value[0] for name, value in v.items()})
    op = ops.Operation.from_state(jop.__getstate__())
    assert isinstance(op, HarmonicNormOperation)
    name = 'inverse' if direction == 'inverse' else '__call__'
    jfun, fun = getattr(jop, name), getattr(op, name)
    jcosmo = jax.jit(jax.vmap(lambda x: {key: jop._cosmo(x)[key] for key in ('theta_cosmomc', 'A_s')}))(
        {key: jnp.asarray(value) for key, value in X.items()})
    ref = jax.jit(jax.vmap(lambda a, c: jfun(a, cosmo=c)))({key: jnp.asarray(value) for key, value in v.items()},
                                                          jcosmo)
    cosmo = {key: torch.from_numpy(np.asarray(value)) for key, value in jcosmo.items()}
    tv = {key: torch.from_numpy(value) for key, value in v.items()}
    got = fun(tv, cosmo=cosmo)
    ref_X, got_X = jax_rows(jfun, v, X), fun(tv, X=torch_X(X))
    for key, value in ref.items():
        assert row_err(got[key].numpy(), np.asarray(value)) <= BAR, key
        assert row_err(got_X[key].numpy(), ref_X[key]) <= 1e-12, key


@pytest.mark.parametrize('direction', ['direct', 'inverse'])
def test_fourier_norm_against_jax(direction):
    """FourierNormOperation on a batch of 3 cosmologies with 3 redshifts
    (the batch as long as the z axis), the log-log splines in k / h per
    row and the BBKS primordial spectrum per row, against the JAX
    operation per row, with the emulated engine's k grid."""
    from cosmoprimo_tpu_torch.emulators.emulated import get_default_k_callable
    rng = np.random.default_rng(5)
    X = batch_X()
    k, z = get_default_k_callable(), np.array([0.0, 0.5, 1.0])
    shape = 2e4 * (k / 0.02) / (1 + (k / 0.02) ** 2.6)
    growth = 1.0 / (1.0 + z)
    pk = shape[:, None] * growth ** 2 * (1.0 + 0.05 * rng.normal(size=(3, 1, 1)))
    v = {'fourier.k': k, 'fourier.z': z, 'fourier.pk.delta_cb.delta_cb': pk,
         'fourier.pk.delta_m.delta_m': pk * (1.0 + 0.01 * rng.normal(size=pk.shape))}
    jop = JFourierNorm()
    jop.initialize({name: value for name, value in v.items()})
    op = ops.Operation.from_state(jop.__getstate__())
    assert isinstance(op, FourierNormOperation)
    if direction == 'inverse':
        v = jax_rows(jop, v, X, shared=('fourier.k', 'fourier.z'))
        v['fourier.k'], v['fourier.z'] = k, z
        name = 'inverse'
    else:
        name = '__call__'
    ref = jax_rows(getattr(jop, name), v, X, shared=('fourier.k', 'fourier.z'))
    got = getattr(op, name)({key: torch.from_numpy(value) for key, value in v.items()}, X=torch_X(X))
    assert set(got) == set(ref)
    for key, value in ref.items():
        if key in ('fourier.k', 'fourier.z'):
            continue
        assert tuple(got[key].shape) == value.shape, key
        assert row_err(got[key].numpy(), value) <= BAR, key
