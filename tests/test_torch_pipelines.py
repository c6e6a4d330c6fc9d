"""The port's headline pipeline (cosmoprimo_tpu_torch/pipelines.py) against
the JAX package's make_pk_to_xi_pipeline_batched, on the same batch of
cosmologies made from a seed with numpy (the parameter ranges of bench.py).

Bars, tighter than the card-against-CPU bars of chip_smoke.py (xi 1e-10,
chi and sigma8 1e-11) because the measured agreement allows it: xi
max|d| / max|xi| per row <= 1e-12 (measured <= 7e-14: the two packages use
different FFTs and loggamma), chi and sigma8 rtol 1e-13 (measured <= 2.3e-16).

Derivatives of the halofit pipeline's (xi, sigma8) in (omega_cdm, h, logA),
forward mode (torch.func.jacfwd against jax.jacfwd) and reverse mode
(against jax.vjp), through engine='kernel': max|d| / max|ref| <= 1e-10 for
xi (measured <= 5.0e-12: halofit's 1e-13 rounding of C = -y'', see
tests/test_torch_halofit.py, differentiated) and <= 1e-13 for sigma8
(measured 2.3e-15).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from cosmoprimo_tpu.pipelines import make_pk_to_xi_pipeline_batched as jmake  # noqa: E402
from cosmoprimo_tpu.pipelines import make_distance_pipeline as jmake_distance  # noqa: E402
from cosmoprimo_tpu.pipelines import make_pk_to_xi_pipeline as jmake_single  # noqa: E402
from cosmoprimo_tpu_torch import (make_distance_pipeline, make_pk_to_xi_pipeline,  # noqa: E402
                                  make_pk_to_xi_pipeline_batched)

B = 4
XI_BAR = 1e-12
RTOL = 1e-13
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_args(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.11, 0.13, n), rng.uniform(0.021, 0.023, n), rng.uniform(0.65, 0.70, n),
            rng.uniform(0.94, 0.98, n), rng.uniform(2.9, 3.1, n))


@functools.lru_cache(maxsize=None)
def jax_outputs(nk, z):
    fn, k, s = jmake(nk=nk, z=jnp.asarray(z))
    return [np.asarray(o) for o in fn(*[jnp.asarray(a) for a in make_args(B)])], k, s


@pytest.mark.parametrize('nk', [256, 1024])
@pytest.mark.parametrize('z', [(0.0,), (0.0, 0.5, 1.0)])
@pytest.mark.parametrize('fft_engine', ['auto', 'kernel'])
def test_pipeline_against_jax(nk, z, fft_engine):
    (xi_ref, chi_ref, sigma8_ref), k_ref, s_ref = jax_outputs(nk, z)
    fn, k, s = make_pk_to_xi_pipeline_batched(nk=nk, z=z, fft_engine=fft_engine)
    xi, chi, sigma8 = fn(*[torch.from_numpy(a) for a in make_args(B)])
    assert xi.shape == (B, len(z), nk) and chi.shape == (B, 3) and sigma8.shape == (B,)
    np.testing.assert_allclose(k, k_ref, rtol=0)
    np.testing.assert_allclose(s, s_ref, rtol=RTOL)
    xi, xi_ref = xi.numpy(), xi_ref.reshape(xi.shape)
    assert (np.abs(xi - xi_ref).max(axis=-1) / np.abs(xi_ref).max(axis=-1)).max() <= XI_BAR
    np.testing.assert_allclose(chi.numpy(), chi_ref, rtol=RTOL)
    np.testing.assert_allclose(sigma8.numpy(), sigma8_ref, rtol=RTOL)


def test_pipeline_gradient_in_logA():
    """P(k) and so xi scale as A_s = 1e-10 exp(logA), sigma8 as its square
    root: d xi / d logA = xi and d sigma8 / d logA = sigma8 / 2, through the
    fused FFTLog's backward pass."""
    fn, _, _ = make_pk_to_xi_pipeline_batched(nk=256, fft_engine='kernel')
    args = [torch.from_numpy(a) for a in make_args(2, seed=1)]
    logA = args[-1].clone().requires_grad_(True)
    xi, chi, sigma8 = fn(*args[:-1], logA)
    cot = torch.from_numpy(np.random.default_rng(2).normal(size=tuple(xi.shape)))
    grad_xi, = torch.autograd.grad(xi, logA, cot, retain_graph=True)
    np.testing.assert_allclose(grad_xi.numpy(), (xi * cot).sum(dim=(1, 2)).detach().numpy(), rtol=1e-12)
    grad_sigma8, = torch.autograd.grad(sigma8.sum(), logA)
    np.testing.assert_allclose(grad_sigma8.numpy(), sigma8.detach().numpy() / 2, rtol=1e-12)


DERIV_ARGNUMS = (0, 2, 4)   # omega_cdm, h, logA


@functools.lru_cache(maxsize=None)
def jax_halofit_derivatives():
    fn, _, _ = jmake(nk=128, z=jnp.asarray([0.0]), non_linear='halofit')
    args = [jnp.asarray(a) for a in make_args(2, seed=3)]
    jac = jax.jit(jax.jacfwd(lambda *a: fn(*a)[::2], argnums=DERIV_ARGNUMS))(*args)
    rng = np.random.default_rng(4)
    cot = (rng.normal(size=(2, 1, 128)), rng.normal(size=2))
    grads = jax.jit(lambda *a: jax.vjp(lambda *b: fn(*b)[::2], *a)[1](cot))(*args)
    return jac, cot, [grads[i] for i in DERIV_ARGNUMS]


def test_pipeline_jacfwd_and_vjp_against_jax():
    """The Fisher contract (tests/test_pipelines.py::test_fisher_jacfwd) on
    the halofit pipeline, through the FFTLog kernel's autograd.Function:
    its jvp and vmap rules (forward mode) and its backward (reverse mode)."""
    jac_ref, cot, grads_ref = jax_halofit_derivatives()
    fn, _, _ = make_pk_to_xi_pipeline_batched(nk=128, non_linear='halofit', fft_engine='kernel')
    args = [torch.from_numpy(a) for a in make_args(2, seed=3)]
    jac = torch.func.jacfwd(lambda *a: fn(*a)[::2], argnums=DERIV_ARGNUMS)(*args)
    for out, bar in zip(range(2), (1e-10, 1e-13)):
        for got, ref in zip(jac[out], jac_ref[out]):
            ref = np.asarray(ref)
            assert got.shape == ref.shape
            assert np.abs(got.numpy() - ref).max() <= bar * np.abs(ref).max()
    leaves = [a.clone().requires_grad_(True) if i in DERIV_ARGNUMS else a for i, a in enumerate(args)]
    xi, _, sigma8 = fn(*leaves)
    loss = (xi * torch.from_numpy(cot[0])).sum() + (sigma8 * torch.from_numpy(cot[1])).sum()
    grads = torch.autograd.grad(loss, [leaves[i] for i in DERIV_ARGNUMS])
    for got, ref in zip(grads, grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


@pytest.mark.parametrize('non_linear', [False, 'halofit'])
def test_per_cosmology_pipeline_against_jax(non_linear):
    """make_pk_to_xi_pipeline: 0-d tensors in, the JAX fn's shapes out
    (xi (nz, nk), chi (3,), sigma8 ()), and its Fisher derivatives in all
    five parameters by torch.func.jacfwd against jax.jacfwd. Bars, of each
    output's max: xi 1e-12 (measured 3.7e-14), 1e-11 with halofit (2.9e-14);
    its derivatives 1e-12 (1.7e-13), 1e-10 with halofit (2.2e-12); chi and
    sigma8 and theirs 1e-13 (<= 1.0e-15)."""
    args = [a[0] for a in make_args(1, seed=5)]
    z = (0.0, 1.0)
    fn, k, s = make_pk_to_xi_pipeline(nk=128, z=z, non_linear=non_linear, fft_engine='kernel')
    jfn, jk, js = jmake_single(nk=128, z=jnp.asarray(z), non_linear=non_linear)
    np.testing.assert_allclose(s, js, rtol=RTOL)
    targs = [torch.tensor(a, dtype=torch.float64) for a in args]
    got = fn(*targs)
    ref = jax.jit(jfn)(*args)
    assert [tuple(o.shape) for o in got] == [(2, 128), (3,), ()]
    bars = (XI_BAR if not non_linear else 1e-11, RTOL, RTOL)
    for o, r, bar in zip(got, ref, bars):
        assert np.abs(o.numpy() - np.asarray(r)).max() <= bar * np.abs(np.asarray(r)).max()
    jac = torch.func.jacfwd(fn, argnums=(0, 1, 2, 3, 4))(*targs)
    jac_ref = jax.jit(jax.jacfwd(jfn, argnums=(0, 1, 2, 3, 4)))(*args)
    bars = (1e-10 if non_linear else XI_BAR, RTOL, RTOL)
    for out, bar in zip(range(3), bars):
        for got_d, ref_d in zip(jac[out], jac_ref[out]):
            ref_d = np.asarray(ref_d)
            assert tuple(got_d.shape) == ref_d.shape
            assert np.abs(got_d.numpy() - ref_d).max() <= bar * np.abs(ref_d).max()


def test_distance_pipeline_against_jax():
    """make_distance_pipeline and the Fisher contract of
    tests/test_pipelines.py::test_fisher_jacfwd: jacfwd of chi(zq) in
    (omega_cdm, omega_b, h), one cosmology at a time as the JAX fn, and the
    batch in one call (rtol 1e-12, measured 6.7e-16, and 4.0e-16 for the
    Jacobian)."""
    fn, zq = make_distance_pipeline()
    jfn, jzq = jmake_distance()
    np.testing.assert_allclose(zq, jzq, rtol=1e-15)
    args = [a[:3] for a in make_args(3, seed=6)[:3]]
    batch = fn(*[torch.from_numpy(a) for a in args])
    assert tuple(batch.shape) == (3, 60)
    for i in range(3):
        row = [torch.tensor(a[i], dtype=torch.float64) for a in args]
        np.testing.assert_allclose(fn(*row).numpy(), np.asarray(jax.jit(jfn)(*[a[i] for a in args])), rtol=1e-12)
        np.testing.assert_allclose(batch[i].numpy(), fn(*row).numpy(), rtol=1e-15)
        jac = torch.stack(torch.func.jacfwd(fn, argnums=(0, 1, 2))(*row), dim=-1)
        jac_ref = np.stack(jax.jit(jax.jacfwd(jfn, argnums=(0, 1, 2)))(*[a[i] for a in args]), axis=-1)
        assert tuple(jac.shape) == jac_ref.shape == (60, 3)
        np.testing.assert_allclose(jac.numpy(), jac_ref, rtol=1e-12, atol=1e-12 * np.abs(jac_ref).max())


def test_import_without_jax():
    """The port and its pipeline run with JAX made unimportable."""
    code = ('import sys; sys.modules["jax"] = None\n'
            'import torch, cosmoprimo_tpu_torch\n'
            'fn, k, s = cosmoprimo_tpu_torch.make_pk_to_xi_pipeline_batched(nk=128)\n'
            'xi, chi, sigma8 = fn(*[torch.full((2,), v, dtype=torch.float64) for v in (0.12, 0.022, 0.68, 0.96, 3.0)])\n'
            'assert bool(torch.isfinite(xi).all()) and xi.shape == (2, 1, 128)\n'
            'assert not any(m == "jax" or m.startswith(("jax.", "cosmoprimo_tpu.")) or m == "cosmoprimo_tpu"'
            ' for m in sys.modules if sys.modules[m] is not None)\n'
            'print("ok")\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == 'ok', proc.stderr
