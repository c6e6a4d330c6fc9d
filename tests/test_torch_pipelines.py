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
from cosmoprimo_tpu_torch import make_pk_to_xi_pipeline_batched  # noqa: E402

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
