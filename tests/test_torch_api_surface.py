"""The port's public API surface (slice 7) against the JAX package's, on the
CPU, with the same inputs made from seeds with numpy.

- The surface itself: for every module of the JAX package, each public name
  it defines (and, for a package's ``__init__`` or a module with
  ``__all__``, each name it re-exports), each public method of those
  classes, and each parameter of those signatures, in the same positions,
  exist in the port's module of the same path, but for the exclusions
  below, each with its reason.
- The helpers of ``ops``: romberg with ``args`` and ``return_error``
  (1e-12), gauss_legendre (1e-13; with float bounds, the weights on the
  integrand's device and the nodes on ``device``), odeint rk1/rk2/rk4 (1e-12), loggamma
  against scipy on tests/test_ops.py's 500 points (1e-12, the JAX bar),
  gamma on real and complex inputs (1e-12).
- FFTlog.inv against the JAX package's inv (tests/test_utils.py's case,
  1e-12 before the postfactor, which spans 21 decades); a call, inv() and
  a call, against a transform inverted before its first call (exact) and
  a fresh CorrelationToPower (1e-12 before the postfactor); the round trip
  on the headline grid (1e-4 for 1e-3 < k < 1 h/Mpc, measured 4.3e-5); a
  complex=True transform raising after inv() in both packages; the
  reference's engine names.
- Interpolators: copy (exact), deepcopy, bounds_error raising in both
  packages and not inside the range.
- LeastSquareSolver's coefficients, chi2 and compute_inverse=False (accepted
  and ignored in both packages) against the JAX package (1e-12), ln_1e10_A_s of the eisenstein_hu and bbks
  engines (1e-13), the Fourier section getter, the namespaces'
  re-exports, flatarray's dtype, exception, setup_logging and savefig.
"""

import importlib
import inspect
import logging
import os

import numpy as np
import pytest
import torch
from scipy import special as sps

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import cosmoprimo_tpu  # noqa: E402
import cosmoprimo_tpu_torch  # noqa: E402
from cosmoprimo_tpu import fftlog as JF, utils as JU  # noqa: E402
from cosmoprimo_tpu.fiducial import DESI as JaxDESI  # noqa: E402
from cosmoprimo_tpu.ops import odeint as jax_odeint, quadrature as JQ, spline as JS  # noqa: E402
from cosmoprimo_tpu_torch import fftlog as F, utils as U  # noqa: E402
from cosmoprimo_tpu_torch.fiducial import DESI  # noqa: E402
from cosmoprimo_tpu_torch.ops import misc, odeint, quadrature, special, spline  # noqa: E402

RTOL = 1e-12

# ----------------------------------------------------------------------------
# The surface
# ----------------------------------------------------------------------------

#: JAX modules with no counterpart of that path, and why.
EXCLUDED_MODULES = {
    'cosmoprimo_tpu.jax': "the JAX-API compat shim (the reference's cosmoprimo.jax); the port has no JAX",
    'cosmoprimo_tpu.ops.fft': 'fft_pair, rfft_pair, irfft_pair: the real-pair float64 FFT of a TPU, which has no '
                              'complex128; the port uses torch.fft and its CUDA kernel',
    'cosmoprimo_tpu.ops.pallas_fft': 'the Pallas kernel and its double-single helpers, ported as '
                                     'csrc/fftlog_core.cu with ops/fftlog_kernel.py',
}
#: JAX modules whose counterpart has another path: the bindings carry the package's name.
RENAMED_MODULES = {
    'cosmoprimo_tpu.bindings.cobaya.cosmoprimo_tpu': 'cosmoprimo_tpu_torch.bindings.cobaya.cosmoprimo_tpu_torch',
    'cosmoprimo_tpu.bindings.cosmosis.cosmoprimo_tpu_interface':
        'cosmoprimo_tpu_torch.bindings.cosmosis.cosmoprimo_tpu_torch_interface',
}
RENAMED_NAMES = {'CosmoprimoTPU': 'CosmoprimoTPUTorch'}

_FLAX = "flax's Module machinery; the port's MLP is a torch.nn.Module with the same layers and parameter names"
_BATCH_FIRST = 'batch-first: the port takes every lane of a batch at once'
#: 'module:name', 'module:Class.member' or 'module:function(parameter)', and why.
EXCLUDED = {
    '*:tree_flatten': 'JAX pytree registration', '*:tree_unflatten': 'JAX pytree registration',
    '*:fft_pair': 'TPU-only real-pair FFT (ops/fft.py)', '*:rfft_pair': 'TPU-only real-pair FFT (ops/fft.py)',
    '*:irfft_pair': 'TPU-only real-pair FFT (ops/fft.py)',
    'cosmoprimo_tpu.parallel.distributed:JaxDistributedComm': 'replaced by TorchDistributedComm',
    'cosmoprimo_tpu.emulators.mlp:init_train_state': "a flax/optax train state; the port's MLP holds its own "
                                                     'parameters and fits with torch.optim',
    'cosmoprimo_tpu.emulators.mlp:params_shardings': 'jax.sharding layouts; the port shards through '
                                                     'parallel/mesh.py and MLP(mesh=...)',
    'cosmoprimo_tpu.emulators.mlp:MLP.parent': _FLAX, 'cosmoprimo_tpu.emulators.mlp:MLP.name': _FLAX,
    'cosmoprimo_tpu.emulators.mlp:MLP.scope': _FLAX,
    'cosmoprimo_tpu.emulators.mlp:MLP.dtype': _FLAX + ', float64 only',
    'cosmoprimo_tpu.emulators.mlp:MLP.batch_norm': _FLAX + ': a dataclass field there, set in __init__ here',
    'cosmoprimo_tpu.emulators.mlp:MLP.__init__': _FLAX + ': MLP(fan_in, features, activation, batch_norm, device, '
                                                 'mesh) for the dataclass fields and parent, name',
    'cosmoprimo_tpu.emulators.mlp:MLP.__call__': _FLAX + ': torch.nn.Module.__call__ runs forward(x, rows=None); '
                                                 'train() and eval() set the mode that flax passes as train=',
    'cosmoprimo_tpu.emulators.mlp:make_train_step': 'the port steps torch.optim: (model, optimizer, '
                                                    'learning_rate) for (model, tx, mesh)',
    'cosmoprimo_tpu.boltzmann.perturbations:deriv_full': _BATCH_FIRST + ': (y, lanes, c) for (y, k, eta, c, am)',
    'cosmoprimo_tpu.boltzmann.perturbations:deriv_rsa': _BATCH_FIRST + ': (yB, lanes, c) for (yB, k, eta, c, am)',
    'cosmoprimo_tpu.boltzmann.perturbations:adiabatic_ics': _BATCH_FIRST + ': (tabs, lanes, eta_ini) for '
                                                            '(tabs, k, eta_ini)',
    'cosmoprimo_tpu.boltzmann.tensor:deriv_tensor': _BATCH_FIRST + ': (y, lanes, c) for (y, k, eta, c)',
    'cosmoprimo_tpu.models.halofit:halofit': _BATCH_FIRST + ': the (B, nz, nk) table pk_t for pk_kz',
    'cosmoprimo_tpu.models.halofit:sigma_gauss2': _BATCH_FIRST + ': pk_t for pk_kz',
    'cosmoprimo_tpu.models.hmcode:dewiggle': _BATCH_FIRST + ': pk_t for pk_kz',
    'cosmoprimo_tpu.models.hmcode:sigma_tophat2': _BATCH_FIRST + ': pk_t for pk_kz',
    'cosmoprimo_tpu.models.hmcode:sigma_v2': _BATCH_FIRST + ': pk_t for pk_kz',
    'cosmoprimo_tpu.pipelines:apply_non_linear': _BATCH_FIRST + ': pk_t for pkz',
}

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(cosmoprimo_tpu.__file__)))


def _jax_modules():
    """Every module of the JAX package by its dotted name, sorted."""
    names = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(_ROOT, 'cosmoprimo_tpu')):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith(('_', '.')))
        for filename in sorted(filenames):
            if filename.endswith('.py') and filename != '__main__.py':
                name = os.path.relpath(os.path.join(dirpath, filename), _ROOT)[:-3].replace(os.sep, '.')
                names.append(name[:-len('.__init__')] if name.endswith('.__init__') else name)
    return sorted(names)


JAX_MODULES = [name for name in _jax_modules() if name not in EXCLUDED_MODULES]


def _excluded(module, name):
    return f'*:{name.split(".")[-1].split("(")[0]}' in EXCLUDED or f'{module}:{name}' in EXCLUDED


def _parameters(obj):
    try:
        return list(inspect.signature(obj).parameters.values())
    except (TypeError, ValueError):
        return None


def _signature_gaps(module, label, jax_obj, port_obj):
    """The parameters of ``jax_obj`` missing from ``port_obj``, or out of
    their place: the port's signature starts with the JAX one's named
    parameters (it may add its own after them), and has *args / **kwargs
    where the JAX one does."""
    if _excluded(module, label):
        return []
    jax_params, port_params = _parameters(jax_obj), _parameters(port_obj)
    if jax_params is None or port_params is None:
        return []
    port_kinds = {p.kind for p in port_params}
    port_names = [p.name for p in port_params if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    gaps = []
    named = [p for p in jax_params if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    for i, p in enumerate(named):
        if p.name not in port_names:
            gaps.append(f'{label}({p.name})')
        elif p.kind == p.POSITIONAL_OR_KEYWORD and port_names.index(p.name) != i:
            gaps.append(f'{label}({p.name}) at position {port_names.index(p.name)}, not {i}')
    for p in jax_params:
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and p.kind not in port_kinds:
            gaps.append(f'{label}({"*" if p.kind == p.VAR_POSITIONAL else "**"}{p.name})')
    return gaps


def _names(jax_module, module):
    """The public names to check in ``jax_module``."""
    names = set()
    namespace = jax_module.__file__.endswith('__init__.py') or hasattr(jax_module, '__all__')
    for name in getattr(jax_module, '__all__', dir(jax_module)):
        if name.startswith('_') or inspect.ismodule(getattr(jax_module, name, None)):
            continue
        owner = getattr(getattr(jax_module, name), '__module__', None)
        if owner == module or (namespace and isinstance(owner, str) and owner.startswith('cosmoprimo_tpu.')):
            names.add(name)
    if module == 'cosmoprimo_tpu':   # the lazy top-level namespace
        names |= {name for name in cosmoprimo_tpu._API if name != 'jax'}
    return sorted(names)


def _member_owner(cls, member):
    return next((klass for klass in cls.__mro__ if member in klass.__dict__), None)


@pytest.mark.parametrize('module', JAX_MODULES)
def test_surface_parity(module):
    """Each public name, method and parameter of the JAX module exists in the
    port's module of the same path (bar the exclusions, with their reasons)."""
    jax_module = importlib.import_module(module)
    port_name = RENAMED_MODULES.get(module, module.replace('cosmoprimo_tpu', 'cosmoprimo_tpu_torch', 1))
    port_module = importlib.import_module(port_name)
    gaps = []
    for name in _names(jax_module, module):
        jax_obj = getattr(jax_module, name)
        home = getattr(jax_obj, '__module__', module)   # exclusions go by the defining module
        if _excluded(home, name):
            continue
        port_obj = getattr(port_module, RENAMED_NAMES.get(name, name), None)
        if port_obj is None:
            gaps.append(name)
            continue
        if not inspect.isclass(jax_obj):
            if callable(jax_obj):
                gaps += _signature_gaps(home, name, jax_obj, port_obj)
            continue
        for member in sorted(set(dir(jax_obj))):
            if member.startswith('_') and member not in ('__init__', '__call__'):
                continue
            owner = _member_owner(jax_obj, member)
            if owner is None or not owner.__module__.startswith('cosmoprimo_tpu.'):
                continue   # inherited from object, flax, ...
            label = f'{name}.{member}'
            if _excluded(home, label):
                continue
            if not hasattr(port_obj, member):
                gaps.append(label)
                continue
            static = inspect.getattr_static(jax_obj, member)
            if callable(getattr(jax_obj, member)) and not isinstance(static, property):
                gaps += _signature_gaps(home, label, getattr(jax_obj, member), getattr(port_obj, member))
    assert not gaps, f'{port_name} lacks: {", ".join(gaps)}'


def test_exclusions_name_real_things():
    """Each exclusion names a module, name, member or parameter that the JAX
    package has, so that a misspelt entry excludes nothing by mistake."""
    for module in EXCLUDED_MODULES:
        assert importlib.util.find_spec(module) is not None, module
    for key, reason in EXCLUDED.items():
        assert reason
        module, name = key.split(':')
        if module == '*':
            continue
        obj = importlib.import_module(module)
        for part in name.split('.'):
            assert hasattr(obj, part), key
            obj = getattr(obj, part)


def test_namespace_reexports():
    import cosmoprimo_tpu_torch.emulators as emulators
    from cosmoprimo_tpu_torch import fiducial, interpolator
    from cosmoprimo_tpu_torch.emulators import tools
    from cosmoprimo_tpu_torch.ops import bcast_dtype
    from cosmoprimo_tpu_torch.utils import setup_logging
    assert emulators.Cosmology is cosmoprimo_tpu_torch.Cosmology
    assert emulators.setup_logging is setup_logging and tools.setup_logging is setup_logging
    assert emulators.MLP is emulators.mlp.MLP
    assert emulators.PowerSpectrumInterpolator1D is interpolator.PowerSpectrumInterpolator1D
    assert emulators.Interpolator1D is spline.Interpolator1D
    assert interpolator.bcast_dtype is bcast_dtype
    assert cosmoprimo_tpu_torch.fiducial is fiducial
    for name in ('BaseEngine', 'BaseSection', 'get_engine', 'CosmologyComputationError', 'Background',
                 'Thermodynamics', 'Primordial', 'Perturbations', 'Transfer', 'Harmonic', 'Fourier'):
        assert getattr(cosmoprimo_tpu_torch, name) is getattr(cosmoprimo_tpu_torch.cosmology, name)


# ----------------------------------------------------------------------------
# ops
# ----------------------------------------------------------------------------

def test_romberg_args_and_error():
    ref, ref_err = jax.jit(lambda: JQ.romberg(lambda x, p, q: jnp.exp(-p * x) * jnp.cos(q * x), 0.0, 2.0, (0.7, 3.0),
                                              divmax=12, return_error=True))()
    # positionally, as the JAX package takes them: args is the fourth argument
    got, err = quadrature.romberg(lambda x, p, q: torch.exp(-p * x) * torch.cos(q * x), 0.0, 2.0, (0.7, 3.0),
                                  divmax=12, return_error=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    np.testing.assert_allclose(err.numpy(), np.asarray(ref_err), rtol=1e-6, atol=1e-16)
    exact = (0.7 + np.exp(-1.4) * (3.0 * np.sin(6.0) - 0.7 * np.cos(6.0))) / (0.7 ** 2 + 9.0)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-12)
    # per-row upper limits, with args and the error
    b = np.array([1.0, 1.5, 2.5])
    got, err = quadrature.romberg(lambda x, p: torch.exp(-p * x), 0.0, torch.from_numpy(b), (0.5,), return_error=True)
    ref = jax.jit(jax.vmap(lambda bb: JQ.romberg(lambda x, p: jnp.exp(-p * x), 0.0, bb, (0.5,))))(jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    assert got.shape == err.shape == (3,)


@pytest.mark.parametrize('case', ['scalar', 'trailing', 'batched'])
def test_gauss_legendre(case):
    rng = np.random.default_rng(3)
    if case == 'batched':
        a, b = rng.uniform(0.0, 1.0, 5), rng.uniform(2.0, 3.0, 5)
        got = quadrature.gauss_legendre(lambda x: torch.exp(-x) * torch.cos(3 * x), torch.from_numpy(a),
                                        torch.from_numpy(b), n=64).numpy()
        ref = [float(JQ.gauss_legendre(lambda x: jnp.exp(-x) * jnp.cos(3 * x), aa, bb, n=64)) for aa, bb in zip(a, b)]
    elif case == 'trailing':
        w = rng.uniform(0.5, 2.0, 4)
        got = quadrature.fixed_quad_legendre(lambda x: torch.sin(x[:, None] * torch.from_numpy(w)), 0.1, 2.0).numpy()
        ref = np.asarray(JQ.fixed_quad_legendre(lambda x: jnp.sin(x[:, None] * jnp.asarray(w)), 0.1, 2.0))
    else:
        got = quadrature.gauss_legendre(lambda x: x ** 3 - x, -1.0, 2.5, n=16).numpy()
        ref = np.asarray(JQ.gauss_legendre(lambda x: x ** 3 - x, -1.0, 2.5, n=16))
    np.testing.assert_allclose(got, ref, rtol=1e-13)


@pytest.mark.parametrize('case', ['integrand elsewhere', 'nodes elsewhere'])
def test_gauss_legendre_device(case):
    """Float bounds: the weights follow the integrand's values to their
    device, and ``device`` places the nodes (the meta device stands in for
    the card)."""
    if case == 'integrand elsewhere':
        out = quadrature.gauss_legendre(lambda x: torch.exp(-x.to('meta')), 0.0, 1.0, n=8)
    else:
        seen = []
        out = quadrature.gauss_legendre(lambda x: seen.append(x.device) or x * x, 0.0, 1.0, n=8, device='meta')
        assert seen == [torch.device('meta')]
    assert out.device.type == 'meta' and out.shape == ()


@pytest.mark.parametrize('method', ['rk1', 'rk2', 'rk4'])
@pytest.mark.parametrize('shape', ['scalar', 'vector'])
def test_odeint(method, shape):
    rng = np.random.default_rng(5)
    t = np.linspace(0.0, 2.0, 41)
    y0 = 1.3 if shape == 'scalar' else rng.uniform(0.5, 1.5, 3)
    coef = np.array([0.5, -0.3, 0.8])

    def rhs(xp, y, tt, c):
        return -c * y * tt + xp.sin(tt)

    ref = np.asarray(jax_odeint(lambda y, tt, c: rhs(jnp, y, tt, c), y0, jnp.asarray(t), args=(jnp.asarray(coef[0]) if
                               shape == 'scalar' else jnp.asarray(coef),), method=method))
    got = odeint(lambda y, tt, c: rhs(torch, y, tt, c), y0, torch.from_numpy(t),
                        args=(torch.tensor(coef[0]) if shape == 'scalar' else torch.from_numpy(coef),),
                        method=method).numpy()
    assert got.shape == ref.shape == t.shape + np.shape(y0)
    np.testing.assert_array_equal(got[0], y0)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_odeint_unknown_method():
    with pytest.raises(ValueError):
        odeint(lambda y, t: y, 1.0, torch.linspace(0, 1, 3, dtype=torch.float64), method='euler')


def test_loggamma_vs_scipy():
    rng = np.random.default_rng(42)   # tests/test_ops.py::test_loggamma_vs_scipy's points
    z = np.concatenate([
        rng.uniform(-8, 8, 200) + 1j * rng.uniform(-400, 400, 200),
        rng.uniform(-8, 8, 200) + 1j * rng.uniform(-3, 3, 200),
        rng.uniform(0.5, 5, 100) + 1j * rng.uniform(-50, 50, 100),
    ])
    got = special.loggamma(torch.from_numpy(z))
    assert got.dtype == torch.complex128
    ref = sps.loggamma(z)
    assert np.max(np.abs(got.numpy() - ref) / np.maximum(np.abs(ref), 1e-10)) < RTOL


@pytest.mark.parametrize('kind', ['real', 'complex'])
def test_gamma_vs_scipy(kind):
    rng = np.random.default_rng(7)
    if kind == 'real':
        z = np.concatenate([rng.uniform(0.05, 8.0, 100), rng.uniform(-5.9, -0.1, 100)])
    else:
        z = rng.uniform(-4.5, 4.5, 200) + 1j * rng.uniform(-3.0, 3.0, 200)
    got = special.gamma(torch.from_numpy(z))
    assert got.dtype == (torch.float64 if kind == 'real' else torch.complex128)
    np.testing.assert_allclose(got.numpy(), sps.gamma(z), rtol=RTOL)


def test_misc_helpers():
    seen = []
    misc.exception(lambda a, b: seen.append((a, b)), torch.arange(3.0), 'x')
    assert isinstance(seen[0][0], np.ndarray) and seen[0][1] == 'x'

    class Table(object):
        device = torch.device('cpu')

        @misc.flatarray(dtype=np.float32)
        def f32(self, x):
            return 2 * x

        @misc.flatarray(dtype=torch.float64)
        def f64(self, x):
            return 2 * x

    assert Table().f32(np.ones((2, 3))).dtype == torch.float32
    assert Table().f64(np.ones(2, dtype=np.float32)).dtype == torch.float64
    from cosmoprimo_tpu_torch.ops import roots
    lo, hi = roots.bracket(lambda x: x - 0.3, (torch.tensor(1.0, dtype=torch.float64), 0.2), maxtries=3)
    assert float(lo) <= 0.3 <= float(hi)


# ----------------------------------------------------------------------------
# FFTlog
# ----------------------------------------------------------------------------

def _pk(k):
    return 1e4 * (k / 0.1) ** 0.96 / (1 + (k / 0.1) ** 3)


def test_fftlog_inv_against_jax():
    k = np.geomspace(1e-4, 1e2, 512)   # tests/test_utils.py::test_fftlog_inv's case
    pk = _pk(k)
    ref = JF.PowerToCorrelation(k)
    s_ref, xi_ref = ref(pk)
    ref.inv()
    k_ref, pk_ref = ref(np.asarray(xi_ref))
    got = F.PowerToCorrelation(k)
    s, xi = got(torch.from_numpy(pk))
    got.inv()
    k_back, pk_back = got(xi)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=RTOL)
    np.testing.assert_allclose(xi.numpy(), np.asarray(xi_ref), rtol=0, atol=RTOL * np.abs(xi_ref).max())
    np.testing.assert_allclose(k_back.numpy(), np.asarray(k_ref), rtol=RTOL)
    # the inverted postfactor k^-1.5 spans 21 decades of the padded grid and
    # scales each point's rounding by as much: before it the packages agree
    # to 5.5e-16 of the max, after it to 1.3e-11 (at the grid's edges), and
    # to 5.2e-14 of each value in test_fftlog_inv's band
    left = got.padded_size_out_left
    post = got.padded_postfactor[0, left:left + k.size]
    pk_ref = np.asarray(pk_ref)
    assert np.max(np.abs(pk_back.numpy() - pk_ref) / post) <= RTOL * np.max(np.abs(pk_ref) / post)
    mask = (k > 1e-2) & (k < 10)
    np.testing.assert_allclose(pk_back.numpy()[mask], pk_ref[mask], rtol=RTOL)
    np.testing.assert_allclose(pk_back.numpy()[mask], pk[mask], rtol=2e-3)


def test_inv_drops_device_arrays():
    """A transform called before inv() gives what one inverted before its
    first call gives: inv() drops the factors made for a device. Both equal
    a fresh CorrelationToPower on the s grid, which has the same u (|u| = 1
    for a spherical Bessel kernel at q = 1.5, so 1/conj(u) = u) and the same
    pre- times postfactor, before the postfactor to rounding (measured
    8.2e-16 of each row's max on the headline grid)."""
    k = np.geomspace(1e-4, 1e2, 256)
    used, fresh = F.PowerToCorrelation(k), F.PowerToCorrelation(k)
    fresh.inv()
    s, xi = used(torch.from_numpy(_pk(k)))
    assert used._device_arrays
    used.inv()
    assert not used._device_arrays
    k_used, pk_used = used(xi)
    k_fresh, pk_fresh = fresh(xi)
    assert torch.equal(k_used, k_fresh) and torch.equal(pk_used, pk_fresh)
    np.testing.assert_allclose(k_used.numpy(), k, rtol=1e-12)
    k_c2p, pk_c2p = F.CorrelationToPower(s.numpy())(xi)
    np.testing.assert_allclose(k_c2p.numpy(), k, rtol=1e-12)
    left = used.padded_size_out_left
    post = used.padded_postfactor[0, left:left + k.size]
    assert np.max(np.abs(pk_used.numpy() - pk_c2p.numpy()) / post) <= RTOL * np.max(np.abs(pk_used.numpy()) / post)


def test_inv_round_trip_headline_grid():
    """The round trip on the headline grid (1e-5 ... 1e2 h/Mpc, 1024 -> 2048),
    on rows drawn as chip_smoke.py draws them: within 1e-4 for
    1e-3 < k < 1 h/Mpc (chip_smoke phase 27 holds the card to this band)."""
    rng = np.random.default_rng(0)
    k = np.geomspace(1e-5, 1e2, 1024)
    amplitude, tilt = rng.uniform(0.5, 2.0, 16), rng.uniform(0.9, 1.0, 16)
    pk = torch.from_numpy(amplitude[:, None] * 1e4 * (k / 0.1) ** tilt[:, None] / (1 + (k / 0.1) ** 3))
    fft = F.PowerToCorrelation(k)
    s, xi = fft(pk)
    fft.inv()
    k_back, pk_back = fft(xi)
    band = (k > 1e-3) & (k < 1.0)
    assert ((pk_back - pk).abs() / pk.abs())[:, band].max().item() <= 1e-4
    np.testing.assert_allclose(k_back.numpy(), k, rtol=1e-12)


def test_inv_complex_raises_in_both():
    k = np.geomspace(1e-4, 1e2, 256)
    pk = np.stack([_pk(k)] * 2)
    ref = JF.PowerToCorrelation(k, ell=[0, 1], complex=True)
    xi_ref = ref(pk)[1]
    ref.inv()
    with pytest.raises(ValueError):
        ref(np.asarray(xi_ref).real)
    got = F.PowerToCorrelation(k, ell=[0, 1], complex=True)
    xi = got(torch.from_numpy(pk))[1]
    got.inv()
    with pytest.raises(ValueError):
        got(xi.real)


@pytest.mark.parametrize('name, engine', [('auto', 'auto'), ('kernel', 'kernel'), ('torch', 'torch'),
                                          ('numpy', 'torch'), ('pair', 'torch'), ('fftw', 'auto'),
                                          ('pallas', 'kernel')])
def test_fft_engine_names(name, engine):
    k = np.geomspace(1e-4, 1e2, 256)
    fft = F.PowerToCorrelation(k, engine=name, check_level=1, block=8)
    assert fft.engine == engine and fft.engine_kwargs == {'block': 8}
    fft.set_fft_engine(name)
    assert fft.engine == engine and fft.engine_kwargs == {}
    got = fft(torch.from_numpy(_pk(k)))[1]
    ref = F.PowerToCorrelation(k, engine='torch')(torch.from_numpy(_pk(k)))[1]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=RTOL * ref.abs().max().item())


def test_fft_engine_unknown_raises_in_both():
    k = np.geomspace(1e-4, 1e2, 256)
    for fft in (JF.PowerToCorrelation(k), F.PowerToCorrelation(k)):
        with pytest.raises(ValueError):
            fft.set_fft_engine('cufft')
    with pytest.raises(ValueError):
        F.PowerToCorrelation(k, engine='cufft')


# ----------------------------------------------------------------------------
# Interpolators, least squares, primordial, section getters
# ----------------------------------------------------------------------------

@pytest.fixture(scope='module')
def desi():
    return DESI(engine='eisenstein_hu', device='cpu')


@pytest.fixture(scope='module')
def power_tables():
    """One P(k) table in each package (the JAX one built under jit: eagerly
    its padding takes ~10 s on the CPU)."""
    k = np.geomspace(1e-4, 10.0, 64)
    JI = importlib.import_module('cosmoprimo_tpu.interpolator')
    ref = jax.jit(lambda pk: JI.PowerSpectrumInterpolator1D(k, pk))(_pk(k))
    return ref, cosmoprimo_tpu_torch.PowerSpectrumInterpolator1D(k, torch.from_numpy(_pk(k)))


def test_interpolator_copy(desi, power_tables):
    pk = desi.get_fourier().pk_interpolator().to_1d(z=0)
    k = np.logspace(-2, 0, 10)
    copy, deep = pk.copy(), pk.deepcopy()
    assert copy is not pk and copy._interp is pk._interp
    assert torch.equal(copy(k), pk(k))
    pk2 = desi.get_fourier().pk_interpolator()
    assert torch.equal(pk2.copy()(k, 0.5), pk2(k, 0.5))
    # deepcopy rebuilds the table from as_dict(): here a spline of the
    # callable's values on the default k grid, in both packages
    assert pk.is_from_callable and not deep.is_from_callable
    np.testing.assert_allclose(deep(k).numpy(), pk(k).numpy(), rtol=1e-4)
    ref, table = power_tables
    assert torch.equal(table.copy()(k), table(k))
    np.testing.assert_allclose(table.deepcopy()(k).numpy(), np.asarray(ref(k)), rtol=1e-10)


@pytest.mark.parametrize('name', ['Interpolator1D', 'PowerSpectrumInterpolator1D', 'CorrelationFunctionInterpolator1D'])
def test_bounds_error(name, power_tables):
    if name == 'Interpolator1D':
        x = np.linspace(0.1, 2.0, 20)
        ref, got, inside, outside = (JS.Interpolator1D(x, np.sin(x), k=1),
                                     spline.Interpolator1D(x, torch.from_numpy(np.sin(x)), k=1), 1.5, 2.5)
    elif name == 'PowerSpectrumInterpolator1D':
        ref, got = power_tables
        inside, outside = 0.1, 1e3   # the log-log extrapolation reaches 1e2 h/Mpc
    else:
        s = np.geomspace(1.0, 200.0, 64)
        JI = importlib.import_module('cosmoprimo_tpu.interpolator')
        ref = jax.jit(lambda xi: JI.CorrelationFunctionInterpolator1D(s, xi))(1.0 / s ** 2)
        got = cosmoprimo_tpu_torch.CorrelationFunctionInterpolator1D(s, torch.from_numpy(1.0 / s ** 2))
        inside, outside = 50.0, 300.0
    q_in, q_out = np.array([inside]), np.array([inside, outside])
    np.testing.assert_allclose(got(q_in, bounds_error=True).numpy().ravel(),
                               np.asarray(ref(q_in, bounds_error=True)).ravel(), rtol=RTOL)
    assert np.isnan(got(q_out).numpy().ravel()[-1])
    with pytest.raises(ValueError):
        got(q_out, bounds_error=True)
    with pytest.raises(Exception):   # a host callback's ValueError, re-raised by JAX
        jax.block_until_ready(ref(q_out, bounds_error=True))


def test_interpolator2d_bounds_error():
    x, y = np.linspace(0.0, 1.0, 8), np.linspace(0.0, 2.0, 9)
    f = np.add.outer(np.sin(x), np.cos(y))
    interp = spline.Interpolator2D(x, y, torch.from_numpy(f))
    assert interp(np.array([0.5]), np.array([1.0]), bounds_error=True).shape == (1, 1)
    with pytest.raises(ValueError):
        interp(np.array([0.5, 1.5]), np.array([1.0]), bounds_error=True)
    with pytest.raises(ValueError):
        interp(np.array([0.5]), np.array([3.0]), grid=False, bounds_error=True)


def test_spline_x_fun():
    rng = np.random.default_rng(11)
    x = rng.uniform(0.0, 1.0, 12)
    f = rng.normal(size=(12, 2))
    ref = JS.Interpolator1D(x, f, k=1)
    got = spline.Interpolator1D(x, torch.from_numpy(f), k=1)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(got.fun.numpy(), np.asarray(ref.fun))


def _lsq_cases():
    rng = np.random.default_rng(0)   # tests/test_utils.py's weighted regression and constrained fit
    t = np.linspace(0, 1, 20)
    weighted = (np.stack([np.ones_like(t), t]), 1.5 + 2.0 * t + 0.01 * rng.normal(size=t.size),
                {'precision': rng.uniform(0.5, 2.0, t.size)}, {})
    t = np.linspace(0, 1, 30)
    constrained = (np.stack([np.ones_like(t), t, t ** 2]), 0.5 + t + 2 * t ** 2 + 0.01 * np.sin(20 * t),
                   {'constraint_gradient': np.array([[1.0], [0.0], [0.0]])}, {'constraint': np.array([0.4])})
    batched = (np.stack([np.ones_like(t), t]), np.stack([np.cos(t), np.exp(t)]), {'precision': 2.0}, {})
    return {'weighted': weighted, 'constrained': constrained, 'batched': batched}


@pytest.mark.parametrize('compute_inverse', [True, False])
@pytest.mark.parametrize('case', ['weighted', 'constrained', 'batched'])
def test_least_squares(case, compute_inverse):
    gradient, data, options, call = _lsq_cases()[case]
    ref = JU.LeastSquareSolver(gradient, compute_inverse=compute_inverse, **options)
    ref(data, **call)
    got = U.LeastSquareSolver(gradient, compute_inverse=compute_inverse, **options)
    x = got(data, **{key: torch.from_numpy(value) for key, value in call.items()})
    assert x is got.coefficients
    np.testing.assert_allclose(got.coefficients.numpy(), np.asarray(ref.coefficients), rtol=RTOL)
    np.testing.assert_allclose(got.chi2().numpy(), np.asarray(ref.chi2()), rtol=RTOL)


@pytest.mark.parametrize('engine', ['eisenstein_hu', 'bbks'])
def test_ln_1e10_A_s(engine):
    ref = JaxDESI(engine=engine).get_primordial().ln_1e10_A_s
    got = DESI(engine=engine, device='cpu').get_primordial().ln_1e10_A_s
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)
    np.testing.assert_allclose(got.numpy(), np.log(1e10 * DESI(engine=engine, device='cpu')['A_s'].numpy()), rtol=1e-13)


def test_bbks_compute():
    cosmo = DESI(engine='bbks', device='cpu')
    engine = cosmo.engine
    gamma = engine.gamma
    engine.gamma = None
    engine.compute()
    assert torch.equal(engine.gamma, gamma)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(JaxDESI(engine='bbks').engine.gamma), rtol=1e-13)


def test_section_getters(desi):
    from cosmoprimo_tpu_torch import Background, Fourier, Primordial
    cosmo = desi.clone()
    engine = cosmo.engine
    fo = Fourier(cosmo, engine='bbks', set_engine=False)
    assert cosmo.engine is engine and fo.engine.name == 'bbks'
    assert Background(cosmo).engine is engine
    np.testing.assert_allclose(Primordial(cosmo).A_s.numpy(), cosmo.get_primordial().A_s.numpy(), rtol=0)
    fo = Fourier(cosmo, engine='bbks')
    assert cosmo.engine is fo.engine and cosmo.engine.name == 'bbks'


def test_setup_logging_and_savefig(tmp_path):
    U.setup_logging('debug')
    assert logging.getLogger().level == logging.DEBUG
    U.setup_logging()
    assert logging.getLogger().level == logging.INFO
    matplotlib = pytest.importorskip('matplotlib')
    matplotlib.use('Agg')
    from matplotlib import pyplot as plt
    plt.figure()
    plt.plot([0, 1], [1, 0])
    filename = tmp_path / 'sub' / 'figure.png'
    U.savefig(filename, dpi=40)
    assert filename.exists() and filename.stat().st_size > 0
