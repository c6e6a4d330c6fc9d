"""The port's emulated engine (cosmoprimo_tpu_torch/emulators/emulated.py)
end to end against the JAX package's EmulatedEngine, on emulator files
made from a seed with numpy (no training): the port serves a batch of
cosmologies in one Cosmology, the JAX package one at a time (jit, vmap).

- The layout of chip_smoke's phase 21 (the 'native-base' recipe: its
  quantity names, inputs, operation chains, the emulator-level
  FourierNormOperation and cl_norm) at a cut width, with a primordial A_s
  net: all five sections on 3 cosmologies, sigma8_m through the plain FFT
  on the CPU. Bar 1e-10 of each row's max (measured <= 1.1e-11, the
  sigma8 input 7.2e-12: the P(k) interpolators pad their tables otherwise
  than the JAX package, ROADMAP queue 3; the other tests <= 6e-16).
- A_s <-> sigma8 in both directions, a theta_MC_100 input and the hybrid
  background (no background nets: the ODE default background).
- torch.func.jacfwd of a capse-style lensed_cl()['tt'] in (logA, n_s, h,
  omega_b, omega_cdm, tau_reio) against jax.jacfwd, 1e-9 of each row's max
  (measured 9.4e-16); jacfwd of sigma8_m through the Fourier path against
  central differences.
- The missing-file CosmologyError of each pretrained engine; an engine
  bound to a file serves that file.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu.emulators import EmulatedEngine as JEmulatedEngine  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, CosmologyError  # noqa: E402
from cosmoprimo_tpu_torch.emulators import EmulatedEngine, Emulator, conversion  # noqa: E402

BAR = 1e-10
ELLMAX = 300
NAMES = ['logA', 'n_s', 'h', 'omega_b', 'omega_cdm', 'm_ncdm', 'w0_fld', 'wa_fld', 'tau_reio']
Z = np.array([0.295, 0.93, 2.33])
K = np.array([1e-3, 0.02, 0.2, 1.0])


def row_err(got, ref):
    """max|got - ref| / max|ref| of each row (leading axis), the worst."""
    got, ref = np.asarray(got).reshape(len(ref), -1), np.asarray(ref).reshape(len(ref), -1)
    return np.max(np.max(np.abs(got - ref), axis=1) / np.max(np.abs(ref), axis=1))


def draw(B, seed=0, names=NAMES):
    """Cosmologies inside the recipe's boxes (w0 + wa < 0)."""
    rng = np.random.default_rng(seed)
    boxes = {'logA': (2.9, 3.2), 'n_s': (0.92, 1.0), 'h': (0.62, 0.76), 'omega_b': (0.021, 0.024),
             'omega_cdm': (0.10, 0.14), 'm_ncdm': (0.06, 0.3), 'w0_fld': (-1.2, -0.8), 'wa_fld': (-0.4, 0.0),
             'tau_reio': (0.04, 0.08), 'sigma8': (0.75, 0.85), 'A_s': (1.9e-9, 2.3e-9)}
    return {name: rng.uniform(*boxes[name], B) for name in names}


@pytest.fixture(scope='module')
def native_base(tmp_path_factory):
    """chip_smoke's phase-21 emulator at a cut width (nets 8 wide, Cls to
    300), with a primordial A_s net, written by the port; and its fourier
    and lensed TT nets alone."""
    state = chip_smoke.native_base_emulator_state(width=8, ellmax_cl=ELLMAX)
    state['engines']['primordial.A_s'] = chip_smoke.mlp_engine_state(
        np.random.default_rng(5), {'logA': (2.8, 3.3), 'n_s': (0.88, 1.06)}, (20, 20), 'silu', (),
        [np.array(2.0e-9), np.array(2.2e-9)])
    directory = tmp_path_factory.mktemp('emulated')
    Emulator.from_state(state).write(directory / 'native_base.npy')
    state['engines'] = {name: engine for name, engine in state['engines'].items()
                        if name.startswith('fourier.') or name == 'harmonic.lensed_cl.tt'}
    Emulator.from_state(state).write(directory / 'fourier_tt.npy')
    return str(directory / 'native_base.npy'), str(directory / 'fourier_tt.npy')


def outputs(cosmo):
    """Every section's outputs, the same calls in both packages."""
    ba, th, pm, fo, hr = (getattr(cosmo, f'get_{name}')() for name in
                          ('background', 'thermodynamics', 'primordial', 'fourier', 'harmonic'))
    pk = fo.pk_interpolator()
    return {'chi': ba.comoving_radial_distance(Z), 'growth_rate': ba.growth_rate(Z),
            'growth_factor': ba.growth_factor(Z), 'time': ba.time(Z), 'efunc': ba.efunc(Z),
            'rho_ncdm': ba.rho_ncdm(Z), 'rs_drag': th.rs_drag, 'z_star': th.z_star, 'A_s': pm.A_s,
            'pk_prim': pm.pk_k(K), 'pk': pk(K, Z), 'pk_cb': fo.pk_interpolator(of='delta_cb')(K, Z),
            'sigma8': fo.sigma8_m, 'tt': hr.lensed_cl()['tt'],
            'ee': hr.unlensed_cl()['ee'], 'pp': hr.lens_potential_cl()['pp'], 'bb': hr.unlensed_cl()['bb']}


def serve(path, params, outputs=outputs, **kwargs):
    """(port, JAX) outputs: the port's batch in one Cosmology, the JAX
    package's cosmologies one at a time (jit, vmap)."""
    cosmo = Cosmology(engine=EmulatedEngine.read(path), ellmax_cl=ELLMAX, device='cpu',
                      **{name: torch.from_numpy(value) for name, value in params.items()}, **kwargs)
    got = {name: value.numpy() for name, value in outputs(cosmo).items()}
    cls, names = JEmulatedEngine.read(path), list(params)

    def one(*values):
        return outputs(jcp.Cosmology(engine=cls, ellmax_cl=ELLMAX, **dict(zip(names, values)), **kwargs))

    ref = jax.jit(jax.vmap(one))(*[jnp.asarray(params[name]) for name in names])
    return got, {name: np.asarray(value) for name, value in ref.items()}


def test_native_base_all_sections_against_jax(native_base):
    got, ref = serve(native_base[0], draw(3))
    got['rho_ncdm'] = np.moveaxis(got['rho_ncdm'], 0, 1)    # the port puts the species first
    for name, value in ref.items():
        assert got[name].shape == value.shape, name
        assert np.isfinite(got[name]).all(), name
        if name == 'bb':   # a fixed output: zeros
            assert not got[name].any()
            continue
        assert row_err(got[name], value) <= BAR, name


def test_sigma8_input_against_jax(native_base):
    """The rescaling direction: sigma8 in, the nets' logA from the A_s guess,
    the tables rescaled so that sigma8_m returns the input (the fourier and
    lensed TT nets of the layout)."""
    def subset(cosmo):
        fo, hr = cosmo.get_fourier(), cosmo.get_harmonic()
        return {'sigma8': fo.sigma8_m, 'pk': fo.pk_interpolator()(K, Z), 'tt': hr.lensed_cl()['tt']}

    params = draw(3, seed=1, names=[name for name in NAMES if name != 'logA'] + ['sigma8'])
    got, ref = serve(native_base[1], params, outputs=subset)
    np.testing.assert_allclose(got['sigma8'], params['sigma8'], rtol=1e-10)
    for name, value in ref.items():
        assert row_err(got[name], value) <= BAR, name


def small_emulator(tmp_path, engines, name):
    fn = tmp_path / name
    Emulator.from_state({'engines': engines, 'fixed': {}, 'xoperations': [], 'yoperations': [],
                         'defaults': {}}).write(fn)
    return str(fn)


def test_A_s_direction_against_jax(tmp_path):
    """The other direction: nets trained on sigma8, a cosmology given A_s;
    the ratio comes from the emulated primordial A_s."""
    rng = np.random.default_rng(6)
    params = {'sigma8': (0.7, 0.9), 'n_s': (0.9, 1.0), 'h': (0.6, 0.8)}
    ell = np.arange(ELLMAX + 1)
    engines = {'primordial.A_s': chip_smoke.mlp_engine_state(rng, params, (8, 8), 'tanh', (),
                                                            [np.array(2.0e-9), np.array(2.2e-9)]),
               'harmonic.lensed_cl.tt': chip_smoke.mlp_engine_state(rng, params, (8, 8), 'silu', ell.shape,
                                                                   [np.full(ell.size, 1e-10), np.full(ell.size, 2e-10)])}
    fn = small_emulator(tmp_path, engines, 'sigma8.npy')

    def subset(cosmo):
        return {'A_s': cosmo.get_primordial().A_s, 'tt': cosmo.get_harmonic().lensed_cl()['tt']}

    got, ref = serve(fn, draw(3, seed=2, names=['A_s', 'n_s', 'h', 'omega_b', 'omega_cdm']), outputs=subset)
    for name, value in ref.items():
        assert row_err(got[name], value) <= BAR, name


class _TracingNumpy(object):
    """numpy, but ``asarray`` is jnp.asarray: the JAX package's hybrid
    background copies its tables to the host with np.asarray, which does not
    trace; with this in its module's ``np``, the same arithmetic runs under
    jit."""

    asarray = staticmethod(jnp.asarray)

    def __getattr__(self, name):
        return getattr(np, name)


def test_theta_input_and_hybrid_background_against_jax(tmp_path, monkeypatch):
    """A thermodynamics net on theta_MC_100 (from the ODE default
    background, as the JAX package takes it) and no background net: the
    Background section serves the default background through its tables
    (the JAX package's host copy of them made traceable, _TracingNumpy)."""
    import cosmoprimo_tpu.emulators.emulated as jemulated
    monkeypatch.setattr(jemulated, 'np', _TracingNumpy())
    rng = np.random.default_rng(7)
    params = {'theta_MC_100': (1.03, 1.05), 'omega_b': (0.02, 0.025)}
    engines = {'thermodynamics.rs_drag': chip_smoke.mlp_engine_state(rng, params, (8, 8), 'tanh', (),
                                                                     [np.array(140.0), np.array(150.0)])}
    fn = small_emulator(tmp_path, engines, 'thermo_only.npy')

    def subset(cosmo):
        ba = cosmo.get_background()
        return {'rs_drag': cosmo.get_thermodynamics().rs_drag, 'chi': ba.comoving_radial_distance(Z),
                'efunc': ba.efunc(Z), 'growth_rate': ba.growth_rate(Z)}

    values = draw(2, seed=3, names=['omega_cdm', 'omega_b', 'h', 'logA', 'n_s'])
    got, ref = serve(fn, values, outputs=subset)
    # the default background's growth table ends near z = 400, short of the
    # 256-point grid's z = 999: both packages' growth spline is NaN there
    assert np.isnan(got.pop('growth_rate')).all() and np.isnan(ref.pop('growth_rate')).all()
    for name, value in ref.items():
        assert row_err(got[name], value) <= BAR, name
    # the path bound through extra_params, as the JAX package's hybrid test binds it
    cosmo = Cosmology(engine='emulated', extra_params={'path': fn}, device='cpu',
                      **{name: torch.from_numpy(value) for name, value in values.items()})
    assert row_err(cosmo.get_thermodynamics().rs_drag.numpy(), ref['rs_drag']) <= BAR


def capse_dir(path, rng, n_out=50):
    """A synthetic jaxcapse TT network, the layout of
    tests/test_emulators.py::_make_synthetic_capse."""
    import json
    sizes = [6, 16, n_out]
    weights = []
    for i in range(len(sizes) - 1):
        weights += [(rng.normal(size=(sizes[i + 1], sizes[i])) * 0.05).ravel(order='F'),
                    rng.normal(size=sizes[i + 1]) * 0.01 + (1.0 if i == len(sizes) - 2 else 0.0)]
    d = path / 'TT'
    d.mkdir(parents=True)
    np.save(d / 'weights.npy', np.concatenate(weights))
    np.save(d / 'nminmax.npy', np.stack([np.array([2.5, 0.9, 60, 0.02, 0.1, 0.01]),
                                         np.array([3.5, 1.0, 75, 0.024, 0.14, 0.10])], axis=-1))
    np.save(d / 'outminmax.npy', np.stack([np.zeros(n_out), np.ones(n_out)], axis=-1))
    with open(d / 'nn_setup.json', 'w') as f:
        json.dump({'n_input_features': 6, 'n_output_features': n_out,
                   'layers': {'layer_1': {'n_neurons': 16, 'activation_function': 'silu'}}}, f)


def test_capse_jacfwd_against_jax(tmp_path):
    """BASELINE config #5: lensed_cl()['tt'] of a capse-style emulator with
    torch.func.jacfwd in (logA, n_s, h, omega_b, omega_cdm, tau_reio), on 2
    cosmologies in one batch, against jax.jacfwd one at a time."""
    capse_dir(tmp_path, np.random.default_rng(11))
    fn = str(tmp_path / 'capse.npy')
    conversion.convert_jaxcapse_to_cosmoprimo(tmp_path).write(fn)
    names = ['logA', 'n_s', 'h', 'omega_b', 'omega_cdm', 'tau_reio']
    values = draw(2, seed=4, names=names)
    cls, jcls = EmulatedEngine.read(fn), JEmulatedEngine.read(fn)

    def tt(*args):
        return Cosmology(engine=cls, ellmax_cl=49, **dict(zip(names, args))).get_harmonic().lensed_cl()['tt']

    def jtt(*args):
        return jcp.Cosmology(engine=jcls, ellmax_cl=49, **dict(zip(names, args))).get_harmonic().lensed_cl()['tt']

    targs = [torch.from_numpy(values[name]) for name in names]
    value = tt(*targs)
    jac = torch.func.jacfwd(tt, argnums=tuple(range(6)))(*targs)
    ref = jax.jit(jax.vmap(jtt))(*[jnp.asarray(values[name]) for name in names])
    jac_ref = jax.jit(jax.vmap(jax.jacfwd(jtt, argnums=tuple(range(6)))))(*[jnp.asarray(values[n]) for n in names])
    assert tuple(value.shape) == (2, 50) and not value[:, :2].any()
    assert row_err(value.numpy(), np.asarray(ref)) <= BAR
    for got, expected in zip(jac, jac_ref):
        diagonal = torch.stack([got[i, :, i] for i in range(2)]).numpy()    # each row's own derivative
        assert not torch.stack([got[i, :, 1 - i] for i in range(2)]).any()
        assert row_err(diagonal, np.asarray(expected)) <= 1e-9


def test_missing_file_raises(tmp_path):
    """No download: a missing emulator file raises CosmologyError naming
    its path, in both packages."""
    missing = str(tmp_path / 'missing.npy')
    for package, kwargs in ((jcp, {}), (None, {'device': 'cpu'})):
        Cos = package.Cosmology if package is not None else Cosmology
        Error = package.CosmologyError if package is not None else CosmologyError
        with pytest.raises(Error, match='missing.npy not found'):
            Cos(engine='emulated', extra_params={'path': missing}, **kwargs)
        for engine in ('capse', 'cosmopower_bolliet2023', 'emu_camb_mnu_w_wa_cmb', 'cosmopower_jense2024'):
            with pytest.raises(Error, match='emulator.npy not found'):
                Cos(engine=engine, **kwargs)



def test_engine_bound_per_file(tmp_path):
    """An engine class bound to a file caches that file's emulator; a
    subclass bound to another file (EmulatedEngine.read on a bound class)
    serves its own file, not the cached one it would inherit (the JAX
    package's class attribute lookup inherits it: ROADMAP queue 3)."""
    rng = np.random.default_rng(10)
    params = {'h': (0.6, 0.8)}
    files = [small_emulator(tmp_path, {'thermodynamics.rs_drag': chip_smoke.mlp_engine_state(
        rng, params, (4,), 'tanh', (), [np.array(lo), np.array(lo + 1.0)])}, f'{lo}.npy') for lo in (100.0, 200.0)]
    first = EmulatedEngine.read(files[0])
    h = torch.tensor([0.65, 0.7], dtype=torch.float64)
    rs_first = Cosmology(engine=first, h=h).get_thermodynamics().rs_drag
    rs_second = Cosmology(engine=first.read(files[1]), h=h).get_thermodynamics().rs_drag
    assert bool((rs_first < 150.0).all()) and bool((rs_second > 150.0).all())
    assert torch.equal(Cosmology(engine=first, h=h).get_thermodynamics().rs_drag, rs_first)


def test_fourier_jacfwd_first_call(native_base):
    """Forward mode through the Fourier path (the nets under vmap, the
    Fourier norm's per-row splines and its vmapped BBKS spectrum, sigma8
    through the FFTLog transform's jvp rule), as the first call of a fresh
    engine (whose caches are then not filled with the transform's tensors):
    d sigma8_m / d(logA, h) against central differences (step 1e-6, bar
    1e-6 relative; measured 2.8e-10), and again after a plain call."""
    engine = EmulatedEngine.read(native_base[1])
    values = {name: torch.from_numpy(value) for name, value in draw(2, seed=5).items()}

    def sigma8(logA, h):
        return Cosmology(engine=engine, ellmax_cl=ELLMAX, **dict(values, logA=logA, h=h)).get_fourier().sigma8_m

    args = (values['logA'], values['h'])
    jac = [torch.diagonal(j) for j in torch.func.jacfwd(sigma8, argnums=(0, 1))(*args)]
    assert not any(isinstance(t, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(t)
                   for t in engine._emulator.fixed_on(torch.device('cpu')).values())
    for i, d in enumerate(jac):
        up, down = list(args), list(args)
        up[i], down[i] = args[i] + 1e-6, args[i] - 1e-6
        np.testing.assert_allclose(d.numpy(), ((sigma8(*up) - sigma8(*down)) / 2e-6).numpy(), rtol=1e-6)
    again = [torch.diagonal(j) for j in torch.func.jacfwd(sigma8, argnums=(0, 1))(*args)]
    assert all(torch.equal(a, b) for a, b in zip(jac, again))
