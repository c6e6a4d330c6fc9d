"""The port's CLASS and CAMB wrapper engines (cosmoprimo_tpu_torch/models/
classy.py, camb.py) against the JAX package's, section by section, both
wrapping the same stub host modules (tests/fake_boltzmann.py's
install_fake_pyclass / install_fake_camb, whose tables come from the JAX
package's EH engine), on the CPU.

Every section of 'class' and 'camb' and of their variants (axiclass,
mochiclass, negnuclass, dsclass's DS growth, isitgr, mgcamb, isitide's
background, heftcamb) is held to the JAX engine at 1e-12 of each output's
max: the background functions at redshifts inside and beyond the host
tables, the thermodynamics scalars and extras, the primordial spectrum,
the structured host tables (equal), the Cls, the Fourier tables for every
``of`` (CAMB's Weyl unscaling and theta_cb reconstruction), their
interpolators, sigma8 and sigma(R) (the FFTLog transforms), the sigma8
rescaling (CLASS, CAMB) and the z_reio/tau fallback. Only where an
interpolator's table ends at its extrapolation bound do the port's pad
knots depart from the JAX package's by design (ROADMAP queue 3, "table
interpolators' pad knots", tests/test_torch_interpolator_pad.py): no table
here reaches that bound, so 1e-12 holds everywhere (measured: see each
assertion).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import fake_boltzmann  # noqa: E402
from fake_boltzmann import install_fake_camb, install_fake_pyclass  # noqa: E402

import functools  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cosmoprimo_tpu as jcp  # noqa: E402
import cosmoprimo_tpu_torch as tcp  # noqa: E402
from cosmoprimo_tpu_torch.cosmology import CosmologyInputError  # noqa: E402

BAR = 1e-12
PARAMS = dict(omega_cdm=0.12, omega_b=0.02237, h=0.6736, A_s=2.083e-9, n_s=0.9649)
Z = np.array([0.0, 0.5, 1.0, 2.0, 10.0, 150.0, 1100.0])
Z_BEYOND = np.array([2e4, 1e5])   # beyond the host tables: the closed form
K = np.geomspace(1e-3, 5.0, 9)
R = np.array([4.0, 8.0, 16.0])


def as_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def close(got, ref, bar=BAR, what=''):
    got, ref = as_numpy(got).astype(np.float64), as_numpy(ref).astype(np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.array_equal(np.isnan(got), np.isnan(ref)), what
    got, ref = np.nan_to_num(got), np.nan_to_num(ref)
    err = float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)) if ref.size else 0.0
    assert err <= bar, f'{what}: {err:.3e}'
    return err


def same_table(got, ref):
    assert got.dtype.names == ref.dtype.names
    for name in ref.dtype.names:
        np.testing.assert_array_equal(got[name], ref[name])


# The stubs compute their tables from the JAX package's EH engine, and the
# JAX package's sections evaluate eagerly: on the CPU every new operation is
# compiled once, which made this file take ~4 min. So the stub pyclass's
# background and P(k) tables come from jitted functions of the truth
# parameters (one compile each, both packages' engines wrapping the same
# stubs), and the JAX references of the CLASS sections are evaluated under
# jax.jit on a throwaway JAX cosmology built from the same stubs (its
# sections made inside the trace; the CAMB background stays eager: it calls
# the host at the requested redshifts).

BACKGROUND_STUBS = ('efunc', 'comoving_radial_distance', 'time', 'growth_factor', 'growth_rate')


@functools.lru_cache(maxsize=None)
def _jitted_truth(kwargs, method):
    """The truth cosmology of ``kwargs``: its P(k) table ('pk'), or every
    stubbed background function at once ('background': the background
    depends on h, omega_cdm and omega_b only), jitted."""
    cosmo = functools.partial(fake_boltzmann._truth_cosmology, **dict(kwargs))
    if method == 'pk':
        return jax.jit(lambda k, z: cosmo().get_fourier().pk_interpolator()(k, z))

    def background(z):
        ba = cosmo().get_background()
        return {name: getattr(ba, name)(z) for name in BACKGROUND_STUBS}

    return jax.jit(background)


@functools.lru_cache(maxsize=None)
def _truth_background(kwargs, z):
    with jax.ensure_compile_time_eval():   # concrete also while a JAX reference is traced
        out = _jitted_truth(kwargs, 'background')(jnp.asarray(np.frombuffer(z)))
        return {name: np.asarray(value) for name, value in out.items()}


def _truth(cosmo, method, *args):
    kwargs = dict(cosmo._truth_kwargs)
    if method != 'pk':
        kwargs = tuple(sorted((name, kwargs[name]) for name in ('h', 'omega_cdm', 'omega_b')))
        return _truth_background(kwargs, np.asarray(args[0], dtype=np.float64).tobytes())[method]
    with jax.ensure_compile_time_eval():
        return np.asarray(_jitted_truth(tuple(sorted(kwargs.items())), method)(*[jnp.asarray(a) for a in args]))


def _patched_truth(orig):
    def truth(**kwargs):
        cosmo = orig(**kwargs)
        cosmo._truth_kwargs = tuple((name, None if value is None else float(np.asarray(value)))
                                    for name, value in kwargs.items())
        return cosmo
    return truth


def _background_method(method):
    def fn(self, z):
        return _truth(self.eng.cosmo, method, np.asarray(z, dtype=np.float64))
    return fn


def _pk_table_h(cosmo, non_linear=False):
    k = np.geomspace(1e-4, 10.0, 200)
    z = np.array([0.0, 0.5, 1.0, 2.0])
    pk = _truth(cosmo, 'pk', k, z)
    if non_linear:
        pk = pk * (1.0 + 0.1 * (k[:, None] / (1.0 + k[:, None])))
    return k, z, pk


def _concrete(fn):
    """``fn`` evaluated on concrete values even while a JAX reference is
    traced: the host code's values are constants of the trace."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.ensure_compile_time_eval():
            return fn(*args, **kwargs)
    return wrapper


@pytest.fixture(autouse=True)
def quick_stubs(monkeypatch):
    for cls in vars(fake_boltzmann).values():
        if isinstance(cls, type) and cls.__name__.startswith('_Fake'):
            for name, attr in list(vars(cls).items()):
                if callable(attr) and (name == '__init__' or not name.startswith('__')):
                    monkeypatch.setattr(cls, name, _concrete(attr))
    monkeypatch.setattr(fake_boltzmann, '_truth_cosmology', _patched_truth(fake_boltzmann._truth_cosmology))
    monkeypatch.setattr(fake_boltzmann, '_pk_table_h', _pk_table_h)
    for method in BACKGROUND_STUBS:
        monkeypatch.setattr(fake_boltzmann._FakeClassBackground, method, _concrete(_background_method(method)))


def pair(name, monkeypatch, **kwargs):
    install_fake_pyclass(monkeypatch)
    install_fake_camb(monkeypatch)
    params = {name: value for name, value in {**PARAMS, **kwargs}.items() if value is not None}
    jcosmo = jcp.Cosmology(engine=name, **params)
    jcosmo._test_args = (name, params)
    return tcp.Cosmology(engine=name, device='cpu', **params), jcosmo


def jitted(jcosmo, fn):
    """``fn(cosmology)`` under jax.jit, on a throwaway JAX cosmology like
    ``jcosmo`` whose sections are made inside the trace."""
    name, params = jcosmo._test_args
    throwaway = jcp.Cosmology(engine=name, **params)
    return jax.jit(lambda: fn(throwaway))()


BACKGROUND = ('efunc', 'hubble_function', 'comoving_radial_distance', 'time', 'growth_factor', 'growth_rate',
              'comoving_transverse_distance', 'angular_diameter_distance', 'luminosity_distance', 'Omega_m',
              'Omega_cdm', 'Omega_b', 'Omega_g', 'Omega_de', 'Omega_k', 'rho_cdm', 'rho_b', 'rho_de', 'rho_tot')


def growth_outputs(ba, z):
    return {'growth_factor': ba.growth_factor(z), 'growth_rate': ba.growth_rate(z),
            'growth_factor znorm': ba.growth_factor(z, znorm=0.0), 'growth_factor cb': ba.growth_factor(z, mass='cb'),
            'growth_rate cb': ba.growth_rate(z, mass='cb')}


def background_outputs(ba, names, z, extra=(), growth=True):
    out = {name: getattr(ba, name)(z) for name in names + extra}
    if growth:
        out.update(growth_outputs(ba, z))
    out['age'] = ba.age
    if 'comoving_sound_horizon' in extra:
        out['efunc beyond the tables'] = ba.efunc(Z_BEYOND)
    return out


def check_background(cosmo, jcosmo, names=BACKGROUND, z=Z, extra=(), jit=True):
    """``jit=False`` (CAMB): the host-evaluated functions eagerly, the growth
    (the closed-form ODE, traced in the JAX package too) under jax.jit."""
    got = background_outputs(cosmo.get_background(), names, z, extra=extra)
    if jit:
        ref = jitted(jcosmo, lambda c: background_outputs(c.get_background(), names, z, extra=extra))
    else:
        names = tuple(name for name in names if not name.startswith('growth'))
        ref = background_outputs(jcosmo.get_background(), names, z, extra=extra, growth=False)
        ref.update(jitted(jcosmo, lambda c: growth_outputs(c.get_background(), z)))
    assert set(got) == set(ref)
    for name in ref:
        close(got[name], ref[name], what=name)


@pytest.mark.parametrize('name', ['class', 'axiclass', 'mochiclass', 'negnuclass', 'dsclass'])
def test_class_background(name, monkeypatch):
    cosmo, jcosmo = pair(name, monkeypatch)
    check_background(cosmo, jcosmo, extra=('comoving_sound_horizon',))


def thermodynamics_outputs(th, names):
    out = {name: getattr(th, name) for name in names}
    out['rs_z'] = th.rs_z(np.array([10.0, 100.0, 1000.0]))
    return out


def check_thermodynamics(cosmo, jcosmo, names, jit=True):
    got = thermodynamics_outputs(cosmo.get_thermodynamics(), names)
    if jit:
        ref = jitted(jcosmo, lambda c: thermodynamics_outputs(c.get_thermodynamics(), names))
    else:
        ref = thermodynamics_outputs(jcosmo.get_thermodynamics(), names)
    for name in names:
        close(got[name], ref[name], what=name)


def test_class_thermodynamics(monkeypatch):
    cosmo, jcosmo = pair('class', monkeypatch)
    check_thermodynamics(cosmo, jcosmo, ('rs_drag', 'z_drag', 'rs_star', 'z_star', 'tau_reio', 'z_reio', 'YHe',
                                         'theta_cosmomc', 'z_star_noreion', 'rs_star_noreion', 'theta_star',
                                         'theta_star_noreion'))


@pytest.mark.parametrize('name', ['class', 'camb'])
def test_primordial(name, monkeypatch):
    cosmo, jcosmo = pair(name, monkeypatch)
    pm, jpm = cosmo.get_primordial(), jcosmo.get_primordial()
    for attr in ('A_s', 'ln_1e10_A_s', 'n_s', 'k_pivot', 'alpha_s', 'beta_s'):
        close(getattr(pm, attr), getattr(jpm, attr), what=attr)
    close(pm.pk_k(K), jpm.pk_k(K), what='pk_k')
    close(pm.pk_interpolator()(K), jpm.pk_interpolator()(K), what='pk_interpolator')


def test_class_tables(monkeypatch):
    cosmo, jcosmo = pair('class', monkeypatch)
    same_table(cosmo.get_perturbations().table(), jcosmo.get_perturbations().table())
    same_table(cosmo.get_transfer().table(0.0), jcosmo.get_transfer().table(0.0))


def check_cls(hr, jhr, kinds, ellmax):
    for kind in kinds:
        got, ref = getattr(hr, kind)(ellmax=ellmax), getattr(jhr, kind)(ellmax=ellmax)
        assert set(got) == set(ref)
        np.testing.assert_array_equal(got['ell'], ref['ell'])
        assert all(isinstance(got[key], torch.Tensor) for key in got if key != 'ell')
        for key in ref:
            close(got[key], ref[key], what=f'{kind} {key}')


def test_class_harmonic(monkeypatch):
    cosmo, jcosmo = pair('class', monkeypatch, sigma8=0.78, A_s=None)
    hr, jhr = cosmo.get_harmonic(), jcosmo.get_harmonic()
    check_cls(hr, jhr, ('unlensed_cl', 'lensed_cl', 'lens_potential_cl'), 64)
    check_cls(hr, jhr, ('lensed_cl',), -1)
    for of in (None, ['tt', 'te']):
        for kind in ('unlensed_table', 'lensed_table'):
            got, ref = getattr(hr, kind)(ellmax=16, of=of), getattr(jhr, kind)(ellmax=16, of=of)
            for key in ref.dtype.names:
                close(got[key], ref[key], what=f'{kind} {key}')


OF_CLASS = ('delta_m', 'delta_cb', ('delta_m', 'delta_cb'), ('delta_cb', 'delta_cb'))


def fourier_outputs(fo, ofs, non_linear):
    """The interpolators of the Fourier section's tables, sigma(R), sigma8
    and xi (the FFTLog transforms)."""
    zq = np.array([0.0, 0.3, 1.0])
    out = {f'pk_interpolator {of} {nl}': fo.pk_interpolator(non_linear=nl, of=of)(K, zq)
           for nl in non_linear for of in ofs}
    out['pk_kz'] = fo.pk_kz(K, 0.0)
    out['sigma_rz'] = fo.sigma_rz(R, np.array([0.0, 1.0]))
    out['sigma8_z'] = fo.sigma8_z(np.array([0.0, 0.5]))
    out['sigma8_m'] = fo.sigma8_m
    out['to_xi'] = fo.pk_interpolator().to_xi()(np.array([20.0, 100.0]), np.array([0.0, 1.0]))
    return out


def check_fourier(cosmo, jcosmo, ofs, non_linear=(False,)):
    fo, jfo = cosmo.get_fourier(), jcosmo.get_fourier()
    for nl in non_linear:
        for of in ofs:
            k, z, pk = fo.table(non_linear=nl, of=of)
            jk, jz, jpk = jfo.table(non_linear=nl, of=of)
            close(k, jk, what='k')
            close(z, jz, what='z')
            close(pk, jpk, what=f'table {of} {nl}')
    got = fourier_outputs(fo, ofs, non_linear)
    ref = jitted(jcosmo, lambda c: fourier_outputs(c.get_fourier(), ofs, non_linear))
    for name in ref:
        close(got[name], ref[name], what=name)
    return fo, jfo


def test_class_fourier(monkeypatch):
    cosmo, jcosmo = pair('class', monkeypatch)
    fo, jfo = check_fourier(cosmo, jcosmo, OF_CLASS, non_linear=(False, True))
    close(fo.sigma8_cb, jfo.sigma8_cb, what='sigma8_cb')


@pytest.mark.parametrize('name', ['class', 'camb'])
def test_sigma8_rescaling(name, monkeypatch):
    cosmo, jcosmo = pair(name, monkeypatch, A_s=None, sigma8=0.75)
    close(cosmo.get_fourier().sigma8_m, jcosmo.get_fourier().sigma8_m, what='sigma8_m')
    assert abs(float(cosmo.get_fourier().sigma8_m) - 0.75) < 1e-6
    close(cosmo.get_primordial().A_s, jcosmo.get_primordial().A_s, what='A_s')
    k, z, pk = cosmo.get_fourier().table()
    close(pk, jcosmo.get_fourier().table()[2], what='table')


def test_class_variants(monkeypatch):
    cosmo, jcosmo = pair('axiclass', monkeypatch, extra_params={'scf_parameters__1': 2.7,
                                                                 'scf_parameters__2': 0.0})
    assert cosmo._engine.classy.params['scf_parameters'] == [2.7, 0.0]
    with pytest.raises(CosmologyInputError):
        tcp.Cosmology(engine='axiclass', device='cpu', extra_params={'scf_parameters__1': 2.7}, **PARAMS)
    cosmo, jcosmo = pair('negnuclass', monkeypatch)
    assert tcp.Cosmology(engine='negnuclassy', device='cpu', **PARAMS).engine.name == 'negnuclass'


def translated(cosmo):
    return {key: (as_numpy(value) if not isinstance(value, (str, list)) else value)
            for key, value in cosmo._engine.classy.params.items()}


@pytest.mark.parametrize('name,kwargs', [(name, kwargs) for name in ('class', 'dsclass') for kwargs in
                                         ({}, {'z_reio': 7.5}, {'w0_fld': -0.9, 'wa_fld': 0.1},
                                          {'m_ncdm': 0.06, 'non_linear': 'mead'})] + [('dsclass', {'xi_ds': 0.5})])
def test_class_translated_params(name, kwargs, monkeypatch):
    cosmo, jcosmo = pair(name, monkeypatch, **kwargs)
    got, ref = translated(cosmo), translated(jcosmo)
    assert set(got) == set(ref)
    for key in ref:
        if isinstance(ref[key], (str, list)):
            assert got[key] == ref[key], key
        else:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize('xi_ds', [0.0, 0.5])
def test_dsclass_growth(xi_ds, monkeypatch):
    cosmo, jcosmo = pair('dsclass', monkeypatch, xi_ds=xi_ds)
    z = np.array([0.0, 0.5, 1.0, 3.0])

    def outputs(ba):
        return ba.growth_factor(z), ba.growth_factor(z, znorm=0.0), ba.growth_rate(z)

    ref = jitted(jcosmo, lambda c: outputs(c.get_background()))
    for what, got, ref in zip(('growth_factor', 'growth_factor znorm', 'growth_rate'), outputs(cosmo.get_background()),
                              ref):
        close(got, ref, what=what)


def test_class_z_reio(monkeypatch):
    cosmo, jcosmo = pair('class', monkeypatch, z_reio=7.5)
    close(cosmo.get_thermodynamics().tau_reio, jcosmo.get_thermodynamics().tau_reio, what='tau_reio')


# ----------------------------------------------------------------------------
# CAMB
# ----------------------------------------------------------------------------

CAMB_BACKGROUND = BACKGROUND + ('Omega_ur', 'Omega_ncdm_tot', 'rho_g', 'rho_ur', 'rho_k', 'rho_ncdm_tot')


@pytest.mark.parametrize('name', ['camb', 'isitgr', 'mgcamb', 'heftcamb'])
def test_camb_background(name, monkeypatch):
    cosmo, jcosmo = pair(name, monkeypatch)
    check_background(cosmo, jcosmo, names=CAMB_BACKGROUND, z=Z[:-1], jit=False)


def test_camb_thermodynamics(monkeypatch):
    cosmo, jcosmo = pair('camb', monkeypatch)
    check_thermodynamics(cosmo, jcosmo, ('rs_drag', 'z_drag', 'tau_reio', 'z_reio', 'YHe', 'z_star_noreion',
                                         'rs_star_noreion', 'z_star', 'rs_star', 'theta_cosmomc', 'theta_star',
                                         'theta_star_noreion'), jit=False)


def test_camb_transfer(monkeypatch):
    cosmo, jcosmo = pair('camb', monkeypatch)
    same_table(cosmo.get_transfer().table(), jcosmo.get_transfer().table())


def test_camb_harmonic(monkeypatch):
    cosmo, jcosmo = pair('camb', monkeypatch, lensing=True, sigma8=0.78, A_s=None)
    check_cls(cosmo.get_harmonic(), jcosmo.get_harmonic(), ('unlensed_cl', 'lensed_cl', 'lens_potential_cl'), 64)
    check_cls(cosmo.get_harmonic(), jcosmo.get_harmonic(), ('unlensed_cl',), -1)
    cosmo, jcosmo = pair('camb', monkeypatch, lensing=False)
    with pytest.raises(CosmologyInputError):
        cosmo.get_harmonic().lensed_cl(ellmax=16)


OF_CAMB = ('delta_m', 'delta_cb', 'theta_cb', 'phi_plus_psi', ('delta_m', 'phi_plus_psi'), ('delta_cb', 'theta_cb'),
           ('theta_cdm', 'theta_b'))


def test_camb_fourier(monkeypatch):
    cosmo, jcosmo = pair('camb', monkeypatch, z_pk=[0.0, 0.5, 1.0, 2.0])
    check_fourier(cosmo, jcosmo, OF_CAMB)
    with pytest.raises(CosmologyInputError):
        cosmo.get_fourier().table(non_linear=True)


def test_camb_fourier_single_z(monkeypatch):
    cosmo, jcosmo = pair('camb', monkeypatch, z_pk=[0.0], non_linear='halofit')
    fo, jfo = cosmo.get_fourier(), jcosmo.get_fourier()
    close(fo.pk_kz(K, 0.0), jitted(jcosmo, lambda c: c.get_fourier().pk_kz(K, 0.0)), what='pk_kz')
    close(fo.table(non_linear=True)[2], jfo.table(non_linear=True)[2], what='non-linear table')
    with pytest.raises(CosmologyInputError):
        fo.pk_kz(K, 1.0)


def test_camb_variants_params(monkeypatch):
    for name, kwargs in [('isitgr', dict(mu0=0.1, Sigma0=-0.05)), ('mgcamb', dict(B1=1.5)),
                         ('heftcamb', dict(extra_params={'RPH_braiding0': 0.2})), ('isitide', {})]:
        cosmo, jcosmo = pair(name, monkeypatch, **kwargs)
        got, ref = cosmo._engine._camb_params.extra, jcosmo._engine._camb_params.extra
        assert set(got) == set(ref), name
        for key in ref:
            if isinstance(ref[key], (str, type, type(None), bool)):
                assert got[key] == ref[key], key
            else:
                np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=key)
        for attr in ('H0', 'ombh2', 'omch2', 'omnuh2', 'num_nu_massless', 'num_nu_massive', 'YHe'):
            assert getattr(cosmo._engine._camb_params, attr) == pytest.approx(
                float(np.asarray(getattr(jcosmo._engine._camb_params, attr))), rel=1e-15, abs=0), attr
        np.testing.assert_array_equal(cosmo._engine._camb_params.nu_mass_degeneracies,
                                      np.asarray(jcosmo._engine._camb_params.nu_mass_degeneracies))


def test_isitide_background(monkeypatch):
    cosmo, jcosmo = pair('isitide', monkeypatch)
    ba, jba = cosmo.get_background(), jcosmo.get_background()
    z = np.array([0.0, 0.5, 1.0, 3.0])
    close(ba.growth_rate(z), jba.growth_rate(z), what='growth_rate')
    close(ba.growth_factor(z), jba.growth_factor(z), what='growth_factor')
    close(ba.growth_factor(z, znorm=0.0), jba.growth_factor(z, znorm=0.0), what='growth_factor znorm')
    close(ba.growth_rate(z, mass='cb'), jitted(jcosmo, lambda c: c.get_background().growth_rate(z, mass='cb')),
          what='growth_rate cb')


def test_camb_z_reio_tau_fallback(monkeypatch):
    cosmo, jcosmo = pair('camb', monkeypatch, z_reio=7.5)
    th, jth = cosmo.get_thermodynamics(), jcosmo.get_thermodynamics()
    close(th.tau_reio, jth.tau_reio, what='tau_reio')
    assert th.tau_reio > 0


def test_sections_of_each_engine(monkeypatch):
    """CLASS gives the seven sections, CAMB six (no Perturbations)."""
    cosmo, _ = pair('class', monkeypatch)
    camb, _ = pair('camb', monkeypatch)
    for name in ('background', 'thermodynamics', 'primordial', 'perturbations', 'transfer', 'harmonic', 'fourier'):
        assert cosmo._engine.get_section(name) is not None
        if name != 'perturbations':
            assert camb._engine.get_section(name) is not None
    with pytest.raises(CosmologyInputError):
        camb._engine.get_section('perturbations')
    assert type(pair('dsclass', monkeypatch)[0].get_background()).__name__ == 'DSBackground'
    assert type(pair('isitide', monkeypatch)[0].get_background()).__name__ == 'ISiTIDEBackground'


@pytest.mark.parametrize('name', ['class', 'camb'])
def test_one_cosmology_a_call(name, monkeypatch):
    install_fake_pyclass(monkeypatch)
    install_fake_camb(monkeypatch)
    with pytest.raises(CosmologyInputError, match='one cosmology a call'):
        tcp.Cosmology(engine=name, device='cpu', **{**PARAMS, 'h': np.array([0.67, 0.7])})


def test_host_errors_map(monkeypatch):
    install_fake_pyclass(monkeypatch)
    install_fake_camb(monkeypatch)
    # the host's own constructor error passes through, as in the JAX package
    from fake_boltzmann import ClassBadInput
    for make in (lambda **kw: tcp.Cosmology(device='cpu', **kw), jcp.Cosmology):
        with pytest.raises(ClassBadInput):
            make(engine='class', extra_params={'unknown_param_to_fail_on': 1}, **PARAMS)
    with pytest.raises(CosmologyInputError):
        tcp.Cosmology(engine='camb', device='cpu', extra_params={'fail_with_range_error': 1}, **PARAMS)
    cosmo = tcp.Cosmology(engine='class', device='cpu', extra_params={'fail_compute': True}, **PARAMS)
    with pytest.raises(tcp.CosmologyComputationError):
        cosmo._engine.classy.compute(['background'])
