"""The port's cobaya and cosmosis bindings (cosmoprimo_tpu_torch/bindings/)
against the JAX package's, with stub cobaya-free theories and a stub
cosmosis module (the stubs of tests/test_bindings.py, written again here),
on the same EH cosmology (the Cls through the stub pyclass of
tests/fake_boltzmann.py), on the CPU.

Every getter of the cobaya theory (Hubble in both units, the distances,
Pk_grid, sigma8_z, fsigma8, the Cls in both unit and ell-factor
conventions, rs_drag, the derived parameters), ``calculate`` with derived
parameters and its error, and the ``must_provide`` collectors (pooled
redshifts, Pk_grid, sigma_R, angular_diameter_distance_2, Cl) give what the
JAX binding gives, within 1e-12 of each output's max, as numpy arrays; the
z-pool lookup is strict. The cosmosis module's setup, execute and cleanup
write the same datablock as the JAX module's, within 1e-12 of each
entry's max; 'mnu' is split over the species as there.
"""

import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import cosmoprimo_tpu as jcp  # noqa: E402
import cosmoprimo_tpu_torch as tcp  # noqa: E402
from cosmoprimo_tpu.bindings.cobaya import cosmoprimo_tpu as jcobaya  # noqa: E402
from cosmoprimo_tpu.bindings.cosmosis import cosmoprimo_tpu_interface as jiface  # noqa: E402
from cosmoprimo_tpu_torch.bindings.cobaya import cosmoprimo_tpu_torch as cobaya  # noqa: E402
from cosmoprimo_tpu_torch.bindings.cosmosis import cosmoprimo_tpu_torch_interface as iface  # noqa: E402

BAR = 1e-12
PARAMS = dict(omega_cdm=0.12, omega_b=0.02237, h=0.6736, A_s=2.083e-9, n_s=0.9649)


def close(got, ref, what=''):
    assert not isinstance(got, torch.Tensor), f'{what}: a tensor, not numpy'
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.array_equal(np.isfinite(got), np.isfinite(ref)), what
    got, ref = got[np.isfinite(ref)], ref[np.isfinite(ref)]
    err = float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)) if ref.size else 0.0
    assert err <= BAR, f'{what}: {err:.3e}'


def close_tree(got, ref, what=''):
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for key in ref:
            close_tree(got[key], ref[key], f'{what} {key}')
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            close_tree(g, r, f'{what}[{i}]')
    else:
        close(got, ref, what)


def cosmologies(**kwargs):
    params = {**PARAMS, **kwargs}
    return tcp.Cosmology(engine='eisenstein_hu', device='cpu', **params), jcp.Cosmology(engine='eisenstein_hu',
                                                                                       **params)


def theories(cosmo, jcosmo):
    out = []
    for module, cls, c in ((cobaya, cobaya.CosmoprimoTPUTorch, cosmo), (jcobaya, jcobaya.CosmoprimoTPU, jcosmo)):
        theory = cls.__new__(cls)
        theory._base_cosmo = c
        theory.current_state = {'cosmo': c}
        theory.output_params = ['omegam', 'rdrag', 'H0']
        theory.log = None
        out.append(theory)
    return out


@pytest.fixture(scope='module')
def pair():
    return cosmologies()


def test_cobaya_getters(pair):
    theory, jtheory = theories(*pair)
    z = np.array([0.5, 1.0, 2.0])
    for getter, args in [('get_Hubble', (z,)), ('get_angular_diameter_distance', (z,)),
                         ('get_comoving_radial_distance', (z,)), ('get_sigma8_z', (np.array([0.0, 1.0]),)),
                         ('get_fsigma8', (np.array([0.5]),)), ('get_rs_drag', ()),
                         ('get_angular_diameter_distance_2', (np.array([[0.2, 1.0], [0.5, 2.0]]),))]:
        close(getattr(theory, getter)(*args), getattr(jtheory, getter)(*args), what=getter)
    close(theory.get_Hubble(z, units='1/Mpc'), jtheory.get_Hubble(z, units='1/Mpc'), what='Hubble 1/Mpc')
    close_tree(theory.get_Pk_grid(), jtheory.get_Pk_grid(), what='Pk_grid')
    close_tree(theory.get_Pk_grid(var_pair=('delta_nonu', 'delta_nonu')),
               jtheory.get_Pk_grid(var_pair=('delta_nonu', 'delta_nonu')), what='Pk_grid cb')
    for name in ('omegam', 'omegab', 'omegac', 'rdrag', 'zdrag', 'H0', 'ns', 'As', 'mnu', 'nnu', 'h'):
        close(theory.get_param(name), jtheory.get_param(name), what=name)
        close(cobaya._get_from_cosmo(pair[0], name), jcobaya._get_from_cosmo(pair[1], name), what=name)
    assert theory.get_can_provide_params() == jtheory.get_can_provide_params()


def test_cobaya_calculate(pair):
    theory, jtheory = theories(*pair)
    states = [{}, {}]
    for t, state in zip((theory, jtheory), states):
        assert t.calculate(state, want_derived=True, omega_cdm=0.121) is True
    close_tree(states[0]['derived'], states[1]['derived'], what='derived')
    assert float(states[0]['cosmo']['omega_cdm']) == pytest.approx(0.121, rel=1e-15)
    # an input both packages refuse surfaces as cobaya's error type
    for t, error in ((theory, cobaya.LoggedError), (jtheory, jcobaya.LoggedError)):
        with pytest.raises(error):
            t.calculate({}, want_derived=False, neutrino_hierarchy='bad', m_ncdm=0.1)


def must_provide_both(pair, *requirements):
    theory, jtheory = theories(*pair)
    states = [{}, {}]
    for t, state in zip((theory, jtheory), states):
        for requirement in requirements:
            t.must_provide(requirement)
        assert t.calculate(state, want_derived=False) is True
        t.current_state = state
    return theory, jtheory, states


def test_cobaya_must_provide_collectors(pair):
    z1, z2 = np.array([0.3, 0.8]), np.array([0.8, 1.4])
    theory, jtheory, (state, jstate) = must_provide_both(
        pair, dict(Hubble={'z': z1}, comoving_radial_distance={'z': z1}),
        dict(Hubble={'z': z2}, sigma8_z={'z': z1}, fsigma8={'z': z1}, angular_diameter_distance={'z': z2},
             Omega_b={'z': z1}, Omega_cdm={'z': z1}, angular_diameter_distance_2={'z_pairs': [[0.2, 1.0]]}))
    np.testing.assert_array_equal(theory.collectors['Hubble'].z_pool.values, [0.3, 0.8, 1.4])
    for key in ('Hubble', 'comoving_radial_distance', 'sigma8_z', 'fsigma8', 'angular_diameter_distance',
                'Omega_b', 'Omega_cdm', 'angular_diameter_distance_2'):
        close(state[key], jstate[key], what=key)
    close(theory.get_sigma8_z(z1), jtheory.get_sigma8_z(z1), what='sigma8_z from the pool')
    close(theory.get_fsigma8(np.array([0.8])), jtheory.get_fsigma8(np.array([0.8])), what='fsigma8 from the pool')
    with pytest.raises(ValueError):
        theory.get_sigma8_z(np.array([0.81]))


def test_cobaya_must_provide_pk_grid_and_sigma_r(pair):
    key = ('Pk_grid', False, 'delta_tot', 'delta_tot')
    weyl = ('Pk_grid', False, 'delta_tot', 'Weyl')
    sigma = ('sigma_R', 'delta_tot', 'delta_tot')
    theory, jtheory, (state, jstate) = must_provide_both(
        pair, {key: {'k_max': 2.0, 'z': np.array([0.0, 1.0]), 'nonlinear': False}},
        {sigma: {'k_max': 2.0, 'z': np.array([0.0, 0.5]), 'R': np.array([8.0, 12.0])}})
    assert set(theory.extra_args) == set(jtheory.extra_args)
    for name, value in jtheory.extra_args.items():
        np.testing.assert_array_equal(theory.extra_args[name], value, err_msg=name)
    close_tree(state[key], jstate[key], what='Pk_grid')
    close_tree(state[sigma], jstate[sigma], what='sigma_R')
    close_tree(theory.get_Pk_grid(var_pair=('delta_tot', 'delta_tot')),
               jtheory.get_Pk_grid(var_pair=('delta_tot', 'delta_tot')), what='get_Pk_grid')
    assert weyl not in state


def test_cobaya_cl(monkeypatch):
    """The Cls and their unit conventions, through the stub pyclass."""
    from fake_boltzmann import install_fake_pyclass
    install_fake_pyclass(monkeypatch)
    cosmo = tcp.Cosmology(engine='class', device='cpu', ellmax_cl=49, **PARAMS)
    jcosmo = jcp.Cosmology(engine='class', ellmax_cl=49, **PARAMS)
    theory, jtheory = theories(cosmo, jcosmo)
    for getter in ('get_Cl', 'get_unlensed_Cl'):
        for kwargs in ({}, {'ell_factor': True, 'units': '1'}):
            close_tree(getattr(theory, getter)(**kwargs), getattr(jtheory, getter)(**kwargs), what=getter)
    theory, jtheory, (state, jstate) = must_provide_both((cosmo, jcosmo), dict(Cl={'tt': 40, 'te': 30}, H0=None),
                                                         dict(unlensed_Cl={'tt': 20}))
    assert theory.extra_args['ellmax_cl'] == jtheory.extra_args['ellmax_cl'] == 40
    assert theory.derived_extra == jtheory.derived_extra == ['H0']
    close_tree(state['Cl'], jstate['Cl'], what='Cl')
    close_tree(state['unlensed_Cl'], jstate['unlensed_Cl'], what='unlensed_Cl')
    close_tree(theory.get_Cl(ell_factor=True), jtheory.get_Cl(ell_factor=True), what='get_Cl collected')
    close_tree(state['derived_extra'], jstate['derived_extra'], what='derived_extra')


# ----------------------------------------------------------------------------
# cosmosis
# ----------------------------------------------------------------------------

class _FakeBlock(dict):
    def __setitem__(self, key, value):
        super().__setitem__(tuple(key) if isinstance(key, tuple) else key, value)

    def has_value(self, section, name):
        return (section, name) in self

    def put_grid(self, section, zname, z, kname, k, pname, p):
        self[section, zname] = z
        self[section, kname] = k
        self[section, pname] = p


@pytest.fixture
def fake_cosmosis(monkeypatch):
    cosmosis = types.ModuleType('cosmosis')
    datablock = types.ModuleType('cosmosis.datablock')
    names = types.SimpleNamespace(cosmological_parameters='cosmological_parameters', distances='distances',
                                  growth_parameters='growth', matter_power_lin='matter_power_lin', cmb_cl='cmb_cl')
    datablock.names = names
    datablock.option_section = 'module_options'
    cosmosis.datablock = datablock
    monkeypatch.setitem(sys.modules, 'cosmosis', cosmosis)
    monkeypatch.setitem(sys.modules, 'cosmosis.datablock', datablock)
    return names


class Options(object):
    """Fake ini options: the fourier products on, the port on the CPU."""

    def __init__(self, **values):
        self.values = values

    def get_string(self, section, name, default=''):
        return self.values.get(name, default)

    def get_double(self, section, name, default=0.0):
        return self.values.get(name, default)

    def get_int(self, section, name, default=0):
        return self.values.get(name, default)

    def get_bool(self, section, name, default=False):
        return self.values.get(name, default)


@pytest.mark.parametrize('options', [dict(fourier=True, nz=20), dict(fourier=False, zmax=2.0)])
def test_cosmosis_execute(fake_cosmosis, options):
    cp = fake_cosmosis.cosmological_parameters
    blocks = []
    for module, extra in ((iface, {'device': 'cpu'}), (jiface, {})):
        config = module.setup(Options(**options, **extra))
        block = _FakeBlock()
        for name, value in dict(h0=0.6736, omega_b=0.0493, omega_c=0.2645, n_s=0.9649, a_s=2.083e-9).items():
            block[cp, name] = value
        assert module.execute(block, config) == 0
        assert module.cleanup(config) == 0
        blocks.append(block)
    block, jblock = blocks
    assert set(block) == set(jblock)
    for key in jblock:
        close(block[key], jblock[key], what=str(key))


def test_cosmosis_inputs(fake_cosmosis):
    cp = fake_cosmosis.cosmological_parameters
    config = {'harmonic': True, 'fourier': True, 'lensing': True, 'nonlinear': 'mead', 'lmax': 100, 'zmin': 0.0,
              'zmax': 1.0, 'nz': 5, 'kmax': 5.0, 'cosmoprimo_N_ur': 2.0}
    block = _FakeBlock()
    for name, value in dict(h0=0.68, mnu=0.06, num_massive_neutrinos=2, w=-0.9, wa=0.1, tau=0.06, nrun=0.01).items():
        block[cp, name] = value
    block['reionization', 'delta_redshift'] = 0.7
    params, jparams = iface.get_inputs(block, config), jiface.get_inputs(block, config)
    assert set(params) == set(jparams)
    for key in jparams:
        np.testing.assert_array_equal(np.asarray(params[key]), np.asarray(jparams[key]), err_msg=key)
    np.testing.assert_allclose(params['m_ncdm'], [0.03, 0.03])
