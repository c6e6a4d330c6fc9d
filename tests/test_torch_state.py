"""The port's state and file surface of ``Cosmology``
(cosmoprimo_tpu_torch/cosmology.py, utils.write_state / read_state) against
the JAX package's: files written by either package are read by the other,
in '.npy' and '.json'; the deprecated aliases warn; equality, hashing and
shallow copies; and the custom-engine pattern of tests/test_custom_engine.py
with torch.func.grad for jax.grad.

Bars: parameters read back exactly (the same float64 values through the
files); the background of a cosmology read from the other package's file
rtol 1e-12 against that package (measured 0.0); the custom engine's rs_drag
and its derivative rtol 1e-13 against the JAX package's formula and
jax.grad (measured 0.0).
"""

import copy
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu import utils as jutils  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, CosmologyError, utils  # noqa: E402
from cosmoprimo_tpu_torch.cosmology import (BaseEngine, BaseSection, DefaultBackground,  # noqa: E402
                                            register_engine, register_section)

RTOL = 1e-12
INPUTS = dict(omega_cdm=0.12, omega_b=0.022, h=0.68, n_s=0.96, logA=3.0, m_ncdm=[0.06], w0_fld=-0.9)
Z = np.array([0.0, 0.5, 1.0, 3.0])


def assert_same_params(port_params, jax_params):
    assert set(port_params) == set(jax_params)
    for name, value in jax_params.items():
        got = port_params[name]
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(value), err_msg=name)
        else:
            assert np.all(got == value), name


@pytest.mark.parametrize('ext', ['npy', 'json'])
def test_jax_file_read_by_port(tmp_path, ext):
    ref = jcp.Cosmology(engine='eisenstein_hu', **INPUTS)
    ref['Omega_ncdm']   # a derived parameter, cached in the state
    fn = tmp_path / f'cosmo.{ext}'
    ref.write(str(fn))
    port = Cosmology.read(fn, device='cpu')
    assert port.engine.name == 'eisenstein_hu' and port.device == torch.device('cpu')
    assert_same_params(port._params, ref._params)
    assert set(port._derived) == {'Omega_ncdm'}
    np.testing.assert_array_equal(port['Omega_ncdm'].numpy(), np.asarray(ref['Omega_ncdm']))
    np.testing.assert_allclose(port.efunc(Z).numpy(), np.asarray(ref.efunc(Z)), rtol=RTOL)
    # the input basis survives: a clone from the file's inputs
    np.testing.assert_allclose(port.clone(h=0.7)['Omega_m'].numpy(), np.asarray(ref.clone(h=0.7)['Omega_m']), rtol=RTOL)


@pytest.mark.parametrize('ext', ['npy', 'json'])
def test_port_file_read_by_jax(tmp_path, ext):
    port = Cosmology(engine='eisenstein_hu', device='cpu', **INPUTS)
    fn = tmp_path / f'cosmo.{ext}'
    port.write(fn)
    ref = jcp.Cosmology.read(str(fn))
    assert ref.engine.name == 'eisenstein_hu'
    assert_same_params(port._params, ref._params)
    np.testing.assert_allclose(np.asarray(ref.efunc(Z)), port.efunc(Z).numpy(), rtol=RTOL)
    np.testing.assert_allclose(np.asarray(ref.comoving_radial_distance(Z)), port.comoving_radial_distance(Z).numpy(),
                               rtol=RTOL)


@pytest.mark.parametrize('ext', ['npy', 'json'])
def test_batch_round_trip(tmp_path, ext):
    """A batch (tensor inputs, a species per row) back through the port's
    own files, into a folder that does not exist yet: equal, and the same
    background."""
    rng = np.random.default_rng(0)
    batch = dict(INPUTS, h=torch.from_numpy(rng.uniform(0.65, 0.7, 3)), m_ncdm=[torch.from_numpy(rng.uniform(0.06, 0.1, 3))])
    port = Cosmology(engine='eisenstein_hu_nowiggle_variants', **batch)
    fn = tmp_path / 'sub' / f'cosmo.{ext}'
    port.write(fn)
    back = Cosmology.read(fn, device='cpu')
    assert back == port and back.batch_shape == (3,)
    np.testing.assert_array_equal(back.comoving_radial_distance(Z).numpy(), port.comoving_radial_distance(Z).numpy())
    assert back.clone(h=0.7) != port
    state = utils.read_state(fn)
    assert isinstance(state['params']['h'], np.ndarray) and state['engine']['name'] == 'eisenstein_hu_nowiggle_variants'


def test_state_helpers_against_jax(tmp_path):
    """write_state / read_state of either package read the other's files."""
    state = {'a': np.arange(3.0), 'b': {'c': 1.5, 'd': [1, 2], 'e': np.float32(2.5)}, 'f': 'text', 'g': None,
             't': torch.arange(2.0, dtype=torch.float64)}
    for ext in ('json', 'npy'):
        port_fn, jax_fn = str(tmp_path / f'port.{ext}'), str(tmp_path / f'jax.{ext}')
        utils.write_state(port_fn, {**state, 't': np.arange(2.0)} if ext == 'npy' else state)
        jutils.write_state(jax_fn, {**state, 't': np.arange(2.0)})
        for loaded in (jutils.read_state(port_fn), utils.read_state(jax_fn), utils.read_state(port_fn)):
            np.testing.assert_array_equal(loaded['a'], state['a'])
            np.testing.assert_array_equal(loaded['t'], np.arange(2.0))
            assert loaded['b']['c'] == 1.5 and list(loaded['b']['d']) == [1, 2] and loaded['f'] == 'text'
            assert loaded['g'] is None


def test_deprecated_aliases(tmp_path):
    cosmo = Cosmology(engine='eisenstein_hu', device='cpu')
    fn = str(tmp_path / 'cosmo.npy')
    with pytest.warns(DeprecationWarning):
        cosmo.save(fn)
    with pytest.warns(DeprecationWarning):
        cosmo2 = Cosmology.load(fn, device='cpu')
    assert cosmo2 == cosmo
    with pytest.warns(DeprecationWarning):
        params = Cosmology.get_default_parameters()
    assert params == Cosmology.get_default_params() == jcp.Cosmology.get_default_params()


def test_equality_copy_and_pickle(monkeypatch):
    cosmo = Cosmology(engine='eisenstein_hu', device='cpu', **INPUTS)
    clone = cosmo.copy()
    assert clone == cosmo and clone is not cosmo and clone.engine is cosmo.engine
    assert hash(clone) != hash(cosmo) and len({cosmo, clone}) == 2
    assert cosmo.clone() == cosmo and cosmo.engine == cosmo.clone().engine
    assert cosmo.clone(h=0.7) != cosmo and cosmo.clone(engine='bbks') != cosmo
    assert Cosmology(device='cpu', **INPUTS) != cosmo   # no engine
    assert cosmo.engine != cosmo.clone(engine='bbks').engine
    # copies keep the device; a pickle holds the numpy state, which names
    # none: it unpickles on the card, and without one raises
    assert copy.copy(cosmo).engine is cosmo.engine
    deep = copy.deepcopy(cosmo)
    assert deep == cosmo and deep.device == cosmo.device and deep.engine is not cosmo.engine
    data = pickle.dumps(cosmo)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(CosmologyError, match="device='cpu'"):
        pickle.loads(data)


# the custom-engine pattern of tests/test_custom_engine.py: the sections are
# discovered by name in this module, which defines no other
@register_section
class Background(DefaultBackground):
    pass


@register_section
class Thermodynamics(BaseSection):
    def __init__(self, engine):
        super().__init__(engine)
        # toy: rs_drag as a pure function of omega_m
        self._rs_drag = 147.0 * (0.1432 / engine['omega_m']) ** 0.25 * engine['h']

    @property
    def rs_drag(self):
        return self._rs_drag


@register_engine
class ToyEngine(BaseEngine):
    name = 'toy'


def test_custom_engine():
    cosmo = Cosmology(omega_cdm=0.12, omega_b=0.02237, h=0.6736, engine='toy', device='cpu')
    assert cosmo.engine.name == 'toy'
    chi = float(cosmo.get_background().comoving_radial_distance(1.0))
    ref = jcp.Cosmology(omega_cdm=0.12, omega_b=0.02237, h=0.6736, engine='eisenstein_hu')
    np.testing.assert_allclose(chi, float(ref.comoving_radial_distance(1.0)), rtol=RTOL)
    assert 2000 < chi < 2600
    rs = float(cosmo.get_thermodynamics().rs_drag)
    np.testing.assert_allclose(rs, 147.0 * (0.1432 / float(ref['omega_m'])) ** 0.25 * 0.6736, rtol=1e-13)

    def rs_drag(oc):
        return Cosmology(omega_cdm=oc, omega_b=0.02237, h=0.6736, engine='toy').get_thermodynamics().rs_drag

    g = torch.func.grad(rs_drag)(torch.tensor(0.12, dtype=torch.float64))
    jg = jax.grad(lambda oc: 147.0 * (0.1432 / jcp.Cosmology(omega_cdm=oc, omega_b=0.02237, h=0.6736)['omega_m']) ** 0.25
                  * 0.6736)(0.12)
    assert float(g) < 0
    np.testing.assert_allclose(float(g), float(jg), rtol=1e-13)
    assert float(cosmo.rs_drag) == rs   # attribute forwarding finds the one owner
