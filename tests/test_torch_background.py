"""The rest of the port's background (cosmoprimo_tpu_torch/cosmology.py:
time, age, the curved distances, the sound horizon, the growth ODE of
DefaultBackground, T_cmb) and Cosmology.clone / get_params /
get_default_params, against the JAX package's on a batch of cosmologies
with massive neutrinos, curvature and evolving dark energy, made from a
seed with numpy.

Bars: rtol 1e-11 on time, age, the distances, rs and the growth factor
and rate (the same tables, cumulative rk4 quadratures and splines in
float64; the growth ODE's rk4 propagators compose in another order, a
doubling scan where JAX uses associative_scan).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu.cosmology import DefaultBackground as JDefault  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology  # noqa: E402
from cosmoprimo_tpu_torch.cosmology import DefaultBackground  # noqa: E402

RTOL = 1e-11
B = 3
Z = np.array([0.0, 0.2, 0.5, 1.0, 2.5, 10.0])


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def make_params(seed=0):
    rng = np.random.default_rng(seed)
    return dict(omega_cdm=rng.uniform(0.11, 0.13, B), omega_b=rng.uniform(0.021, 0.023, B),
                h=rng.uniform(0.65, 0.70, B), logA=rng.uniform(2.9, 3.1, B), Omega_k=np.array([0.0, 0.05, -0.05]),
                w0_fld=rng.uniform(-1.1, -0.9, B), wa_fld=rng.uniform(-0.2, 0.2, B), m_ncdm=rng.uniform(0.06, 0.12, B))


def single(params, i):
    out = {name: float(v[i]) for name, v in params.items()}
    out['m_ncdm'] = [out['m_ncdm']]
    return out


ZN1, ZN2 = np.array([0.1, 0.5, 1.0]), np.array([0.5, 1.5, 3.0])
NAMES = ('time', 'comoving_radial_distance', 'angular_diameter_distance', 'comoving_transverse_distance',
         'luminosity_distance', 'T_cmb')


@pytest.fixture(scope='module')
def cosmos():
    params = make_params()
    port = Cosmology(engine='eisenstein_hu', **{name: t(v) for name, v in params.items() if name != 'm_ncdm'},
                     m_ncdm=[t(params['m_ncdm'])])
    return port, [jcp.Cosmology(engine='eisenstein_hu', **single(params, i)) for i in range(B)]


@pytest.fixture(scope='module')
def references():
    """Every reference quantity of the batch from one jit of the JAX
    package's functions, vmapped over the cosmologies."""
    params = make_params()

    def run(*values):
        kwargs = dict(zip(params, values))
        kwargs['m_ncdm'] = kwargs['m_ncdm'][None]   # one species
        ba = jcp.Cosmology(engine='eisenstein_hu', **kwargs).get_background()
        out = {name: getattr(ba, name)(Z) for name in NAMES}
        out.update(age=ba.age, rs=ba.rs(1060.0), add2=ba.angular_diameter_distance_2(ZN1, ZN2))
        for mass in ('m', 'cb'):
            out[f'factor_{mass}'] = JDefault.growth_factor(ba, Z, mass=mass)
            out[f'factor_norm_{mass}'] = JDefault.growth_factor(ba, Z, mass=mass, znorm=10.0)
            out[f'rate_{mass}'] = JDefault.growth_rate(ba, Z, mass=mass)
        return out

    return {name: np.asarray(v) for name, v in jax.jit(jax.vmap(run))(*params.values()).items()}


def test_times_and_distances(cosmos, references):
    port, _ = cosmos
    ba = port.get_background()
    for name in NAMES:
        got = getattr(ba, name)(t(Z)).numpy()
        assert got.shape == (B, Z.size), name
        np.testing.assert_allclose(got, references[name], rtol=RTOL, err_msg=name)
    np.testing.assert_array_equal(ba.comoving_angular_distance(t(Z)).numpy(),
                                  ba.comoving_transverse_distance(t(Z)).numpy())
    np.testing.assert_allclose(ba.angular_diameter_distance_2(t(ZN1), t(ZN2)).numpy(), references['add2'], rtol=RTOL)
    np.testing.assert_allclose(ba.age.numpy(), references['age'], rtol=RTOL)
    assert port.luminosity_distance(1.0).shape == (B,)


def test_sound_horizon(cosmos, references):
    port, _ = cosmos
    np.testing.assert_allclose(port.get_background().rs(1060.0).numpy(), references['rs'], rtol=RTOL)


@pytest.mark.parametrize('mass', ['m', 'cb'])
def test_growth_ode(cosmos, references, mass):
    """DefaultBackground's growth (the EH98 engine overrides it with the
    CPT92 fit, so it is called on the EH98 background directly)."""
    port, _ = cosmos
    ba = port.get_background()
    np.testing.assert_allclose(DefaultBackground.growth_factor(ba, t(Z), mass=mass).numpy(),
                               references[f'factor_{mass}'], rtol=RTOL)
    np.testing.assert_allclose(DefaultBackground.growth_factor(ba, t(Z), mass=mass, znorm=10.0).numpy(),
                               references[f'factor_norm_{mass}'], rtol=RTOL)
    np.testing.assert_allclose(DefaultBackground.growth_rate(ba, t(Z), mass=mass).numpy(),
                               references[f'rate_{mass}'], rtol=RTOL)


def test_clone_and_params(cosmos):
    port, refs = cosmos
    clone = port.clone(h=t([0.6, 0.65, 0.7]), m_ncdm=[0.1])
    assert clone.engine.name == 'eisenstein_hu' and clone.device == port.device
    internal = port.clone(base='internal', Omega_k=0.0)
    for i in (0, 2):   # flat and closed
        ref = refs[i]
        jclone = ref.clone(h=[0.6, 0.65, 0.7][i], m_ncdm=[0.1])
        for name in ('h', 'Omega_m', 'm_ncdm_tot', 'N_eff', 'Omega_de'):
            np.testing.assert_allclose(clone[name][i].item(), float(jclone[name]), rtol=RTOL, err_msg=name)
        jinternal = ref.clone(base='internal', Omega_k=0.0)
        np.testing.assert_allclose(internal.comoving_radial_distance(t(Z))[i].numpy(),
                                   np.asarray(jinternal.comoving_radial_distance(Z)), rtol=RTOL)
    assert Cosmology.get_default_params() == jcp.Cosmology.get_default_params()
    assert Cosmology.get_default_params(of='cosmology', include_conflicts=False) == \
        jcp.Cosmology.get_default_params(of='cosmology', include_conflicts=False)
    assert set(port.get_params()) == set(refs[0].get_params())
    assert set(port.get_params('cosmology')) == set(refs[0].get_params('cosmology'))
    assert port.get_params('input')['w0_fld'] is not None
