"""The port's host-side Boltzmann machinery (cosmoprimo_tpu_torch/models/
boltzmann.py) against the JAX package's models/boltzmann.py, and the
wrapper engines' gating, on the CPU:

- translate_class_params / translate_camb_params on the compiled
  parameters of LCDM, fld, ncdm (one and three species, non-linear
  'mead' and 'halofit') and tensor-mode cosmologies: the same keys and
  values (numbers exact; arrays equal); beta_s raises CosmologyInputError
  in both;
- camb_nu_degeneracies, background_z_grid and build_task_dependency: equal;
- every engine name of the JAX package's registry table resolves in the
  port; without pyclass / camb, Cosmology(engine='class') and 'camb' raise
  CosmologyInputError, as in the JAX package (the engines run for real
  where the host code is installed);
- a custom engine's ``_section_overrides`` gives its overriding section, as
  the JAX package's engine registry does.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from cosmoprimo_tpu import cosmology as jcosmology  # noqa: E402
from cosmoprimo_tpu.models import boltzmann as jboltzmann  # noqa: E402
from cosmoprimo_tpu_torch import cosmology  # noqa: E402
from cosmoprimo_tpu_torch.models import boltzmann  # noqa: E402

COSMOLOGIES = {
    'lcdm': dict(omega_cdm=0.12, omega_b=0.02237, h=0.6736, sigma8=0.8, n_s=0.9649),
    'fld': dict(w0_fld=-0.9, wa_fld=0.1, lensing=True),
    'ncdm': dict(m_ncdm=0.06, non_linear='mead', A_s=2.1e-9),
    'ncdm3': dict(m_ncdm=[0.01, 0.02, 0.05], non_linear='halofit', z_pk=[0.0, 1.0]),
    'tensor': dict(modes=['s', 't'], r=0.05, n_t=-0.01, ellmax_cl=1000),
}


def host(params):
    """Compiled parameters as host values, as the wrapper engines give them
    to the translations."""
    return {name: (value.numpy() if value.dim() else float(value)) if isinstance(value, torch.Tensor) else value
            for name, value in params.items()}


def assert_same(got, ref):
    assert set(got) == set(ref)
    for name, value in ref.items():
        if isinstance(value, (str, bool, list, type(None))):
            assert got[name] == value, name
        else:
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(value), err_msg=name)


def both(name):
    kwargs = COSMOLOGIES[name]
    cosmo = cosmology.Cosmology(device='cpu', **kwargs)
    jcosmo = jcosmology.Cosmology(**kwargs)
    return cosmo, jcosmo


@pytest.mark.parametrize('name', sorted(COSMOLOGIES))
def test_class_translation_against_jax(name):
    cosmo, jcosmo = both(name)
    has_fld = bool(cosmo._has_fld)
    for kwargs in ({}, {'extra_params': {'k_per_decade_for_pk': 10}}):
        got = boltzmann.translate_class_params(host(cosmo._params), A_s_fid=2.1e-9, has_fld=has_fld,
                                               N_ncdm=cosmo['N_ncdm'], **kwargs)
        ref = jboltzmann.translate_class_params(jcosmo._params, A_s_fid=2.1e-9, has_fld=has_fld,
                                                N_ncdm=jcosmo['N_ncdm'], **kwargs)
        assert_same(got, ref)


@pytest.mark.parametrize('name', sorted(COSMOLOGIES))
def test_camb_translation_against_jax(name):
    cosmo, jcosmo = both(name)
    has_fld = bool(cosmo._has_fld)
    got = boltzmann.translate_camb_params(host(cosmo._params), A_s_fid=2.1e-9, has_fld=has_fld,
                                          N_eff=float(cosmo['N_eff']))
    ref = jboltzmann.translate_camb_params(jcosmo._params, A_s_fid=2.1e-9, has_fld=has_fld,
                                           N_eff=float(np.asarray(jcosmo['N_eff'])))
    for g, r in zip(got, ref):
        assert_same(g, r)
    assert_same(dict(zip(('g', 'f'), boltzmann.camb_nu_degeneracies(host(cosmo._params)['T_ncdm_over_cmb'],
                                                                   host(cosmo._params)['m_ncdm']))),
                dict(zip(('g', 'f'), jboltzmann.camb_nu_degeneracies(jcosmo._params['T_ncdm_over_cmb'],
                                                                    jcosmo._params['m_ncdm']))))


def test_beta_s_refused():
    params = host(cosmology.Cosmology(device='cpu', beta_s=0.01)._params)
    with pytest.raises(cosmology.CosmologyInputError):
        boltzmann.translate_class_params(params, N_ncdm=0)
    with pytest.raises(jcosmology.CosmologyInputError):
        jboltzmann.translate_class_params(jcosmology.Cosmology(beta_s=0.01)._params, N_ncdm=0)


@pytest.mark.parametrize('tasks', ['background', 'thermodynamics', 'transfer', 'fourier', 'harmonic',
                                   ['thermodynamics', 'background'], ['harmonic', 'lensing'], ('fourier',)])
def test_task_dependency_against_jax(tasks):
    assert sorted(boltzmann.build_task_dependency(tasks)) == sorted(jboltzmann.build_task_dependency(tasks))


def test_z_grid_and_lazy_names():
    np.testing.assert_array_equal(boltzmann.background_z_grid(), jboltzmann.background_z_grid())
    from cosmoprimo_tpu_torch.models import camb, classy
    assert boltzmann.ClassEngine is classy.ClassEngine and boltzmann.DSClassEngine is classy.DSClassEngine
    assert boltzmann.CambEngine is camb.CambEngine and boltzmann.HEFTCambEngine is camb.HEFTCambEngine
    with pytest.raises(AttributeError):
        boltzmann.NoSuchEngine


def test_every_engine_name_resolves():
    for name in jcosmology._ENGINE_MODULES:
        assert name in cosmology._ENGINE_MODULES, name
        assert issubclass(cosmology.get_engine(name), cosmology.BaseEngine), name


def test_engine_gating(monkeypatch):
    """Without the host package both packages raise CosmologyInputError; with
    it, the engine runs."""
    for name, module in [('class', 'pyclass'), ('camb', 'camb')]:
        try:
            __import__(module)
            available = True
        except ImportError:
            available = False
        if available:
            c = cosmology.Cosmology(engine=name, device='cpu')
            assert torch.isfinite(c.get_background().comoving_radial_distance(1.0))
        else:
            with pytest.raises(cosmology.CosmologyInputError, match=module):
                cosmology.Cosmology(engine=name, device='cpu')
            with pytest.raises(jcosmology.CosmologyInputError):
                jcosmology.Cosmology(engine=name)


def test_section_overrides():
    """An engine's _section_overrides replaces the section its module gives."""
    from cosmoprimo_tpu_torch.models import eisenstein_hu

    class Background(cosmology.DefaultBackground):
        marker = True

    class Engine(eisenstein_hu.EisensteinHuEngine):
        name = 'test_section_overrides'
        _section_overrides = {'Background': Background}

    Engine.__module__ = eisenstein_hu.__name__   # sections found in the engine's module, as a variant's

    cosmo = cosmology.Cosmology(engine=Engine, device='cpu')
    assert isinstance(cosmo.get_background(), Background)
    assert type(cosmo.get_fourier()) is eisenstein_hu.Fourier
    assert type(cosmology.Cosmology(engine='eisenstein_hu', device='cpu').get_background()) is not Background
