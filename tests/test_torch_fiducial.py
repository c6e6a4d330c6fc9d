"""The port's fiducial cosmologies (cosmoprimo_tpu_torch/fiducial.py): the
DESI invariants that the JAX package's tests/test_fiducial.py states, the
AbacusSummit table, and every ported factory's parameters and background
against the JAX package's; the port's own data files (desi.dat and the
AbacusSummit table) byte-identical to the JAX package's (sha256).

Bars: the invariants' own (A_s 1e-13 absolute, h, n_s, omega_b, omega_cdm
1e-12, N_ur 1e-4, omega_ncdm 1e-7, m_ncdm 2e-3); the parameters and
comoving distances against the JAX package rtol 1e-12.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from cosmoprimo_tpu import fiducial as jfiducial  # noqa: E402
from cosmoprimo_tpu_torch import CosmologyInputError, fiducial  # noqa: E402

RTOL = 1e-12


@pytest.mark.parametrize('name', ['desi.dat', 'abacus_cosmologies.csv'])
def test_data_files_are_the_port_own_copies(name):
    """The port reads its own copies, which equal the JAX package's."""
    def sha256(directory):
        with open(os.path.join(directory, name), 'rb') as file:
            return hashlib.sha256(file.read()).hexdigest()

    assert os.path.dirname(fiducial._DESI_filename) == fiducial._dir_data
    assert fiducial._dir_data == os.path.join(os.path.dirname(os.path.abspath(fiducial.__file__)), 'data')
    assert sha256(fiducial._dir_data) == sha256(jfiducial._dir_data)


def test_desi_invariants():
    cosmo = fiducial.DESI(device='cpu')
    assert abs(float(cosmo['A_s']) - 2.0830e-9) < 1e-13
    assert abs(float(cosmo['n_s']) - 0.9649) < 1e-12
    assert abs(float(cosmo['N_ur']) - 2.0328) < 1e-4
    assert abs(float(cosmo['h']) - 0.6736) < 1e-12
    assert abs(float(cosmo['omega_ncdm'][0]) - 0.0006442) < 1e-7
    assert abs(float(cosmo['omega_b']) - 0.02237) < 1e-12
    assert abs(float(cosmo['omega_cdm']) - 0.12) < 1e-12
    # one massive neutrino species
    assert cosmo['N_ncdm'] == 1
    assert abs(float(cosmo['m_ncdm'][0]) - 0.06) < 2e-3


def test_abacus_catalog():
    all_params = fiducial.AbacusSummit_params()
    assert all_params == jfiducial.AbacusSummit_params() and len(all_params) >= 90
    assert abs(fiducial.AbacusSummit_params(name=0)['omega_cdm'] - 0.12) < 1e-12
    with pytest.raises(ValueError):
        fiducial.AbacusSummit_params(name='99999')


@pytest.mark.parametrize('name', ['DESI', 'AbacusSummit', 'Planck2018FullFlatLCDM', 'BOSS', 'Uchuu',
                                  'DESIDR2Flatw0waCDM'])
def test_factories_against_jax(name):
    kwargs = dict(name=4) if name == 'AbacusSummit' else {}
    got = getattr(fiducial, name)(engine='eisenstein_hu', device='cpu', **kwargs)
    ref = getattr(jfiducial, name)(engine='eisenstein_hu', **kwargs)
    for param in ('h', 'Omega_m', 'Omega_cdm', 'Omega_b', 'm_ncdm', 'N_eff', 'N_ur', 'A_s', 'w0_fld', 'wa_fld'):
        if param != 'A_s' or 'A_s' in ref._params:   # a sigma8 input has no A_s
            np.testing.assert_allclose(got[param].numpy(), np.asarray(ref[param]), rtol=RTOL, err_msg=param)
    z = np.array([0.3, 1.0, 2.0])
    np.testing.assert_allclose(got.comoving_radial_distance(torch.from_numpy(z)).numpy(),
                               np.asarray(jax.jit(ref.get_background().comoving_radial_distance)(z)), rtol=RTOL)
    assert got.device == torch.device('cpu')


def test_tabulated_not_ported(tmp_path, monkeypatch):
    """TabulatedDESI and save_TabulatedDESI are ported (tests/test_torch_
    tabulated.py); the engine that made the shipped table, CLASS, is not
    (slice 6): regenerating it with engine='class' raises before it writes."""
    assert fiducial.TabulatedDESI(device='cpu').engine.name == 'tabulated'
    monkeypatch.setattr(fiducial, '_DESI_filename', str(tmp_path / 'desi.dat'))
    with pytest.raises(CosmologyInputError, match='Unknown engine class'):
        fiducial.save_TabulatedDESI(engine='class', device='cpu')
    assert not (tmp_path / 'desi.dat').exists()
