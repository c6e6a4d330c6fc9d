"""The port's tabulated engine (cosmoprimo_tpu_torch/models/tabulated.py),
TabulatedDESI and save_TabulatedDESI (fiducial.py) and DistanceToRedshift
(utils.py) against the JAX package's, on tables written to ``tmp_path`` and
the DESI table read in place.

Bars:
- tabulated background: rtol 1e-15 against the JAX engine (the same linear
  interpolation formula; measured 2.2e-16);
- TabulatedDESI against DESI()'s closed-form background: rtol 1e-4, the
  bar of tests/test_fiducial.py::test_tabulated_desi (measured 1.0e-6);
- save_TabulatedDESI's table against the JAX package's: rtol 1e-12
  (measured 6.7e-16);
- DistanceToRedshift against the JAX package's: rtol 1e-10 (measured
  1.9e-15: two natural-spline solves of 2048 knots); the round trip
  z -> chi -> z at rtol 1e-6, the bar of tests/test_utils.py (measured
  5.5e-10); the per-row knots of a batch against one cosmology at a time,
  rtol 1e-12 (measured 2.2e-16).

Departure from the reference, by design (ROADMAP queue 3): a redshift
outside the table gives NaN in the port (nothing is checked on the host),
where the JAX package raises outside a trace.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu import fiducial as jfiducial  # noqa: E402
from cosmoprimo_tpu.utils import DistanceToRedshift as JDistanceToRedshift  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, fiducial  # noqa: E402
from cosmoprimo_tpu_torch.utils import DistanceToRedshift  # noqa: E402

Z = np.array([0.0, 1e-8, 0.15, 0.5, 1.0, 2.5, 9.0, 100.0])


def jax_background(name, **params):
    """The JAX package's EH98 background method ``name``, jitted, its
    cosmology built inside the trace."""
    return jax.jit(lambda z: getattr(jcp.Cosmology(engine='eisenstein_hu', **params).get_background(), name)(z))


@pytest.fixture(scope='module')
def table(tmp_path_factory):
    """A (z, efunc, chi) table of 300 rows from the JAX package's EH98
    background, with a header."""
    fn = str(tmp_path_factory.mktemp('tab') / 'table.txt')
    z = np.concatenate([[0.0], np.geomspace(1e-3, 10.0, 299)])
    np.savetxt(fn, np.array([z] + [np.asarray(jax_background(name, h=0.68)(z)) for name in ('efunc', 'comoving_radial_distance')]).T,
               header='z efunc chi')
    return fn


def test_tabulated_engine_against_jax(table):
    extra = {'filename': table, 'names': ['efunc', 'comoving_radial_distance']}
    port = Cosmology(engine='tabulated', extra_params=extra, device='cpu')
    ref = jcp.Cosmology(engine='tabulated', extra_params=extra)
    z = np.random.default_rng(0).uniform(0.0, 10.0, (3, 40))
    for name in ('efunc', 'comoving_radial_distance'):
        got = getattr(port, name)(torch.from_numpy(z))
        assert got.shape == z.shape and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref.get_background(), name)(z)), rtol=1e-15)
    assert port.efunc(1.0).shape == ()
    # one table for every row of a batch
    batch = Cosmology(engine='tabulated', extra_params=extra, h=torch.tensor([0.6, 0.7], dtype=torch.float64))
    assert batch.efunc(z[0]).shape == (2, 40)
    np.testing.assert_array_equal(batch.efunc(z[0])[1].numpy(), port.efunc(z[0]).numpy())


def test_out_of_range_policy(table):
    """A redshift outside the table: NaN in the port, no host check; the JAX
    package raises there (eagerly)."""
    extra = {'filename': table}
    port = Cosmology(engine='tabulated', extra_params=extra, device='cpu')
    z = np.array([-0.1, 0.5, 10.0, 10.5])
    got = port.comoving_radial_distance(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(np.isnan(got), [True, False, False, True])
    assert np.isnan(port.efunc(11.0).item())
    with pytest.raises(Exception, match='outside of tabulated range'):
        jcp.Cosmology(engine='tabulated', extra_params=extra).efunc(z)


def test_tabulated_desi():
    port = fiducial.TabulatedDESI(device='cpu')
    ref = jfiducial.TabulatedDESI()
    assert port.engine.name == 'tabulated' and port['N_ncdm'] == 1
    closed = fiducial.DESI(engine='eisenstein_hu', device='cpu')
    for name in ('efunc', 'comoving_radial_distance'):
        got = getattr(port, name)(Z).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(ref.get_background(), name)(Z)), rtol=1e-15)
        # the table comes from CLASS: the closed form agrees to ~1e-5
        np.testing.assert_allclose(got[2:7], getattr(closed, name)(Z[2:7]).numpy(), rtol=1e-4)


def test_tabulated_desi_state(tmp_path):
    """TabulatedDESI through a file of either package: the engine's extra
    parameters (the table's path and names) come back; the JAX package's
    file names its own copy of the table, byte-identical to the port's."""
    port = fiducial.TabulatedDESI(device='cpu')
    port.write(tmp_path / 'port.json')
    ref = jcp.Cosmology.read(str(tmp_path / 'port.json'))
    np.testing.assert_allclose(np.asarray(ref.efunc(Z)), port.efunc(Z).numpy(), rtol=1e-15)
    assert Cosmology.read(tmp_path / 'port.json', device='cpu') == port
    jfiducial.TabulatedDESI().write(str(tmp_path / 'jax.npy'))
    back = Cosmology.read(tmp_path / 'jax.npy', device='cpu')
    jextra = jfiducial.TabulatedDESI().engine._extra_params
    assert back.engine.name == 'tabulated' and back.engine._extra_params == {**jextra, 'names': list(jextra['names'])}
    assert {**back.engine._extra_params, 'filename': None} == {**port.engine._extra_params, 'filename': None}
    with open(back.engine._extra_params['filename'], 'rb') as jax_table, open(fiducial._DESI_filename, 'rb') as table:
        assert jax_table.read() == table.read()
    np.testing.assert_array_equal(back.comoving_radial_distance(Z).numpy(), port.comoving_radial_distance(Z).numpy())


def test_save_tabulated_desi(tmp_path, monkeypatch):
    """The table written to the module's file name, which the test points
    into tmp_path in both packages."""
    port_fn, jax_fn = str(tmp_path / 'port.dat'), str(tmp_path / 'jax.dat')
    monkeypatch.setattr(fiducial, '_DESI_filename', port_fn)
    monkeypatch.setattr(jfiducial, '_DESI_filename', jax_fn)
    fiducial.save_TabulatedDESI(device='cpu')
    jfiducial.save_TabulatedDESI()
    got, ref = np.loadtxt(port_fn), np.loadtxt(jax_fn)
    assert got.shape == ref.shape == (40002, 3)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=1e-12)
    with open(port_fn) as file:
        assert file.readline() == '# z = [0] + np.logspace(-8, 2, 40001)\n'
    # TabulatedDESI reads that file: at its knots, the table's values
    knots = got[:-1:4000]
    np.testing.assert_array_equal(fiducial.TabulatedDESI(device='cpu').efunc(knots[:, 0]).numpy(), knots[:, 1])


def test_distance_to_redshift_against_jax():
    port = Cosmology(engine='eisenstein_hu', device='cpu')
    d2z = DistanceToRedshift(port.comoving_radial_distance)
    jd2z = JDistanceToRedshift(jax_background('comoving_radial_distance'))
    z = np.array([1e-6, 0.2, 1.0, 3.0, 50.0])
    d = port.comoving_radial_distance(z)
    got = d2z(d).numpy()
    np.testing.assert_allclose(got, np.asarray(jd2z(d.numpy())), rtol=1e-10)
    np.testing.assert_allclose(got, z, rtol=1e-6)
    assert d2z(d.reshape(5, 1)).shape == (5, 1) and d2z(d[2]).shape == ()
    assert np.isnan(d2z(torch.tensor([-1.0, 1e6], dtype=torch.float64)).numpy()).all()
    # the linear inversion
    np.testing.assert_allclose(DistanceToRedshift(port.comoving_radial_distance, interp_order=1)(d).numpy(),
                               np.asarray(JDistanceToRedshift(jax_background('comoving_radial_distance'),
                                                              interp_order=1)(d.numpy())), rtol=1e-10)


@pytest.mark.parametrize('interp_order', [3, 1])
def test_distance_to_redshift_batch(interp_order):
    """Knots per row for a batch, against one cosmology at a time."""
    h = np.array([0.62, 0.68, 0.74])
    batch = Cosmology(engine='eisenstein_hu', h=torch.from_numpy(h))
    d2z = DistanceToRedshift(batch.comoving_radial_distance, interp_order=interp_order)
    z = np.array([0.3, 1.2, 4.0])
    d = batch.comoving_radial_distance(torch.from_numpy(z))            # (3, 3): each row at z
    got = d2z(d)
    assert got.shape == (3, 3) and d2z(d[:, 0]).shape == (3, 3)   # (3,) broadcasts against (3, 1)
    for i in range(3):
        one = Cosmology(engine='eisenstein_hu', h=float(h[i]), device='cpu')
        np.testing.assert_allclose(got[i].numpy(), DistanceToRedshift(one.comoving_radial_distance,
                                                                      interp_order=interp_order)(d[i]).numpy(),
                                   rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(z, (3, 3)), rtol=1e-6 if interp_order == 3 else 1e-3)
