"""The port's BAO filters (cosmoprimo_tpu_torch/bao_filter.py) against the JAX
package's, and the EH98 sound horizon (models/eisenstein_hu.py::
Thermodynamics), on a batch of cosmologies with massive neutrinos made
from a seed with numpy, at two redshifts and the filters' default
1024-point k-grid, with the DESI fiducial.

The port filters the whole batch in one call. The JAX filter is built on
the first cosmology (its prepare step freezes what depends on the data
there: the first row's peak, the fiducial's peak positions) and then
called on each cosmology in turn, each with its own sound-horizon ratio.

Bars: rtol 1e-9 on each filter's pknow or xinow (the same fits in float64;
the least-squares systems are inverted in another order of operations,
and the scans of the per-row splines compose in another order), except
hinton2017 at 5e-9: its degree-12 bordered system has a condition number
of 5.3e12, and the JAX package's explicit inverse leaves its fit 1.5e-9 to
2.6e-9 from the solution in extended precision (measured on this batch),
where the port, which makes the fit's linear map in long double, is within
1e-12 of it (test_hinton2017_extended_precision; measured 2.2e-14). rtol 1e-13 on rs_drag and z_drag.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu import bao_filter as jbao  # noqa: E402
from cosmoprimo_tpu import fiducial as jfiducial  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology  # noqa: E402
from cosmoprimo_tpu_torch.bao_filter import CorrelationFunctionBAOFilter, PowerSpectrumBAOFilter  # noqa: E402
from cosmoprimo_tpu_torch.fiducial import DESI  # noqa: E402

RTOL = 1e-9
RTOL_FILTER = {'hinton2017': 5e-9}
B = 3
Z = [0.51, 1.317]
PK_FILTERS = ['hinton2017', 'savgol', 'ehsavgol', 'ehpoly', 'wallish2018', 'brieden2022', 'peakaverage', 'bspline']


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


@pytest.fixture(scope='module')
def batch():
    rng = np.random.default_rng(0)
    params = dict(omega_cdm=rng.uniform(0.11, 0.13, B), omega_b=rng.uniform(0.021, 0.023, B),
                  h=rng.uniform(0.65, 0.70, B), n_s=rng.uniform(0.94, 0.98, B), logA=rng.uniform(2.9, 3.1, B))
    m_ncdm = rng.uniform(0.06, 0.12, B)
    port = Cosmology(engine='eisenstein_hu', m_ncdm=[t(m_ncdm)], N_eff=3.044,
                     **{name: t(v) for name, v in params.items()})
    refs = [jcp.Cosmology(engine='eisenstein_hu', m_ncdm=[float(m_ncdm[i])], N_eff=3.044,
                          **{name: float(v[i]) for name, v in params.items()}) for i in range(B)]
    return (port, DESI(engine='eisenstein_hu', device='cpu'), port.get_fourier().pk_interpolator(z=Z),
            refs, jfiducial.DESI(engine='eisenstein_hu'), [ref.get_fourier().pk_interpolator(z=Z) for ref in refs])


def test_rs_drag(batch):
    port, fid, _, refs, jfid, _ = batch
    for name in ('rs_drag', 'z_drag'):
        got = getattr(port, name).numpy()
        for i, ref in enumerate(refs):
            np.testing.assert_allclose(got[i], float(getattr(ref, name)), rtol=1e-13, err_msg=name)
        np.testing.assert_allclose(getattr(fid, name).item(), float(getattr(jfid, name)), rtol=1e-13, err_msg=name)


@pytest.mark.parametrize('engine', PK_FILTERS)
def test_pk_filter_against_jax(batch, engine):
    port, fid, pk, refs, jfid, jpks = batch
    got = PowerSpectrumBAOFilter(pk, engine=engine, cosmo=port, cosmo_fid=fid)
    assert got.pknow.shape == (B, 1024, len(Z)) and got.pk.shape == got.pknow.shape
    ref = jbao.PowerSpectrumBAOFilter(jpks[0], engine=engine, cosmo=refs[0], cosmo_fid=jfid)
    for i in range(B):
        if i:
            ref(jpks[i], cosmo=refs[i])
        np.testing.assert_allclose(got.pknow[i].numpy(), np.asarray(ref.pknow), rtol=RTOL_FILTER.get(engine, RTOL),
                                   err_msg=f'row {i}')
    # the smooth spectrum as an interpolator, on the filter's own grid
    smooth = got.smooth_pk_interpolator()
    np.testing.assert_allclose(smooth(t(got.k[10:-10]), t(Z), ignore_growth=True).numpy(), got.pknow[:, 10:-10].numpy(),
                               rtol=1e-10)


def test_hinton2017_extended_precision(batch):
    """The port's hinton2017 fit against the same bordered system built
    here and solved in numpy's long double, refined iteratively."""
    _, _, pk, _, _, _ = batch
    got = PowerSpectrumBAOFilter(pk, engine='hinton2017')
    span = got._span
    rows = got.pk.transpose(-1, -2).reshape(-1, got.k.size).numpy()
    logk = np.log10(got.k[span])
    peak = logk[np.argmax(rows[0, span])]
    G = np.array([((logk - logk.mean()) / logk.std()) ** i for i in range(13)])
    w = (1.0 - 0.9 * np.exp(-0.5 * ((logk - peak) / 0.5) ** 2)) ** 2
    C = np.column_stack([G[..., 0], G[..., 1] - G[..., 0], G[..., 2] - 2.0 * G[..., 1] + G[..., 0],
                         G[..., -1], G[..., -2] - G[..., -1], G[..., -3] - 2.0 * G[..., -2] + G[..., -1]])
    G, w, C = (a.astype(np.longdouble) for a in (G, w, C))
    nb, nc = C.shape
    system = np.zeros((nb + nc, nb + nc), dtype=np.longdouble)
    system[:nb, :nb], system[:nb, nb:], system[nb:, :nb] = (G * w) @ G.T, -C, C.T
    models = got.pknow.transpose(-1, -2).reshape(-1, got.k.size)[:, span].numpy()
    for row, model in zip(rows, models):
        d = np.log10(np.asarray(row[span], dtype=np.longdouble))
        rhs = np.concatenate([(G * w) @ d, [d[0], d[1] - d[0], d[2] - 2 * d[1] + d[0], d[-1], d[-2] - d[-1],
                                            d[-3] - 2 * d[-2] + d[-1]]])
        x = np.zeros(nb + nc, dtype=np.longdouble)
        for _ in range(6):
            x = x + np.linalg.solve(system.astype(np.float64), (rhs - system @ x).astype(np.float64))
        np.testing.assert_allclose(model, (10 ** (x[:nb] @ G)).astype(np.float64), rtol=1e-12)


def test_xi_filter_against_jax(batch):
    port, fid, pk, refs, jfid, jpks = batch
    got = CorrelationFunctionBAOFilter(pk.to_xi(), engine='kirkby2013', cosmo=port, cosmo_fid=fid)
    assert got.xinow.shape == (B, 1024, len(Z))
    ref = jbao.CorrelationFunctionBAOFilter(jpks[0].to_xi(), engine='kirkby2013', cosmo=refs[0], cosmo_fid=jfid)
    for i in range(B):
        if i:
            ref(jpks[i].to_xi(), cosmo=refs[i])
        scale = np.abs(np.asarray(ref.xi)).max(axis=0)
        np.testing.assert_allclose(got.xinow[i].numpy() / scale, np.asarray(ref.xinow) / scale, rtol=0, atol=RTOL,
                                   err_msg=f'row {i}')


def test_filter_registry():
    with pytest.raises(ValueError, match='unknown'):
        PowerSpectrumBAOFilter(None, engine='nope')
    with pytest.raises(ValueError, match='unknown'):
        CorrelationFunctionBAOFilter(None, engine='nope')
