"""The port's quickstart (cosmoprimo_tpu_torch/quickstart.py, the counterpart
of examples/quickstart.py) run in process on the CPU: it ends with its
closing line, its chi(z = 1) and sigma8 agree with the JAX package's
values for the DESI fiducial on the eisenstein_hu engine (rtol 1e-10), and
its solved h gives theta_MC_100 within 1e-6 of the target, as the example
asserts. The two JAX sections run under one jax.jit (4 s on the CPU; 40 s
eagerly, the background table's integration op by op); no pipeline is
compiled."""

import numpy as np
import pytest

jax = pytest.importorskip('jax')

from cosmoprimo_tpu.fiducial import DESI as JaxDESI  # noqa: E402
from cosmoprimo_tpu_torch import quickstart  # noqa: E402


def test_quickstart_on_cpu(capsys):
    results = quickstart.main(['--device', 'cpu'])
    assert capsys.readouterr().out.rstrip().endswith('quickstart: all sections ran.')

    def reference():
        cosmo = JaxDESI(engine='eisenstein_hu')
        return (cosmo.get_background().comoving_radial_distance(np.array([1.0]))[0],
                cosmo.get_fourier().pk_interpolator().sigma8_z(0.0))

    chi1, sigma8 = (float(value) for value in jax.jit(reference)())
    np.testing.assert_allclose(results['chi_z1'][0], chi1, rtol=1e-10)
    np.testing.assert_allclose(results['sigma8'], sigma8, rtol=1e-10)
    assert abs(float(results['theta_MC_100_solved']) - quickstart.THETA_MC_100) < 1e-6
    for name in quickstart.BARS:
        assert np.all(np.isfinite(results[name])), name
