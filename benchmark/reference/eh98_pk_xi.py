"""Plain reference of the ``eh98_pk_xi`` configuration: for each cosmology,
the Eisenstein & Hu (1998) linear P(k) at the configuration's k and z, its
correlation function xi(s) by FFTLog, chi at 0.5, 1 and 2 (Mpc/h) and sigma8
by Simpson's rule over the same k grid."""

import numpy as np

from . import common


def compute(params, config, dtype=np.float64):
    """``params``: (n,) arrays omega_cdm, omega_b, h, n_s, logA. Returns xi
    (n, nz, nk), chi (n, 3) and sigma8 (n,), in ``dtype``."""
    p = {name: np.asarray(value, dtype) for name, value in params.items()}
    k64 = np.geomspace(config['kmin'], config['kmax'], config['nk'])
    k = k64.astype(dtype)
    z = np.asarray(config['z'], dtype)
    background = common.Background(p['omega_cdm'], p['omega_b'], p['h'], dtype=dtype)
    eh = common.EH98(p['omega_cdm'], p['omega_b'], p['h'], dtype=dtype)
    A_s = np.exp(p['logA']) * 1e-10
    pk = common.linear_pk(eh.transfer(k), background, A_s, p['n_s'], k)               # (n, nk)
    pkz = pk[:, None, :] * (background.growth(z) ** 2)[:, :, None]                  # (n, nz, nk)
    w8 = (k64 ** 3 * common.tophat2(8.0 * k64)).astype(dtype)
    pk0 = pk * background.growth(np.zeros(1, dtype)) ** 2
    sigma8 = np.sqrt(common.simpson_avg(pk0 * w8, np.log(k)) / (2.0 * np.pi ** 2))
    chi = background.comoving_radial_distance(np.asarray(config['chi_z'], dtype))
    xi = common.PowerToCorrelation(k64, dtype=dtype)(pkz)
    return {'xi': xi, 'chi': chi, 'sigma8': sigma8}
