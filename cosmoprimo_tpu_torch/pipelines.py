"""The batched headline pipeline (cosmoprimo_tpu/pipelines.py::make_pk_to_xi_pipeline_batched)."""

import functools

import numpy as np
import torch

from .cosmology import Cosmology
from .fftlog import PowerToCorrelation
from .interpolator import kernel_tophat2
from .ops import simpson


def make_pk_to_xi_pipeline_batched(nk=1024, kmin=1e-5, kmax=1e2, engine='eisenstein_hu', z=(0.0,), fft_engine='auto'):
    """Build (fn, k, s): ``fn(omega_cdm, omega_b, h, n_s, logA)``, each a (B,)
    float64 tensor, returns on their device

    - xi: (B, nz, nk), the linear correlation function at ``z`` on the grid s;
    - chi: (B, 3), the comoving radial distance at z = 0.5, 1, 2 (Mpc/h);
    - sigma8: (B,), from the linear P(k) at z = 0.

    P(k, z) is evaluated for the whole batch at once, then ONE FFTLog runs
    over all B * nz rows. k and s are numpy (nk,) grids.
    """
    # host-built grid: exact endpoints, inside the interpolator bounds
    k_np = np.geomspace(kmin, kmax, nk)
    z_np = np.atleast_1d(np.asarray(z, dtype=np.float64))
    p2c = PowerToCorrelation(k_np, engine=fft_engine)
    # sigma8 as a static-weight Simpson sum over the same k-grid:
    # w_i = k^3 W^2(8k) against ln k
    w8_np = k_np ** 3 * kernel_tophat2(torch.from_numpy(8.0 * k_np)).numpy()
    iz0 = int(np.argmin(np.abs(z_np)))
    z0_in_grid = z_np[iz0] == 0.0

    @functools.lru_cache(maxsize=None)
    def grids(device):
        return tuple(torch.from_numpy(array).to(device) for array in
                     (k_np, z_np, np.log(k_np), w8_np, np.array([0.5, 1.0, 2.0]), np.zeros(1)))

    def fn(omega_cdm, omega_b, h, n_s, logA):
        k, zz, lnk, w8, zq, z0 = grids(omega_cdm.device)
        cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s, logA=logA, engine=engine)
        pk = cosmo.get_fourier().pk_interpolator()
        pkz = pk(k, zz)                                     # (B, nk, nz)
        # sigma8 is defined on the linear spectrum at z = 0
        pk0 = pkz[..., iz0] if z0_in_grid else pk(k, z0)[..., 0]
        sigma8 = torch.sqrt(simpson(pk0 * w8, x=lnk) / (2.0 * np.pi ** 2))
        chi = cosmo.get_background().comoving_radial_distance(zq)
        s, xi = p2c(pkz.transpose(-1, -2))                 # (B, nz, nk): one batched FFTLog
        return xi, chi, sigma8

    return fn, k_np, np.asarray(p2c.y[0])
