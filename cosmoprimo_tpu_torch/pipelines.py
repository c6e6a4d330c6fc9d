"""The pipelines (cosmoprimo_tpu/pipelines.py): the pk -> xi pipeline
(make_pk_to_xi_pipeline_batched, its per-cosmology form
make_pk_to_xi_pipeline, and apply_non_linear), linear or through halofit or
HMcode-2020, the distance pipeline (make_distance_pipeline) and the native
Boltzmann P(k) pipeline (make_native_pk_pipeline_batched)."""

import functools

import numpy as np
import torch

from . import constants, tracing
from .cosmology import Cosmology
from .fftlog import PowerToCorrelation
from .interpolator import kernel_tophat2
from .models.halofit import _geomspace, halofit
from .models.hmcode import HMCODE_NAMES, hmcode2020
from .ops import simpson


def apply_non_linear(non_linear, cosmo, ba, k, pk_t, z, omega_b, h, n_s, logT_AGN=7.8):
    """Push the linear P(k, z) table ``pk_t`` (B, nz, nk) through halofit
    (``non_linear`` = 'halofit', 'takahashi' or True) or HMcode-2020
    ('mead', 'hmcode', 'mead2020', 'hmcode2020'; 'mead2020_feedback' adds
    the baryon response at ``logT_AGN``). ``k`` (nk,) and ``z`` (nz,) are
    tensors on the batch's device. Returns (B, nz, nk)."""
    if not non_linear:
        return pk_t
    w0, wa = cosmo['w0_fld'], cosmo['wa_fld']
    fnu = cosmo['Omega_ncdm_tot'] / cosmo['Omega_m']
    if non_linear in ('halofit', 'takahashi', True):
        return halofit(k, pk_t, ba.Omega_m(z), ba.Omega_de(z), w0[..., None] + wa[..., None] * z / (1.0 + z),
                       fnu=fnu, Omega_m0=cosmo['Omega_m'])
    if non_linear in HMCODE_NAMES:
        a_grid = _geomspace(1e-3, 1.0, 128, k.device)
        return hmcode2020(k, pk_t, pk_t, ba.Omega_m(z), fnu=fnu, omega_m=cosmo['Omega_m'] * h ** 2,
                          omega_b=omega_b, h=h, theta_cmb=constants.TCMB / 2.7, ns=n_s,
                          growth_a=a_grid, growth_g=ba.growth_factor(1.0 / a_grid - 1.0),
                          growth_z=ba.growth_factor(z), z=z,
                          logT_AGN=logT_AGN if non_linear == 'mead2020_feedback' else None,
                          Omega_k0=cosmo['Omega_k'], w0=w0, wa=wa)
    raise ValueError(f'unknown non_linear {non_linear!r}')


def make_pk_to_xi_pipeline_batched(nk=1024, kmin=1e-5, kmax=1e2, engine='eisenstein_hu', z=(0.0,), fft_engine='auto',
                                   non_linear=False):
    """Build (fn, k, s): ``fn(omega_cdm, omega_b, h, n_s, logA)``, each a (B,)
    float64 tensor, returns on their device

    - xi: (B, nz, nk), the correlation function at ``z`` on the grid s, of
      the linear P(k) or, with ``non_linear`` (see :func:`apply_non_linear`),
      of the halofit or HMcode-2020 one;
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
        with tracing.span('cosmoprimo.pipeline.pk_to_xi'):
            k, zz, lnk, w8, zq, z0 = grids(omega_cdm.device)
            cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s, logA=logA, engine=engine)
            pk = cosmo.get_fourier().pk_interpolator()
            pkz = pk(k, zz)                                     # (B, nk, nz)
            # sigma8 is defined on the linear spectrum at z = 0
            pk0 = pkz[..., iz0] if z0_in_grid else pk(k, z0)[..., 0]
            sigma8 = torch.sqrt(simpson(pk0 * w8, x=lnk) / (2.0 * np.pi ** 2))
            ba = cosmo.get_background()
            pk_t = apply_non_linear(non_linear, cosmo, ba, k, pkz.transpose(-1, -2), zz, omega_b, h, n_s)  # (B, nz, nk)
            chi = ba.comoving_radial_distance(zq)
            s, xi = p2c(pk_t)                                   # one batched FFTLog
            return xi, chi, sigma8

    return fn, k_np, np.asarray(p2c.y[0])


def make_pk_to_xi_pipeline(nk=1024, kmin=1e-5, kmax=1e2, engine='eisenstein_hu', z=(0.0,), fft_engine='auto',
                           non_linear=False):
    """The per-cosmology pipeline: (fn, k, s), where ``fn(omega_cdm,
    omega_b, h, n_s, logA)`` takes 0-d tensors and returns xi (nz, nk), chi
    (3,) and sigma8 (), as :func:`make_pk_to_xi_pipeline_batched` does at
    the batch shape () (the port is batch-first, so one cosmology is a batch
    of shape ()). ``torch.func.jacfwd`` of ``fn`` gives the Fisher
    derivatives."""
    return make_pk_to_xi_pipeline_batched(nk=nk, kmin=kmin, kmax=kmax, engine=engine, z=z, fft_engine=fft_engine,
                                          non_linear=non_linear)


def make_distance_pipeline(engine='eisenstein_hu', zq=None):
    """(fn, zq): ``fn(omega_cdm, omega_b, h)`` (tensors of one batch shape)
    returns the comoving radial distances (Mpc/h) at ``zq`` (by default 60
    redshifts from 0.05 to 3): batch + (nzq,)."""
    zq = np.linspace(0.05, 3.0, 60) if zq is None else np.asarray(zq, dtype=np.float64)

    @functools.lru_cache(maxsize=None)
    def grid(device):
        return torch.from_numpy(zq).to(device)

    def fn(omega_cdm, omega_b, h):
        cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, engine=engine)
        return cosmo.get_background().comoving_radial_distance(grid(cosmo.device))

    return fn, zq


def make_native_pk_pipeline_batched(nk=256, kmax=1.0, z=(0.0, 1.0)):
    """Build (fn, k): ``fn(omega_cdm, omega_b, h, n_s, logA)``, each a (B,)
    float64 tensor, runs the native chain for the whole batch on their
    device: the recombination history, the MB95 hierarchy on ``nk``
    log-spaced k in [1e-4, kmax] h/Mpc (lanes (B, nk)) and the primordial
    assembly. Returns pk_m (B, nz, nk) [(Mpc/h)^3] at ``z`` and sigma8 (B,),
    a static-weight Simpson sum over the same k grid; ``k`` is numpy."""
    from .boltzmann.perturbations import linear_pk, steps_for_kmax

    n_steps = steps_for_kmax(kmax)   # kmax in h/Mpc bounds kmax in 1/Mpc
    k_np = np.geomspace(1e-4, kmax, nk)
    z = list(np.atleast_1d(np.asarray(z, dtype=np.float64)))
    w8_np = k_np ** 3 * kernel_tophat2(torch.from_numpy(8.0 * k_np)).numpy()
    iz0 = int(np.argmin(np.abs(np.asarray(z))))

    @functools.lru_cache(maxsize=None)
    def grids(device):
        return tuple(torch.from_numpy(array).to(device) for array in (k_np, np.log(k_np), w8_np))

    def fn(omega_cdm, omega_b, h, n_s, logA):
        k, lnk, w8 = grids(omega_cdm.device)
        cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s, logA=logA, engine='native')
        th = cosmo.get_thermodynamics().table
        pkz = linear_pk(cosmo.engine._perturbation_params(), th, k, z, n_steps=n_steps)['pk_m']
        sigma8 = torch.sqrt(simpson(pkz[:, iz0] * w8, x=lnk) / (2.0 * np.pi ** 2))
        return pkz, sigma8

    return fn, k_np
