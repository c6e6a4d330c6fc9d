"""Fiducial cosmologies (cosmoprimo_tpu/fiducial.py): DESI / AbacusSummit,
Planck 2018, BOSS, Uchuu, the DESI DR2 w0waCDM best fit and the tabulated
DESI background.

The AbacusSummit parameter table (``data/abacus_cosmologies.csv``, the
published AbacusSummit table) and the DESI background table
(``data/desi.dat``) are the port's own, byte-identical copies of the JAX
package's files.
Every factory takes ``device``; by default the cosmology is built on the
CUDA card (see :class:`~cosmoprimo_tpu_torch.cosmology.Cosmology`).
"""

import csv
import os
import re

import numpy as np
import torch

from . import constants
from .cosmology import Cosmology, get_engine

_dir_data = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')


def Uchuu(name='Planck2015', engine=None, extra_params=None, device=None, **params):
    """Cosmology for the Uchuu simulations ('Planck2015', 'Planck2018',
    'Planck2018DDE', 'DESIY1DDE')."""
    common = dict(Omega_k=0., m_ncdm=[0.06], neutrino_hierarchy=None,
                  T_ncdm_over_cmb=constants.TNCDM_OVER_CMB, N_eff=constants.NEFF, A_L=1.0, k_pivot=0.05)
    if name == 'Planck2015':
        default_params = dict(h=0.6774, Omega_m=0.3089, Omega_b=0.0486, sigma8=0.8159, n_s=0.9667, tau_reio=0.063, **common)
    elif name == 'Planck2018':
        default_params = dict(h=0.6766, Omega_m=0.3111, Omega_b=0.048975, sigma8=0.8102, n_s=0.9665, tau_reio=0.063, **common)
    elif name == 'Planck2018DDE':
        default_params = dict(h=0.6766, Omega_m=0.3111, Omega_b=0.048975, sigma8=0.8102, n_s=0.9665, tau_reio=0.063,
                              w0_fld=-0.45, wa_fld=-1.79, **common)
    elif name == 'DESIY1DDE':
        default_params = dict(h=0.6470, Omega_m=0.3440, Omega_b=0.048975, sigma8=0.8102, n_s=0.9665, tau_reio=0.063,
                              w0_fld=-0.45, wa_fld=-1.79, **common)
    else:
        raise NotImplementedError(f'Uchuu cosmology {name} not implemented '
                                  '(available: Planck2015, Planck2018, Planck2018DDE, DESIY1DDE)')
    return Cosmology(engine=engine, extra_params=extra_params, device=device, **default_params).clone(**params)


def Planck2018FullFlatLCDM(engine=None, extra_params=None, device=None, **params):
    """Planck 2018 TT,TE,EE+lowE+lensing+BAO flat LCDM."""
    default_params = dict(h=0.6766, omega_cdm=0.11933, omega_b=0.02242, Omega_k=0., sigma8=0.8102, k_pivot=0.05,
                          n_s=0.9665, m_ncdm=[0.06], neutrino_hierarchy=None,
                          T_ncdm_over_cmb=constants.TNCDM_OVER_CMB, N_eff=constants.NEFF,
                          tau_reio=0.0561, A_L=1.0, w0_fld=-1., wa_fld=0.)
    return Cosmology(engine=engine, extra_params=extra_params, device=device, **default_params).clone(**params)


def BOSS(engine=None, extra_params=None, device=None, **params):
    """BOSS fiducial cosmology (arXiv:1607.03155)."""
    default_params = dict(h=0.676, Omega_m=0.31, omega_b=0.022, Omega_k=0., sigma8=0.8, k_pivot=0.05, n_s=0.97,
                          m_ncdm=[0.06], neutrino_hierarchy=None,
                          T_ncdm_over_cmb=constants.TNCDM_OVER_CMB, N_eff=constants.NEFF,
                          A_L=1.0, w0_fld=-1., wa_fld=0.)
    return Cosmology(engine=engine, extra_params=extra_params, device=device, **default_params).clone(**params)


_AbacusSummit_params_filename = os.path.join(_dir_data, 'abacus_cosmologies.csv')


def AbacusSummit_params(name=None, filename=_AbacusSummit_params_filename, params=None):
    """AbacusSummit cosmological parameters from the CSV table
    (https://github.com/abacusorg/AbacusSummit/tree/master/Cosmologies).

    ``name`` is the cosmology number (e.g. 0 or '000'); None returns all."""
    if name is not None and not isinstance(name, str):
        name = '{:03d}'.format(name)
    if params is None:
        params = ['omega_b', 'omega_cdm', 'h', 'A_s', 'n_s', 'alpha_s', 'N_ur', 'omega_ncdm',
                  'omega_k', 'tau_reio', 'w0_fld', 'wa_fld']
    decode = {'root': str, 'notes': str, 'N_ncdm': int}
    default = {'tau_reio': 0.0544, 'omega_k': 0.}
    params = list(params)
    for param in list(default):
        if param in params:
            params.remove(param)  # provided by the defaults, not the csv
        else:
            default.pop(param)

    results = []
    with open(filename) as file:
        for iline, line in enumerate(csv.reader(file, delimiter=',')):
            line = [el.strip() for el in line]
            if iline == 0:
                iparams = [line.index(param) for param in params]
                iroot = line.index('root')
                incdm = line.index('N_ncdm')
                continue
            entry = dict(default)
            ncdm = int(line[incdm])
            for ii, param in zip(iparams, params):
                value = decode.get(param, eval)(line[ii])
                if param == 'omega_ncdm' and not ncdm:
                    value = tuple()
                entry[param] = value
            if name is not None:
                if re.match('[^0-9]*{}$'.format(name), line[iroot]):
                    return entry
            else:
                results.append(entry)
    if name is not None:
        raise ValueError(f'AbacusSummit cosmology {name} not found')
    return results


def AbacusSummit(name=0, engine=None, precision=None, extra_params=None, device=None, **params):
    """Cosmology with AbacusSummit parameters (cosmology ``name``).

    The N_ur specification is recast into N_eff so that changes in m_ncdm
    stay continuous. ``precision`` ('base': CLASS precision settings) is
    taken and not used, as in the JAX package.
    """
    default_params = dict(k_pivot=0.05, neutrino_hierarchy=None, T_ncdm_over_cmb=constants.TNCDM_OVER_CMB, A_L=1.0)
    default_params.update(AbacusSummit_params(name=name))
    engine_cls = get_engine(engine) if engine is not None else None
    cosmo = Cosmology(engine=engine_cls, extra_params=dict(extra_params or {}), device=device, **default_params)
    cosmo = cosmo.clone(base='input', N_eff=cosmo['N_eff'])
    return cosmo.clone(**params)


def AbacusSummitBase(engine=None, precision=None, extra_params=None, device=None, **params):
    """Base AbacusSummit cosmology (Planck 2018 base_plikHM_TTTEEE_lowl_lowE_lensing mean)."""
    return AbacusSummit(name='000', engine=engine, precision=precision, extra_params=extra_params, device=device,
                        **params)


DESI = AbacusSummitBase


_DESI_filename = os.path.join(_dir_data, 'desi.dat')


def TabulatedDESI(device=None):
    """Tabulated DESI background (z in [0, 100], relative interpolation
    precision 1e-7 against the CLASS computation that made the table), read
    in place from the JAX package's data folder."""
    return DESI(engine='tabulated', extra_params={'filename': _DESI_filename,
                                                  'names': ['efunc', 'comoving_radial_distance']}, device=device)


def save_TabulatedDESI(engine=None, device=None):
    """Write :func:`TabulatedDESI`'s table to ``_DESI_filename``: z,
    efunc(z) and comoving_radial_distance(z) at z = [0] + logspace(-8, 2,
    40001), from the DESI fiducial's background with ``engine`` (by default
    'eisenstein_hu', whose background is closed form; cosmoprimo made the
    shipped table with CLASS)."""
    cosmo = DESI(engine=engine if engine is not None else 'eisenstein_hu', device=device)
    z = np.concatenate([[0], np.logspace(-8, 2, 40001)], axis=0)
    zz = torch.from_numpy(z).to(cosmo.device)
    array = np.array([z, cosmo.efunc(zz).cpu().numpy(), cosmo.comoving_radial_distance(zz).cpu().numpy()]).T
    header = 'z = [0] + np.logspace(-8, 2, 40001)\nz efunc(z) comoving_radial_distance(z) [Mpc/h]'
    np.savetxt(_DESI_filename, array, fmt='%.18e', header=header, comments='# ')


def DESIDR2Flatw0waCDM(engine=None, precision=None, extra_params=None, device=None, **params):
    """Best-fit flat w0waCDM from CMB + DESI BAO DR2 + DESY5 (arXiv:2503.14738)."""
    bestfit_params = {'Omega_m': 0.3191980194, 'omega_b': 0.02221485621, 'H0': 66.73428704,
                      'logA': 3.038847745, 'n_s': 0.9644215278, 'tau_reio': 0.05271118001,
                      'w0_fld': -0.7536302620, 'wa_fld': -0.8574714585}
    cosmo = AbacusSummit(engine=engine, precision=precision, extra_params=extra_params, device=device,
                         **bestfit_params)
    return cosmo.clone(**params)
