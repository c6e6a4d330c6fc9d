"""cosmosis module interface over the port's Cosmology
(cosmoprimo_tpu/bindings/cosmosis/cosmoprimo_tpu_interface.py): setup and
execute write background distances, linear and non-linear P(k), growth and
CMB Cls into the datablock, with the JAX package's options, input-parameter
names and datablock sections.

The cosmology computes on the CUDA card unless the ``device`` option says
otherwise (e.g. ``device = cpu``); the datablock gets numpy arrays. Requires
``cosmosis``; the math is testable with a stub.
"""

import sys
import traceback
import warnings

import numpy as np
import torch


def _np(value):
    """A tensor (on any device) or array as a numpy array on the host."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def setup(options):
    """Read chain-constant options, including the ``cosmoprimo_*``
    passthrough namespace and the ``device`` ('' for the CUDA card)."""
    from cosmoprimo_tpu_torch import Cosmology
    try:
        from cosmosis.datablock import option_section
        config = {'zmin': options.get_double(option_section, 'zmin', default=0.0),
                  'zmax': options.get_double(option_section, 'zmax', default=3.01),
                  'nz': options.get_int(option_section, 'nz', default=150),
                  'lmax': options.get_int(option_section, 'lmax', default=2000),
                  'kmax': options.get_double(option_section, 'kmax', default=50.0),
                  'debug': options.get_bool(option_section, 'debug', default=False),
                  'harmonic': options.get_bool(option_section, 'harmonic', default=False),
                  'lensing': options.get_bool(option_section, 'lensing', default=True),
                  'fourier': options.get_bool(option_section, 'fourier', default=False),
                  'nonlinear': options.get_string(option_section, 'nonlinear', default=''),
                  'engine': options.get_string(option_section, 'engine', default='eisenstein_hu'),
                  'device': options.get_string(option_section, 'device', default='')}
        if hasattr(options, 'keys'):
            try:
                for _, key in options.keys(option_section):
                    if key.startswith('cosmoprimo_'):
                        config[key] = options[option_section, key]
            except Exception:
                pass
    except ImportError:
        config = {'zmin': 0.0, 'zmax': 3.01, 'nz': 150, 'lmax': 2000, 'kmax': 50.0,
                  'debug': False, 'harmonic': False, 'lensing': True, 'fourier': False,
                  'nonlinear': '', 'engine': 'eisenstein_hu', 'device': ''}
    config['base'] = Cosmology(engine=config['engine'], device=config['device'] or None)
    return config


def get_inputs(block, config):
    """Translate datablock parameters to cosmology inputs: CAMB-style names,
    optional parameters, the neutrinos, the cosmoprimo_* passthrough."""
    from cosmosis.datablock import names
    cp = names.cosmological_parameters

    def get(name, default=None):
        return block[cp, name] if block.has_value(cp, name) else default

    params = {'lensing': config['harmonic'] and config['lensing'],
              'non_linear': config['nonlinear']}
    # mandatory-with-fallback core parameters
    for our, cos, default in [('h', 'h0', 0.7), ('omega_b', 'ombh2', None), ('omega_cdm', 'omch2', None),
                              ('Omega_b', 'omega_b', None), ('Omega_cdm', 'omega_c', None),
                              ('Omega_k', 'omega_k', None), ('A_s', 'a_s', None), ('sigma8', 'sigma_8', None),
                              ('n_s', 'n_s', None), ('tau_reio', 'tau', None), ('T_cmb', 'tcmb', None),
                              ('N_eff', 'nnu', None)]:
        value = get(cos, default)
        if value is not None:
            params[our] = value
    # neutrinos: cosmosis 'mnu' is the TOTAL mass (CAMB convention), split
    # over the species
    nmassive = get('num_massive_neutrinos')
    m_ncdm = get('mnu', 0.06)
    if nmassive is None or nmassive == 3:
        hierarchy = get('neutrino_hierarchy')
        if hierarchy is not None:
            params['neutrino_hierarchy'] = hierarchy
        params['m_ncdm'] = m_ncdm
    else:
        params['m_ncdm'] = [m_ncdm / int(nmassive)] * int(nmassive)
    # optional parameters
    optional = {'alpha_s': (cp, 'nrun'), 'w0_fld': (cp, 'w'), 'wa_fld': (cp, 'wa'),
                'cs2_fld': (cp, 'cs2_de'), 'A_L': (cp, 'a_lens'),
                'reionization_width': ('reionization', 'delta_redshift'), 'YHe': (cp, 'yhe')}
    for our, cos in optional.items():
        if block.has_value(*cos):
            params[our] = block[cos]
    if config['harmonic']:
        params['ellmax_cl'] = config['lmax']
    if config['fourier']:
        params['z_pk'] = np.linspace(config['zmin'], config['zmax'], config['nz'])
        params['kmax_pk'] = config['kmax']
    if block.has_value(cp, 'massless_nu'):
        warnings.warn('massless_nu is ignored; set nnu instead')
    # cosmoprimo_* passthrough
    for key, value in config.items():
        if key.startswith('cosmoprimo_'):
            params[key[len('cosmoprimo_'):]] = value
    return params


def get_outputs(block, cosmo, config):
    """Write the datablock products, as numpy arrays."""
    from cosmosis.datablock import names
    ba = cosmo.get_background()
    h = float(cosmo['h'])

    if config['harmonic']:
        hr = cosmo.get_harmonic()
        cl = hr.lensed_cl() if config['lensing'] else hr.unlensed_cl()
        ell = np.asarray(cl['ell'])[2:]
        block[names.cmb_cl, 'ell'] = ell
        tcmb_muk = float(cosmo['T_cmb']) * 1e6
        factor = ell * (ell + 1.0) / 2 / np.pi * tcmb_muk ** 2
        for s in ['tt', 'ee', 'te', 'bb']:
            if s in cl:
                block[names.cmb_cl, s] = _np(cl[s])[2:] * factor

    if config['fourier']:
        fo = cosmo.get_fourier()
        z = np.asarray(cosmo['z_pk'])
        for section_name, of in [('matter_power_lin', 'delta_m'), ('cdm_baryon_power_lin', 'delta_cb')]:
            try:
                pk = fo.pk_interpolator(of=of)
            except Exception:
                continue  # engine without a distinct cb field
            block.put_grid(section_name, 'k_h', np.asarray(pk.k), 'z', np.asarray(pk.z),
                           'p_k', _np(pk(pk.k, pk.z)).T)
        if config['nonlinear']:
            pk_nl = fo.pk_interpolator(of='delta_m', non_linear=True)
            block.put_grid('matter_power_nl', 'k_h', np.asarray(pk_nl.k), 'z', np.asarray(pk_nl.z),
                           'p_k', _np(pk_nl(pk_nl.k, pk_nl.z)).T)
        # growth rates and sigma_8 variants
        sigma_8_m = _np(fo.sigma8_z(z, of='delta_m'))
        sigma_8_cb = _np(fo.sigma8_z(z, of='delta_cb'))
        fsigma_8_cb = _np(fo.sigma8_z(z, of='theta_cb'))
        sigma_8_m0 = float(fo.sigma8_z(0.0, of='delta_m'))
        gr = names.growth_parameters
        block[gr, 'z'] = z
        block[gr, 'a'] = 1.0 / (1.0 + z)
        block[gr, 'sigma_8'] = sigma_8_m
        block[gr, 'fsigma_8'] = fsigma_8_cb
        block[gr, 'd_z'] = sigma_8_m / sigma_8_m0
        block[gr, 'f_z'] = fsigma_8_cb / sigma_8_cb
        cp = names.cosmological_parameters
        block[cp, 'sigma_8'] = sigma_8_m0
        block[cp, 'sigma_12'] = float(fo.sigma_rz(12.0 / h, 0.0, of='delta_m'))
        block[cp, 'S_8'] = sigma_8_m0 * np.sqrt(float(cosmo['Omega_m']) / 0.3)

    # distances on the config grid
    step = 0.01
    z = np.arange(config['zmin'], config['zmax'] + step, step)
    dist = names.distances
    block[dist, 'z'] = z
    block[dist, 'nz'] = len(z)
    block[dist, 'a'] = 1.0 / (1.0 + z)
    D_L = _np(ba.luminosity_distance(z))
    D_A = _np(ba.angular_diameter_distance(z))
    D_M = D_A * (1 + z)
    D_C = _np(ba.comoving_radial_distance(z))
    H = 100.0 * _np(ba.efunc(z)) / 299792.458  # h/Mpc
    with np.errstate(divide='ignore', invalid='ignore'):
        D_V = (z * D_M ** 2 / H) ** (1.0 / 3.0)
    block[dist, 'd_l'] = D_L / h
    block[dist, 'd_a'] = D_A / h
    block[dist, 'd_m'] = D_M / h
    block[dist, 'd_c'] = D_C / h
    block[dist, 'd_v'] = D_V / h
    block[dist, 'h'] = H * h  # 1/Mpc
    # distance modulus from D_L in Mpc
    MU = np.full_like(D_L, -np.inf)
    mask = D_L > 0
    MU[mask] = 5.0 * np.log10(D_L[mask] / h) + 25.0
    block[dist, 'mu'] = MU
    block[dist, 'age'] = float(ba.age)
    th = cosmo.get_thermodynamics()
    rs_drag = float(th.rs_drag)
    block[dist, 'rs_zdrag'] = rs_drag / h
    with np.errstate(divide='ignore', invalid='ignore'):
        block[dist, 'rs_dv'] = rs_drag / D_V
    block[dist, 'f_ap'] = D_M * H


def execute(block, config):
    from cosmoprimo_tpu_torch import CosmologyError

    try:
        params = get_inputs(block, config)
        cosmo = config['base'].clone(**params)
        get_outputs(block, cosmo, config)
    except CosmologyError as error:
        if config.get('debug'):
            sys.stderr.write('Error in cosmoprimo_tpu_torch; debug traceback:\n')
            traceback.print_exc(file=sys.stderr)
        else:
            sys.stderr.write(f'Error in cosmoprimo_tpu_torch (set debug=T for info): {error}\n')
        return 1
    return 0


def cleanup(config):
    return 0
