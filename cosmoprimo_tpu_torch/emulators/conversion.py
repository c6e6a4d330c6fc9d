"""Converters from public pretrained-emulator weight formats (jaxcapse /
jaxmapse / cosmopower) into an :class:`Emulator` of the port
(cosmoprimo_tpu/emulators/conversion.py). They read the foreign weight
files from a LOCAL directory (nothing is downloaded) and emit an Emulator
whose engines are serialized Operation chains: the on-disk schema of the
JAX package and of the reference, so a file converted by any of them loads
in all. Numpy only.
"""

import glob
import json
from pathlib import Path

import numpy as np

from .base import Emulator, find_names
from .operations import Operation


# ----------------------------------------------------------------------------
# jaxace family (jaxcapse Cls / jaxmapse Pk)
# ----------------------------------------------------------------------------

def _jaxace_load_emulator_files(path):
    path = Path(path)
    weights = np.load(path / 'weights.npy')
    inminmax = np.load(path / 'nminmax.npy')
    outminmax = np.load(path / 'outminmax.npy')
    with open(path / 'nn_setup.json') as f:
        nn_dict = json.load(f)
    return nn_dict, weights, inminmax, outminmax


def _jaxace_unpack_layers_operations(nn_dict, weights):
    """Unpack the flat Fortran-order weight vector into Operation chains."""
    n_input = nn_dict['n_input_features']
    n_output = nn_dict['n_output_features']
    hidden = [v['n_neurons'] for v in nn_dict['layers'].values()]
    sizes = [n_input] + hidden + [n_output]
    operations, offset = [], 0
    for i in range(len(sizes) - 1):
        n_in, n_out = sizes[i], sizes[i + 1]
        W = weights[offset: offset + n_in * n_out].reshape(n_out, n_in, order='F')
        offset += n_in * n_out
        b = weights[offset: offset + n_out]
        offset += n_out
        operations.append(Operation('kernel @ v + bias', locals={'kernel': W, 'bias': b}))
        if i < len(sizes) - 2:
            activation = nn_dict['layers'][f'layer_{i + 1}']['activation_function']
            if activation == 'silu':
                operations.append(Operation('v / (1 + jnp.exp(-v))', locals={}))
            elif activation == 'relu':
                operations.append(Operation('jnp.maximum(v, 0.)', locals={}))
            elif activation == 'tanh':
                operations.append(Operation('jnp.tanh(v)', locals={}))
            else:
                raise ValueError(f'unknown activation {activation}')
    return operations


def convert_jaxcapse_to_cosmoprimo(fn, params=None, include_quantities=None):
    """Convert a jaxcapse (Capse.jl export) Cl-emulator directory."""
    fn = Path(fn)
    conversion = {}
    for name in ['tt', 'te', 'ee', 'bb']:
        conversion[f'harmonic.lensed_cl.{name}'] = name.upper()
    conversion['harmonic.lens_potential_cl.pp'] = 'PP'

    quantities = [q for q in conversion if glob.glob(str(fn / conversion[q]))]
    if include_quantities is not None:
        quantities = find_names(quantities, include_quantities)
    if params is None:
        params = ['logA', 'n_s', 'H0', 'omega_b', 'omega_cdm', 'tau_reio']

    state = {'engines': {}, 'xoperations': [], 'yoperations': [], 'defaults': {}, 'fixed': {}}
    for quantity in quantities:
        nn_dict, weights, inminmax, outminmax = _jaxace_load_emulator_files(fn / conversion[quantity])
        model_operations = _jaxace_unpack_layers_operations(nn_dict, weights)
        xoperations = [Operation('(v - limits[0]) / (limits[1] - limits[0])',
                                 locals={'limits': np.asarray(inminmax.T)})]
        limits = np.asarray(outminmax.T)
        ells = np.arange(outminmax.shape[0] + 2)
        # remove muK^2 and the ell (ell+1) / 2pi normalization
        TCMB = 2.7255
        CMB_unit = TCMB * 1e6
        ells2 = (ells * (ells + 1))[2:]
        if 'lens_potential' in quantity:
            limits = limits / (ells2 ** 2 / (2.0 * np.pi))
        else:
            limits = limits / (CMB_unit ** 2 * (ells2 / (2.0 * np.pi)))
        yoperations = [
            Operation("v / jnp.exp(X['logA'] - 3.)", inverse="v * jnp.exp(X['logA'] - 3.)"),
            Operation('((v - limits[0]) / (limits[1] - limits[0]))[:2]',
                      inverse='jnp.concatenate([jnp.zeros(2), v * (limits[1] - limits[0]) + limits[0]])',
                      locals={'limits': limits}),
        ]
        state['engines'][quantity] = {
            'name': 'mlp', 'params': params, 'xshape': (len(params),), 'yshape': (outminmax.shape[0],),
            'attrs': {},
            'xoperations': [op.__getstate__() for op in xoperations],
            'yoperations': [op.__getstate__() for op in yoperations],
            'model_operations': [op.__getstate__() for op in model_operations],
            'model_yoperations': []}
        state['fixed']['.'.join(quantity.split('.')[:2]) + '.ell'] = ells
    return Emulator.from_state(state)


def convert_jaxmapse_to_cosmoprimo(fn, params=None, include_quantities=None):
    """Convert a jaxmapse Pk-emulator directory."""
    fn = Path(fn)
    conversion = {'fourier.pk.delta_cb.delta_cb': 'plin',
                  'fourier.pknow.delta_cb.delta_cb': 'pnw'}
    quantities = [q for q in conversion if glob.glob(str(fn / conversion[q]))]
    if include_quantities is not None:
        quantities = find_names(quantities, include_quantities)
    if params is None:
        params = ['logA', 'n_s', 'H0', 'omega_b', 'omega_cdm']

    state = {'engines': {}, 'xoperations': [], 'yoperations': [], 'defaults': {}, 'fixed': {}}
    for quantity in quantities:
        nn_dict, weights, inminmax, outminmax = _jaxace_load_emulator_files(fn / conversion[quantity])
        model_operations = _jaxace_unpack_layers_operations(nn_dict, weights)
        xoperations = [Operation('(v - limits[0]) / (limits[1] - limits[0])',
                                 locals={'limits': np.asarray(inminmax.T)})]
        limits = np.asarray(outminmax.T)
        yoperations = [Operation('(v - limits[0]) / (limits[1] - limits[0])',
                                 inverse='v * (limits[1] - limits[0]) + limits[0]', locals={'limits': limits})]
        state['engines'][quantity] = {
            'name': 'mlp', 'params': params, 'xshape': (len(params),), 'yshape': (outminmax.shape[0],),
            'attrs': {},
            'xoperations': [op.__getstate__() for op in xoperations],
            'yoperations': [op.__getstate__() for op in yoperations],
            'model_operations': [op.__getstate__() for op in model_operations],
            'model_yoperations': []}
        kfile = fn / conversion[quantity] / 'k.npy'
        if kfile.exists():
            state['fixed']['fourier.k'] = np.load(kfile)
    return Emulator.from_state(state)


# ----------------------------------------------------------------------------
# cosmopower (.npz networks)
# ----------------------------------------------------------------------------

def _cosmopower_operations(fpz):
    """Operation chain from a cosmopower .npz network dump."""
    operations = []
    nlayers = int(fpz['n_layers'])
    kernels = fpz['weights_'] if 'weights_' in fpz else [fpz[f'W_{i}'] for i in range(nlayers)]
    biases = fpz['biases_'] if 'biases_' in fpz else [fpz[f'b_{i}'] for i in range(nlayers)]
    alphas = fpz.get('alphas_', [fpz.get(f'alphas_{i}') for i in range(nlayers - 1)])
    betas = fpz.get('betas_', [fpz.get(f'betas_{i}') for i in range(nlayers - 1)])
    for ilayer in range(nlayers):
        operations.append(Operation('v @ kernel + bias',
                                    locals={'kernel': np.asarray(kernels[ilayer]), 'bias': np.asarray(biases[ilayer])}))
        if ilayer < nlayers - 1:
            operations.append(Operation('(beta + (1 - beta) / (1 + jnp.exp(-alpha * v))) * v',
                                        locals={'alpha': np.asarray(alphas[ilayer]), 'beta': np.asarray(betas[ilayer])}))
    return operations


def convert_cosmopower_to_cosmoprimo(fn, quantity='harmonic.lensed_cl.tt', params=None, log10_output=True):
    """Convert a single cosmopower .npz network into an Emulator.

    cosmopower standardizes inputs by (mean, std) and typically predicts
    log10 spectra; ``log10_output`` applies the 10** inverse.
    """
    fpz = dict(np.load(str(fn), allow_pickle=True))
    fpz = {key: (value[()] if getattr(value, 'ndim', 1) == 0 else value) for key, value in fpz.items()}
    operations = _cosmopower_operations(fpz)
    if params is None:
        params = [str(p) for p in np.atleast_1d(fpz.get('parameters_', fpz.get('parameters', [])))] or \
                 ['omega_b', 'omega_cdm', 'h', 'tau_reio', 'n_s', 'logA']
    xoperations = []
    if 'param_train_mean' in fpz:
        xoperations.append(Operation('(v - mean) / sigma', inverse='v * sigma + mean',
                                     locals={'mean': np.asarray(fpz['param_train_mean']),
                                             'sigma': np.asarray(fpz['param_train_std'])}))
    yoperations = []
    if 'feature_train_mean' in fpz:
        yoperations.append(Operation('(v - mean) / sigma', inverse='v * sigma + mean',
                                     locals={'mean': np.asarray(fpz['feature_train_mean']),
                                             'sigma': np.asarray(fpz['feature_train_std'])}))
    if log10_output:
        yoperations.insert(0, Operation('jnp.log10(v)', inverse='10**v'))
    yshape = None
    for op in operations[::-1]:
        if 'bias' in op.locals:
            yshape = (np.asarray(op.locals['bias']).shape[-1],)
            break
    state = {'engines': {quantity: {'name': 'mlp', 'params': list(params), 'xshape': (len(params),),
                                    'yshape': yshape, 'attrs': {},
                                    'xoperations': [op.__getstate__() for op in xoperations],
                                    'yoperations': [op.__getstate__() for op in yoperations],
                                    'model_operations': [op.__getstate__() for op in operations],
                                    'model_yoperations': []}},
             'xoperations': [], 'yoperations': [], 'defaults': {}, 'fixed': {}}
    if 'modes' in fpz:
        namespace = '.'.join(quantity.split('.')[:2])
        key = 'ell' if 'harmonic' in quantity else 'k'
        state['fixed'][f'{namespace}.{key}'] = np.asarray(fpz['modes'])
    return Emulator.from_state(state)


# ----------------------------------------------------------------------------
# cosmopower release directories (bolliet2023 'v1' / jense2024 'v2')
# ----------------------------------------------------------------------------

# packed derived-parameter vectors served by the release networks
# (reference conversion.py:248-256): index of each thermodynamics quantity
_COSMOPOWER_DERIVED_INDEX = {
    # v1: theta_s_100, sigma8, Y_p, z_reio, Neff, taurec, z_rec, rs_rec,
    #     ra_rec, tau_star, z_star, rs_star, ra_star, r_drag
    '1': {'thermodynamics.z_star': 10, 'thermodynamics.rs_star': 11,
          'thermodynamics.z_drag': 12, 'thermodynamics.rs_drag': 13},
    # v2: thetastar, sigma8, YHe, zrei, taurend, zstar, rstar, zdrag,
    #     rdrag, N_eff
    '2': {'thermodynamics.z_star': 5, 'thermodynamics.rs_star': 6,
          'thermodynamics.z_drag': 7, 'thermodynamics.rs_drag': 8},
}


def _cosmopower_quantity_glob(fn, quantity, version):
    """Path glob of the network file serving ``quantity`` in a cosmopower
    release directory (reference conversion.py:197-234 layout conventions)."""
    fn = Path(fn)
    if version == '2':
        names = {'harmonic.lensed_cl.tt': 'Cl_tt', 'harmonic.lensed_cl.te': 'Cl_te',
                 'harmonic.lensed_cl.ee': 'Cl_ee', 'harmonic.lensed_cl.bb': 'Cl_bb',
                 'harmonic.lens_potential_cl.pp': 'Cl_pp',
                 'fourier.pk.delta_m.delta_m': 'Pk_lin', 'thermodynamics.all': 'derived'}
        return str(fn / 'networks' / f'*{names[quantity]}*.npz')
    names = {'harmonic.lensed_cl.tt': 'TT_', 'harmonic.lensed_cl.te': 'TE_',
             'harmonic.lensed_cl.ee': 'EE_', 'harmonic.lensed_cl.bb': 'BB_',
             'harmonic.lens_potential_cl.pp': 'PP_',
             'fourier.pk.delta_m.delta_m': 'PKL_', 'thermodynamics.all': 'DER_'}
    if 'lens_potential' in quantity:
        folder = 'PP'
    elif 'harmonic' in quantity:
        folder = 'TTTEEE'
    elif 'fourier' in quantity:
        folder = 'PK'
    else:
        folder = 'derived-parameters'
    return str(fn / folder / f'*{names[quantity]}*.npz')


def _rename_cosmopower_param(param):
    """Foreign parameter spellings -> this framework's canonical names."""
    from ..cosmology import ALIASES
    conversion = {'m_ncdm': 'm_ncdm_tot', 'z_pk_save_nonclass': 'z'}
    toret = str(param)
    for rename, aliases in ALIASES.items():
        if toret == rename or toret in aliases:
            toret = rename
            break
    return conversion.get(toret, toret)


def convert_cosmopower_release_to_cosmoprimo(fn, version=None, include_quantities=None):
    """Convert a full cosmopower release directory — the
    cosmopower_bolliet2023_* ('v1') or cosmopower_jense2024_* ('v2')
    family — into one served Emulator (reference conversion.py:161-341).

    Per network: x standardization from (mean, mean + std) with H0 -> h,
    the cosmopower dense + custom-sigmoid model chain, log10 feature maps
    (tt/ee/pp Cls, Pk, v1 derived), the ell (ell + 1)/2pi Cl normalization
    with the ell = 0, 1 rows re-inserted, and the packed-derived /
    Mpc-to-Mpc/h conversions as typed dict operations
    (SplitDerivedOperation, FourierUnitOperation) instead of the
    reference's exec-string operations, which our expression sandbox
    rejects by design.
    """
    fn = Path(fn)
    if version is None:
        version = '2' if 'jense' in str(fn) else '1'
    version = str(version)

    quantities = [q for q in ['harmonic.lensed_cl.tt', 'harmonic.lensed_cl.te',
                              'harmonic.lensed_cl.ee', 'harmonic.lensed_cl.bb',
                              'harmonic.lens_potential_cl.pp',
                              'fourier.pk.delta_m.delta_m', 'thermodynamics.all']
                  if glob.glob(_cosmopower_quantity_glob(fn, q, version))]
    if include_quantities is not None:
        quantities = find_names(quantities, include_quantities)
    if not quantities:
        raise ValueError(f'no cosmopower networks found under {fn} (version {version})')

    state = {'engines': {}, 'xoperations': [], 'yoperations': [], 'defaults': {}, 'fixed': {}}
    from .operations import FourierUnitOperation, SplitDerivedOperation
    if any('thermodynamics' in q for q in quantities):
        state['yoperations'].append(SplitDerivedOperation(
            conversion=_COSMOPOWER_DERIVED_INDEX[version]))
    if any('fourier' in q for q in quantities):
        state['yoperations'].append(FourierUnitOperation(pk_h3=(version == '1')))
        # baryonic-feedback inputs the release networks were trained with
        state['defaults'] = {'A_b': 3.0, 'eta_b': 0.75, 'logT_AGN': 7.8}

    if version == '2':
        k_fourier = np.geomspace(5e-5, 50.0, 1000)
    else:
        k_fourier = np.geomspace(1e-4, 50.0, 5000)[::10]

    for quantity in quantities:
        ff = glob.glob(_cosmopower_quantity_glob(fn, quantity, version))
        if len(ff) != 1:
            raise ValueError(f'could not resolve a unique network for {quantity}: {ff}')
        fpz = np.load(ff[0], allow_pickle=True)
        if version == '1':
            fpz = fpz['arr_0'].flatten()[0]
        fpz = dict(fpz)
        fpz = {key: (value[()] if getattr(value, 'ndim', 1) == 0 else value)
               for key, value in fpz.items()}

        params = [_rename_cosmopower_param(p) for p in np.atleast_1d(fpz['parameters'])]
        mean = np.asarray(fpz.get('parameters_mean', fpz.get('param_train_mean')))
        std = np.asarray(fpz.get('parameters_std', fpz.get('param_train_std')))
        limits = np.array([mean, mean + std])
        if 'H0' in params:
            idx = params.index('H0')
            params[idx] = 'h'
            limits[:, idx] /= 100.0
        xoperations = [Operation('(v - limits[0]) / (limits[1] - limits[0])',
                                 inverse='v * (limits[1] - limits[0]) + limits[0]',
                                 locals={'limits': limits})]

        mean = np.asarray(fpz.get('features_mean', fpz.get('feature_train_mean')))
        std = np.asarray(fpz.get('features_std', fpz.get('feature_train_std')))
        limits = np.array([mean, mean + std])
        model_operations = _cosmopower_operations(fpz)
        model_yoperations = []
        if 'pca_mean' in fpz:
            model_yoperations.append(Operation(
                '(v @ matrix.T - mean) / std', inverse='(v * std + mean) @ matrix',
                locals={'mean': np.asarray(fpz['pca_mean']), 'std': np.asarray(fpz['pca_std']),
                        'matrix': np.asarray(fpz['pca_transform_matrix'])}))
        yoperations = [Operation('(v - limits[0]) / (limits[1] - limits[0])',
                                 inverse='v * (limits[1] - limits[0]) + limits[0]',
                                 locals={'limits': limits})]

        if 'harmonic' in quantity:
            if any(name in quantity for name in ['tt', 'ee', 'pp']):
                yoperations.insert(0, Operation('jnp.log10(v)', inverse='10**v'))
            ells = np.arange(limits[0].size + 2)
            ells2 = (ells * (ells + 1))[2:]
            factor = ells2 ** 2 / (2.0 * np.pi) if 'lens_potential' in quantity \
                else ells2 / (2.0 * np.pi)
            yoperations.insert(0, Operation(
                '(v * factor)[2:]',
                inverse='jnp.concatenate([jnp.zeros(2), v / factor])',
                locals={'factor': factor}))
            state['fixed']['.'.join(quantity.split('.')[:2]) + '.ell'] = ells
        if 'thermodynamics' in quantity and version == '1':
            yoperations.insert(0, Operation('jnp.log10(v)', inverse='10**v'))
        if 'fourier.pk' in quantity:
            yoperations.insert(0, Operation('jnp.log10(v)', inverse='10**v'))
            state['fixed']['fourier.k'] = k_fourier

        state['engines'][quantity] = {
            'name': 'mlp', 'params': params, 'xshape': (len(params),),
            'yshape': (limits[0].size,), 'attrs': {},
            'xoperations': [op.__getstate__() for op in xoperations],
            'yoperations': [op.__getstate__() for op in yoperations],
            'model_operations': [op.__getstate__() for op in model_operations],
            'model_yoperations': [op.__getstate__() for op in model_yoperations]}
    state['yoperations'] = [op.__getstate__() for op in state['yoperations']]
    return Emulator.from_state(state)
