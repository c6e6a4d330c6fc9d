"""Emulator toolkit (cosmoprimo_tpu/emulators/): sample a calculator or a
Cosmology (:func:`get_calculator`, the samplers), fit MLP / Taylor / Point
emulators of its outputs (:class:`Emulator`; the MLP on the CUDA card),
and serve them back as an engine ('emulated', and the pretrained 'capse',
'cosmopower_bolliet2023', 'emu_camb_mnu_w_wa_cmb' and
'cosmopower_jense2024' entry points); the operation algebra, the
converters of public weight formats, and the Fourier/Harmonic norm
operations.

Batch-first: a calculator takes each parameter as a (n,) tensor and
returns each output as (n,) + its shape; an emulator predicts a batch of
cosmologies in one call.
"""

from math import comb

import numpy as np
import torch

# Cosmology, PowerSpectrumInterpolator1D, Interpolator1D, setup_logging and
# MLP are re-exported, as the JAX package's namespace does
from ..cosmology import Cosmology
from ..interpolator import PowerSpectrumInterpolator1D
from ..ops import Interpolator1D, cubic_eval_rows, natural_cubic_coeffs_rows
from ..utils import setup_logging
from .base import (BaseEmulatorEngine, Emulator as _BaseEmulator, EmulatedCalculator, PointEmulatorEngine,
                   batch_vmap, find_names, get_engine, make_list)
from .operations import (ArcsinhOperation, ChebyshevOperation, FourierUnitOperation, Log10Operation, NormOperation,
                         Operation, PCAOperation, ScaleOperation, SplitDerivedOperation, _device_of, _per_row,
                         get_operation, register_operation)
from .samples import (BaseSampler as _BaseSampler, CalculatorComputationError, DiffSampler as _DiffSampler,
                      GridSampler as _GridSampler, InputSampler as _InputSampler, QMCSampler as _QMCSampler, Samples)
from .mlp import MLP, MLPEmulatorEngine
from .taylor import TaylorEmulatorEngine
from .emulated import (CAPSEEngine, CambMnuW0WaCMBEngine, CosmopowerBolliet2023Engine, CosmopowerJense2024Engine,
                       EmulatedEngine)


def get_calculator(cosmo, section=None):
    """Turn a Cosmology into a batch-first calculator ``f(**params) ->
    {'<section>.<name>': batch + shape}`` of section states
    ('background.comoving_radial_distance', 'fourier.pk.delta_cb.delta_cb',
    ...), read through the emulated sections' ``__getstate__``, for
    sampling and training; the cosmology's fixed grids ('fourier.k', ...)
    are expanded to the batch. Parameters are tensors of one batch shape
    (or numbers); a CosmologyError becomes a CalculatorComputationError.
    The calculator's ``device`` is the cosmology's. Anything else is
    returned as it is."""
    from ..cosmology import Cosmology, CosmologyError
    from . import emulated

    if not isinstance(cosmo, Cosmology):
        return cosmo

    section_names = make_list(section if section is not None else list(cosmo.engine._Section_classes))
    order = ['harmonic', 'fourier', 'transfer', 'perturbations', 'primordial', 'thermodynamics', 'background']
    section_names = [s for s in order if s in section_names] + [s for s in section_names if s not in order]
    device = cosmo.device

    def calculator(**params):
        toret = {}
        try:
            clone = cosmo.clone(**params)
            batch = clone['h'].shape
            for section_name in section_names:
                section = getattr(clone, f'get_{section_name}')()
                Section = getattr(emulated, section_name.capitalize(), None)
                state = {}
                if Section is not None and hasattr(Section, '__getstate__'):
                    state = Section.__getstate__(section)
                for name, value in state.items():
                    if value is None:
                        continue
                    if not isinstance(value, torch.Tensor):   # a grid shared by the batch
                        value = torch.as_tensor(np.asarray(value), dtype=torch.float64, device=device)
                        value = value.expand(batch + value.shape)
                    toret[f'{section_name}.{name}'] = value
            # the engine and its sections refer to each other: free this call's
            # tables now, not at the collector's next full pass
            clone.engine._sections.clear()
        except CosmologyError as exc:
            raise CalculatorComputationError from exc
        return toret

    calculator.device = device
    return calculator


class Emulator(_BaseEmulator):
    """Emulator accepting a Cosmology directly as calculator."""

    def _classify_calculator(self, calculator, params=None):
        return super()._classify_calculator(get_calculator(calculator), params=params)


class BaseSampler(_BaseSampler):
    def __init__(self, calculator, *args, **kwargs):
        super().__init__(get_calculator(calculator), *args, **kwargs)


class InputSampler(BaseSampler, _InputSampler):
    pass


class GridSampler(BaseSampler, _GridSampler):
    pass


class DiffSampler(BaseSampler, _DiffSampler):
    pass


class QMCSampler(BaseSampler, _QMCSampler):
    pass


def mask_subsample(size, factor=1., seed=42):
    """Boolean mask selecting a random subsample: a fraction if
    ``factor <= 1``, else ``factor`` samples."""
    rng = np.random.RandomState(seed=seed)
    mask = np.zeros(size, dtype='?')
    if factor <= 1.:
        factor = int(factor * size)
    mask[rng.choice(size, int(factor), replace=False)] = True
    return mask


def smoothstep(x, xmin=0, xmax=1, order=1):
    x = np.clip((x - xmin) / (xmax - xmin), 0, 1)
    result = 0
    for n in range(0, order + 1):
        result += comb(order + n, n) * comb(2 * order + 1, order - n) * (-x) ** n
    return result * x ** (order + 1)


def _spline_rows(x, f, t, log=False, assume_sorted=False):
    """The JAX package's ``Interpolator1D(x, f, extrap=True)(t)``, natural
    cubic, in log10 of x and f if ``log``, with the knots ``x``, the values
    ``f`` and the queries ``t`` on their LAST axis and their leading axes
    broadcasting, so that each may be shared or differ by row. Unsorted
    knots are sorted per row, as the JAX interpolator sorts them."""
    if not assume_sorted:
        x, order = torch.sort(x, dim=-1, stable=True)
        shape = torch.broadcast_shapes(x.shape, f.shape)
        f = torch.gather(f.expand(shape), -1, order.expand(shape))
    if log:
        x, t, f = torch.log10(x), torch.log10(t), torch.log10(f)
    out = cubic_eval_rows(x, f, natural_cubic_coeffs_rows(x, f), t)
    return 10 ** out if log else out


def _cosmology(X, engine='bbks'):
    """A cosmology of the parameters ``X`` on ``engine``: input names, or a
    cosmology's compiled parameters (as an emulated engine passes them),
    whose species parameters hold one row per species."""
    from ..cosmology import Cosmology
    params = {name: value for name, value in X.items() if not name.startswith(('Y.', 'X.'))}
    if 'N_ur' in params:
        for name in ('m_ncdm', 'T_ncdm_over_cmb'):
            if isinstance(params.get(name), torch.Tensor):
                params[name] = list(params[name])
    return Cosmology(engine=engine, **params)


@register_operation
class HarmonicNormOperation(Operation):
    """theta*-rescaled ell-warping of Cls divided by A_s: factorizes the
    acoustic-scale dependence out of the emulated spectra.

    Batch-first: ``X``'s values have the batch shape, each Cl of ``v``
    leads with it; every row has its own warped ell grid (per-row splines,
    :func:`_spline_rows`)."""

    name = 'harmonic_norm'
    _tensor_attrs = ('ells', 'wells', 'windows')

    def __init__(self, ref_theta_cosmomc=0.010409108133982346):  # DESI fiducial
        self.ref_theta_cosmomc = ref_theta_cosmomc
        super().__init__('v')

    def initialize(self, v, **kwargs):
        names = find_names(list(v.keys()), ['harmonic.*_cl.*'])
        self.ells, self.wells, self.windows, self.norm_cl_names = {}, {}, {}, {}
        wsize = 60
        for keyname in names:
            _, name, key = keyname.split('.')
            self.norm_cl_names.setdefault(name, []).append(keyname)
            size = np.shape(v[keyname])[-1]
            self.ells[name] = np.arange(size)
            smooth = smoothstep(np.linspace(0.0, 1.0, wsize), xmin=0.2, xmax=0.8, order=3)
            self.windows[name] = np.concatenate([smooth, np.ones(size - 3 * wsize), smooth[::-1], np.zeros(wsize)])
            self.wells[name] = np.linspace(0.0, size, size)
        self.__dict__.pop('_device_cache', None)

    def _cosmo(self, X):
        return _cosmology(X, engine='bbks')

    def _warp(self, v, X, cosmo):
        """(s, A_s, the cached grids): theta_cosmomc over its reference and
        1e9 A_s, the batch shape. A ``v`` that holds none of the Cls raises
        KeyError before any cosmology is computed."""
        for cl_names in self.norm_cl_names.values():
            for cl_name in cl_names:
                v[cl_name]
        if cosmo is None:
            cosmo = self._cosmo(X)
        s = cosmo['theta_cosmomc'] / self.ref_theta_cosmomc
        return s, 1e9 * cosmo['A_s'], self._on(_device_of(v) or s.device)

    def __call__(self, v, X=None, cosmo=None):
        v = dict(v)
        s, A_s, grids = self._warp(v, X, cosmo)
        for namespace, cl_names in self.norm_cl_names.items():
            ell = grids['ells'][namespace].to(torch.float64)
            elli = grids['wells'][namespace] / (1.0 + grids['windows'][namespace] * s[..., None])
            for cl_name in cl_names:
                v[cl_name] = _spline_rows(ell, v[cl_name] / A_s[..., None], elli, assume_sorted=True)
        return v

    def inverse(self, v, X=None, cosmo=None):
        v = dict(v)
        s, A_s, grids = self._warp(v, X, cosmo)
        for namespace, cl_names in self.norm_cl_names.items():
            ell = grids['wells'][namespace] / (1.0 + grids['windows'][namespace] * s[..., None])
            elli = grids['ells'][namespace].to(torch.float64)
            for cl_name in cl_names:
                v[cl_name] = _spline_rows(ell, v[cl_name] * A_s[..., None], elli)
        return v

    def __getstate__(self):
        return {name: getattr(self, name) for name in
                ['name', 'ells', 'wells', 'windows', 'norm_cl_names', 'ref_theta_cosmomc'] if hasattr(self, name)}

    def __setstate__(self, state):
        self.__dict__.update(state)


@register_operation
class FourierNormOperation(Operation):
    """Divide all power spectra by the reference delta_cb spectrum and
    factorize its z-dependence.

    Batch-first: ``X``'s values have the batch shape, each table of ``v``
    leads with it; 'fourier.k' and 'fourier.z' are one grid, or one per
    row. The log-log splines in k / h differ by row through h
    (:func:`_spline_rows`)."""

    name = 'fourier_norm'

    def __init__(self, ref_pk_name='fourier.pk.delta_cb.delta_cb'):
        self.ref_pk_name = ref_pk_name
        super().__init__('v')

    def initialize(self, v, **kwargs):
        self.norm_pk_names = [name for name in find_names(list(v.keys()), ['fourier.pk.*.*', 'fourier.pk_non_linear.*.*'])
                              if name != self.ref_pk_name]

    def _prim(self, k, z, X):
        """(h, the BBKS linear P(k / h, z[0]) / h^3 of each row): the batch
        shape and batch + (nk,). Each row's P is at its own k / h, so the
        BBKS engine runs under ``torch.func.vmap`` over the rows, one
        cosmology each, as the JAX package runs it."""
        engine = _cosmology(X).engine
        h = engine['h']
        batch, size = h.shape, h.numel()
        rows, dims = {}, {}
        for name, value in engine._params.items():
            if isinstance(value, torch.Tensor) and batch and value.shape[value.dim() - len(batch):] == batch:
                species = value.dim() > len(batch)   # (N_ncdm,) + batch
                rows[name] = value.reshape(value.shape[:1] + (size,) if species else (size,))
                dims[name] = 1 if species else 0
        k_rows = k.dim() > 1
        z0 = z[..., 0]

        def one(params, k, z0):
            row = engine.clone(**params)
            hh = row['h']
            pk = row.get_fourier().pk_interpolator(extrap_kmin=k[0] / 10.0, extrap_kmax=k[-1] * 10.0)
            return pk(k / hh, z0) / hh ** 3

        if not batch:
            return h, one(rows, k, z0)
        flat = lambda t: t.reshape((-1,) + t.shape[len(batch):])   # noqa: E731
        prim = torch.func.vmap(one, in_dims=(dims, 0 if k_rows else None, 0 if z0.dim() else None))(
            rows, flat(k) if k_rows else k, flat(z0) if z0.dim() else z0)
        return h, prim.reshape(batch + prim.shape[1:])

    @staticmethod
    def _loglog(x, f, t, nbatch):
        """``_spline_rows`` in log-log of a table ``f``, batch + (nk,), or
        batch + (nk, nz) (``nbatch`` batch axes), at knots ``x`` and
        queries ``t``, each (nk,) or batch + (nk,); the k axis stays in
        place."""
        if f.dim() == nbatch + 2:
            def expand(a):
                return a if a.dim() == 1 else a[..., None, :]
            return _spline_rows(expand(x), f.movedim(-1, -2), expand(t), log=True).movedim(-1, -2)
        return _spline_rows(x, f, t, log=True)

    def __call__(self, v, X=None, cosmo=None):
        v = dict(v)
        k, z = v['fourier.k'], v['fourier.z']
        h, prim = self._prim(k, z, X)
        q = k / h[..., None]
        for pk_name in [self.ref_pk_name] + self.norm_pk_names:
            # (Mpc/h) -> Mpc units: log-log spline in k with trailing z axes
            value = self._loglog(k, v[pk_name], q, h.dim())
            v[pk_name] = value / _per_row(h, value) ** 3
        pk_dd = v[self.ref_pk_name]
        for pk_name in self.norm_pk_names:
            v[pk_name] = v[pk_name] / pk_dd[..., :v[pk_name].shape[-1]]
        v['fourier.pkz'] = v[self.ref_pk_name] / v[self.ref_pk_name][..., [0]]
        v[self.ref_pk_name] = v[self.ref_pk_name][..., 0] / prim
        return v

    def inverse(self, v, X=None, cosmo=None):
        v = dict(v)
        k, z = v['fourier.k'], v['fourier.z']
        h, prim = self._prim(k, z, X)
        ref = v[self.ref_pk_name] * prim
        pk_dd = v[self.ref_pk_name] = ref[..., None] * v['fourier.pkz']
        for pk_name in self.norm_pk_names:
            v[pk_name] = v[pk_name] * pk_dd[..., :v[pk_name].shape[-1]]
        q = k / h[..., None]
        for pk_name in [self.ref_pk_name] + self.norm_pk_names:
            value = v[pk_name]
            v[pk_name] = self._loglog(q, value * _per_row(h, value) ** 3, k, h.dim())
        return v

    def __getstate__(self):
        return {name: getattr(self, name) for name in ['name', 'ref_pk_name', 'norm_pk_names'] if hasattr(self, name)}

    def __setstate__(self, state):
        self.__dict__.update(state)


__all__ = ['Emulator', 'EmulatedCalculator', 'get_calculator', 'BaseSampler', 'InputSampler', 'GridSampler',
           'DiffSampler', 'QMCSampler', 'BaseEmulatorEngine', 'PointEmulatorEngine', 'MLPEmulatorEngine',
           'TaylorEmulatorEngine', 'Operation', 'ScaleOperation', 'NormOperation', 'Log10Operation',
           'ArcsinhOperation', 'PCAOperation', 'ChebyshevOperation', 'SplitDerivedOperation',
           'FourierUnitOperation', 'HarmonicNormOperation', 'FourierNormOperation', 'Samples',
           'CalculatorComputationError', 'EmulatedEngine', 'CAPSEEngine', 'CosmopowerBolliet2023Engine',
           'CambMnuW0WaCMBEngine', 'CosmopowerJense2024Engine', 'batch_vmap', 'mask_subsample', 'smoothstep',
           'find_names', 'get_engine', 'get_operation', 'make_list', 'register_operation', 'Cosmology', 'MLP',
           'PowerSpectrumInterpolator1D', 'Interpolator1D', 'setup_logging']
