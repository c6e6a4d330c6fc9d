"""The native Einstein-Boltzmann engine (cosmoprimo_tpu/models/native.py),
batched: the recombination history (boltzmann/thermodynamics.py) and the
linear perturbations (boltzmann/perturbations.py) computed on the card, with
no external Boltzmann code.

Sections: Background (the default one), Thermodynamics, Primordial (the
power law with runnings), Perturbations (the per-k Newtonian-gauge series),
Transfer, Harmonic (the line-of-sight CMB spectra, lensed by the
correlation-function method, with the tensor modes when r > 0) and Fourier.
"""

import numpy as np
import torch

from .. import constants
from ..boltzmann import compute_thermodynamics
from ..boltzmann.harmonic import _curvature, compute_cls, shared_kmin
from ..boltzmann.lensing import lensed_cls
from ..boltzmann.perturbations import compute_perturbation_series, linear_pk, steps_for_kmax
from ..boltzmann.tensor import compute_tensor_cls
from ..cosmology import BaseEngine, BaseSection, CosmologyInputError, _compute_rs_cosmomc, register_engine
from ..cosmology import DefaultBackground as Background  # noqa: F401
from ..interpolator import PowerSpectrumInterpolator2D
from ..ops import batch_scalar, interp
from .eisenstein_hu import Primordial  # noqa: F401  (the power law with runnings)

DEFAULT_Z_PK = (0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 5.0, 10.0, 20.0, 49.0)


@register_engine
class NativeEngine(BaseEngine):
    """Engine computing thermodynamics and linear perturbations natively.
    Calculation knobs via ``extra_params``: ``nk_pk`` (default 256
    log-spaced k in [1e-4, kmax_pk] h/Mpc) and ``n_steps_pk`` (the static
    (n_steps_a, n_steps_b, m_tab) budget; default by kmax_pk,
    :func:`~cosmoprimo_tpu_torch.boltzmann.perturbations.steps_for_kmax`);
    for the CMB spectra ``lensing_margin`` (default 400), ``kmax_cl``,
    ``kmax_pp`` and ``ellmax_tensor`` (default 600); for the Perturbations
    section ``k_output_values`` (h/Mpc, default (0.01, 0.1, 1.0))."""

    name = 'native'

    def __init__(self, cosmo, **extra_params):
        super().__init__(cosmo, **extra_params)
        self._A_s = self._get_A_s_fid()
        self._pk_tables = None
        self._unl_cache = self._lens_cache = None

    def _perturbation_params(self):
        """The solver's parameters, each a flat (B,) tensor (``m_ncdm``
        (ns, B)). All species share the first one's T_ncdm. A row whose
        masses sum to 0 (or a batch with no species) gets the JAX package's
        massless setting: one species of mass 0, T_ncdm_over_cmb = 0.71611,
        omega_ncdm = 0, decided per row."""
        def flat(value):
            return value.reshape(-1)

        p = {n: flat(self[n]) for n in ['omega_b', 'omega_cdm', 'h', 'T_cmb', 'N_ur', 'w0_fld', 'wa_fld', 'n_s',
                                        'k_pivot', 'alpha_s', 'beta_s', 'omega_k']}
        p['A_s'] = flat(self._A_s * torch.ones_like(self['h']))
        if self['m_ncdm'].shape[0] == 0:
            zero = torch.zeros_like(p['h'])
            p['m_ncdm'], p['T_ncdm_over_cmb'], p['omega_ncdm'] = zero[None], zero + 0.71611, zero
            return p
        m = self['m_ncdm'].reshape(self['m_ncdm'].shape[0], -1)
        massless = torch.sum(m, dim=0) == 0.0
        p['m_ncdm'] = torch.where(massless, 0.0, m)
        p['T_ncdm_over_cmb'] = torch.where(massless, 0.71611, self['T_ncdm_over_cmb'].reshape(m.shape)[0])
        p['omega_ncdm'] = torch.where(massless, 0.0, torch.sum(self['omega_ncdm'].reshape(m.shape), dim=0))
        return p

    def _kmin(self):
        """The lower end of the k grid [h/Mpc], 1e-4 or, for a closed
        model, 3.2 sqrt(3K)/h above the curvature scale. The 2D interpolator
        takes one k grid, so the rows of a batch must agree on it."""
        h = self['h'].reshape(-1).cpu().numpy()
        omega_k = self['Omega_k'].reshape(-1).cpu().numpy() * h ** 2
        K = -omega_k * (100.0 / (constants.c / 1e3)) ** 2
        kmin = np.where(omega_k < 0.0, np.maximum(1e-4, 3.2 * np.sqrt(np.abs(3.0 * K)) / h), 1e-4)
        if np.any(kmin != kmin[0]):
            raise NotImplementedError('closed models need a k grid above their own curvature scale: the rows of '
                                      'this batch would need different k grids, which the 2D interpolator cannot '
                                      'take; build them as separate batches')
        return float(kmin[0])

    def pk_tables(self):
        """(k [h/Mpc], z, pk_m, pk_cb [(Mpc/h)^3], transfers) from the native
        Einstein-Boltzmann integration, the tables batch + (nz, nk); made
        once and cached."""
        if self._pk_tables is None:
            nk = int(self._extra_params.get('nk_pk', 256))
            kmax = float(self['kmax_pk'])
            k = np.geomspace(self._kmin(), kmax, nk)
            z_pk = self['z_pk']
            z = np.asarray(DEFAULT_Z_PK if z_pk is None else np.atleast_1d(z_pk), dtype=np.float64)
            z = np.unique(np.concatenate([z, [0.0]]))
            th = self.get_section('thermodynamics').table
            # the step budget by the static kmax (in h/Mpc, so it bounds kmax in 1/Mpc)
            n_steps = self._extra_params.get('n_steps_pk', steps_for_kmax(kmax))
            out = linear_pk(self._perturbation_params(), th, torch.from_numpy(k).to(self.device), list(z),
                            n_steps=n_steps)
            shape = self.batch_shape + (z.size, nk)
            transfers = {name: value.reshape(shape) for name, value in out['transfers'].items()
                         if name not in ('k', 'z')}
            self._pk_tables = (k, z, out['pk_m'].reshape(shape), out['pk_cb'].reshape(shape), transfers)
        return self._pk_tables

    def unl_tables(self, lmax):
        """The unlensed CMB spectra (B, L + 1) of the flattened batch, to
        L = ``lmax`` + ``lensing_margin`` (extra_params, default 400), made
        once and cached, so that a later lensed_cl at the same ``lmax``
        reuses them (the margin keeps the lensing remapping unbiased at the
        output's edge). When any row has r > 0 the native tensor spectra
        (boltzmann/tensor.py) are added to tt, ee and te and give the BB, up
        to ``ellmax_tensor`` (extra_params, default 600); P_T is proportional
        to r, so rows with r = 0 get exactly zero."""
        margin = int(self._extra_params.get('lensing_margin', 400))
        if self._unl_cache is None or self._unl_cache[0] < lmax + margin:
            params = self._perturbation_params()
            shared_kmin(_curvature(params))   # a batch that needs several k grids raises before any work
            th = self.get_section('thermodynamics').table
            # kmax_cl widens the k support beyond the TT/EE heuristic (the
            # lensing-potential kernel peaks at chi ~ 3400 Mpc)
            unl = compute_cls(params, th, lmax=lmax + margin, kmax=self._extra_params.get('kmax_cl', None),
                              kmax_pp=self._extra_params.get('kmax_pp', None))
            r = self['r'].reshape(-1)
            if bool(torch.any(r > 0.0)):
                lmax_t = min(lmax + margin, int(self._extra_params.get('ellmax_tensor', 600)))
                params.update(r=r * torch.ones_like(params['h']), n_t=self['n_t'].reshape(-1) * torch.ones_like(r),
                              alpha_t=self['alpha_t'].reshape(-1) * torch.ones_like(r))
                ten = compute_tensor_cls(params, th, lmax=lmax_t)
                for name in ('tt', 'ee', 'te', 'bb'):
                    unl[name] = unl[name] + torch.nn.functional.pad(ten[name], (0, lmax + margin - lmax_t))
            self._unl_cache = (lmax + margin, unl)
        return self._unl_cache[1]

    def lensed_tables(self, lmax):
        """The lensed CMB spectra (B, lmax + 1), made from :meth:`unl_tables`
        when a lensed spectrum is asked for, and cached."""
        if self._lens_cache is None or self._lens_cache[0] < lmax:
            unl = self.unl_tables(lmax)
            self._lens_cache = (lmax, lensed_cls(unl['tt'], unl['ee'], unl['bb'], unl['te'], unl['pp'], lmax=lmax))
        return self._lens_cache[1]

    def cl_tables(self, lmax):
        """(unlensed, lensed) spectra up to ``lmax``: :meth:`unl_tables` and
        :meth:`lensed_tables`."""
        return self.unl_tables(lmax), self.lensed_tables(lmax)


class Thermodynamics(BaseSection):
    """Native recombination history and derived scalars, the batch shape:
    rs_drag, rs_star, rs_star_noreion (Mpc/h), z_drag, z_star,
    z_star_noreion, tau_reio, z_reio, YHe, theta_star, theta_cosmomc, and
    the history itself: x_e(z), T_b(z)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._ba = engine.get_section('background')
        self._th = compute_thermodynamics(engine['omega_b'], engine['h'], engine['T_cmb'], self._ba.efunc,
                                          tau_reio=engine['tau_reio'],
                                          reionization_width=engine['reionization_width'], N_eff=engine['N_eff'])

    @property
    def table(self):
        """The full :class:`~cosmoprimo_tpu_torch.boltzmann.ThermodynamicsResult`."""
        return self._th

    def _rs(self, z):
        return self._ba.rs(z)

    @property
    def rs_drag(self):
        """Comoving sound horizon at z_drag, in Mpc/h."""
        return self._rs(self.z_drag)

    @property
    def rs_star(self):
        """Comoving sound horizon at z_star, in Mpc/h."""
        return self._rs(self.z_star)

    @property
    def rs_star_noreion(self):
        """Comoving sound horizon at z_star_noreion, in Mpc/h."""
        return self._rs(self.z_star_noreion)

    @property
    def z_drag(self):
        return self._th.z_drag

    @property
    def z_star(self):
        return self._th.z_star

    @property
    def z_star_noreion(self):
        return self._th.z_star_noreion

    @property
    def tau_reio(self):
        return self._th.tau_reio

    @property
    def z_reio(self):
        return self._th.z_reio

    @property
    def YHe(self):
        return self._th.YHe

    def _of_z(self, table, z):
        z = torch.as_tensor(z, dtype=torch.float64, device=self.device)
        out = interp(-torch.log1p(z.reshape(-1)), self._th.lna, table)
        return out.reshape(out.shape[:-1] + z.shape)

    def x_e(self, z):
        """Free-electron fraction (per hydrogen nucleus) at z: batch + z.shape."""
        return self._of_z(self._th.x_e, z)

    def T_b(self, z):
        """Baryon (matter) temperature [K] at z: batch + z.shape."""
        return self._of_z(self._th.T_m, z)

    def _transverse(self, z):
        return self._ba.comoving_transverse_distance_rows(z[..., None])[..., 0]

    @property
    def theta_star(self):
        """Sound-horizon angle rs_star / D_M(z_star), in radians."""
        return self.rs_star / self._transverse(self.z_star)

    @property
    def theta_cosmomc(self):
        """CosmoMC approximation to the sound-horizon angle."""
        engine = self.engine
        h = engine['h']
        rs, zstar = _compute_rs_cosmomc(engine['Omega_b'] * h ** 2, engine['Omega_m'] * h ** 2,
                                        self._ba.hubble_function_rows)
        return rs * h / self._transverse(zstar)


class Transfer(BaseSection):
    """Native transfer functions (CAMB's rescaled convention -T_i/k^2 with k
    in 1/Mpc, normalized to the initial curvature R = 1) at each z of the
    engine's z_pk grid."""

    def table(self, z=0.0):
        """Dict of k [h/Mpc] and the transfers d_cdm, d_b, d_g, d_ur, d_ncdm,
        d_m, d_cb and phi (batch + (nk,)) at the z_pk point nearest ``z``."""
        k, zs, _, _, tr = self.engine.pk_tables()
        iz = int(np.argmin(np.abs(zs - z)))
        kMpc = torch.from_numpy(k).to(self.device) * batch_scalar(self.engine['h'], 1)
        out = {'k': k, 'z': zs[iz]}
        for name in ['delta_cdm', 'delta_b', 'delta_g', 'delta_ur', 'delta_ncdm', 'delta_m', 'delta_cb', 'phi']:
            out['d_' + name[6:] if name.startswith('delta_') else name] = -tr[name][..., iz, :] / kMpc ** 2
        return out


class Perturbations(BaseSection):
    """The native Newtonian-gauge perturbation series (CLASS's
    ``get_perturbations`` surface), at the k of ``k_output_values``
    (extra_params, h/Mpc, a scalar or a sequence; default (0.01, 0.1, 1.0))."""

    def table(self):
        """For one cosmology (batch shape ()): a list of structured arrays,
        one per k of ``k_output_values``, with the fields 'tau [Mpc]', 'a'
        and the MB95 Newtonian-gauge perturbations of
        :data:`~cosmoprimo_tpu_torch.boltzmann.perturbations.PERTURBATION_NAMES`
        (delta, theta, shear of each species, phi, psi), normalized to the
        comoving curvature R = 1. For a batch: a list of such lists, one per
        cosmology in the batch's flattened (C) order, since each has its own
        conformal-time grid."""
        engine = self.engine
        k_h = np.atleast_1d(np.asarray(engine._extra_params.get('k_output_values', (0.01, 0.1, 1.0)),
                                       dtype=np.float64))
        params = engine._perturbation_params()
        k = torch.from_numpy(k_h).to(self.device) * params['h'][:, None]
        out = compute_perturbation_series(params, engine.get_section('thermodynamics').table, k,
                                          n_steps=steps_for_kmax(k_h.max()))
        tau, a, series = (out[name].cpu().numpy() for name in ('tau', 'a', 'series'))
        dtype = [('tau [Mpc]', np.float64), ('a', np.float64)] + [(name, np.float64) for name in out['names']]
        tables = []
        for b in range(tau.shape[0]):
            rows = []
            for ik in range(k_h.size):
                arr = np.empty(tau.shape[-1], dtype=dtype)
                arr['tau [Mpc]'], arr['a'] = tau[b], a[b]
                for i, name in enumerate(out['names']):
                    arr[name] = series[b, ik, i]
                rows.append(arr)
            tables.append(rows)
        return tables[0] if engine.batch_shape == () else tables


class cl_table(dict):
    """Dict-of-arrays Cl container mimicking a structured array (keys 'ell',
    'tt', 'ee', ...): a string indexes a key, anything else indexes every
    entry (cosmoprimo_tpu/emulators/emulated.py's)."""

    def __getitem__(self, name):
        if isinstance(name, str):
            return super().__getitem__(name)
        return self.__class__({key: self[key][name] for key in self})

    @property
    def size(self):
        return next((value.size for value in self.values()), 0)


class Harmonic(BaseSection):
    """Natively integrated CMB angular power spectra: ``unlensed_cl``,
    ``lensed_cl`` and ``lens_potential_cl`` return raw dimensionless C_l
    tables (batch shape + (ellmax + 1,)), a negative ``ellmax`` counted back
    from the ``ellmax_cl`` cosmology parameter, rescaled by the sigma8 ratio
    squared. The spectra come from the line-of-sight projection
    (boltzmann/harmonic.py), the correlation-function lensing
    (boltzmann/lensing.py) and, when r > 0, the tensor modes
    (boltzmann/tensor.py). Curved models are served for |Omega_k| <= 0.12
    (the geodesic radial projection's window) on every row."""

    def __init__(self, engine):
        super().__init__(engine)
        if bool(torch.any(torch.abs(engine['Omega_k']) > 0.12)):
            raise CosmologyInputError(
                'native CMB Cls support |Omega_k| <= 0.12: the hyperspherical radial functions are served by the '
                'geodesic projection j_l(q S_K(chi)), whose O(K/q^2) error is certified only in that window.')
        self._rsigma8 = engine._rescale_sigma8()
        self.ellmax_cl = engine['ellmax_cl']

    def _resolve_ellmax(self, ellmax):
        if ellmax < 0:
            ellmax = self.ellmax_cl + 1 + ellmax
        return ellmax

    def _cl_dict(self, table, names, lmax):
        scale = batch_scalar(self._rsigma8 ** 2, 1)
        shape = self.engine.batch_shape + (lmax + 1,)
        out = {name: table[name][:, :lmax + 1].reshape(shape) * scale for name in names}
        out['ell'] = np.arange(lmax + 1)
        return cl_table(out)

    def unlensed_cl(self, ellmax=-1):
        r"""Unlensed scalar (and tensor) :math:`C_\ell` ['tt', 'ee', 'bb', 'te'], unitless."""
        lmax = self._resolve_ellmax(ellmax)
        return self._cl_dict(self.engine.unl_tables(lmax), ('tt', 'ee', 'bb', 'te'), lmax)

    def lensed_cl(self, ellmax=-1):
        r"""Lensed :math:`C_\ell` ['tt', 'ee', 'bb', 'te'], unitless."""
        lmax = self._resolve_ellmax(ellmax)
        return self._cl_dict(self.engine.lensed_tables(lmax), ('tt', 'ee', 'bb', 'te'), lmax)

    def lens_potential_cl(self, ellmax=-1):
        r"""Lensing-potential :math:`C_\ell` ['pp', 'tp', 'ep'], unitless."""
        lmax = self._resolve_ellmax(ellmax)
        return self._cl_dict(self.engine.unl_tables(lmax), ('pp', 'tp', 'ep'), lmax)


class Fourier(BaseSection):
    """Linear power spectra from the native Boltzmann integration, through
    the (k, z)-table interpolator: pk_interpolator, pk_kz, sigma_rz,
    sigma8_z, sigma8_m, sigma8_cb."""

    def __init__(self, engine):
        super().__init__(engine)
        self._rsigma8 = engine._rescale_sigma8()

    def table(self, non_linear=False, of='delta_m'):
        """(k [h/Mpc], z, pk batch + (nk, nz)) of 'delta_m' or 'delta_cb'."""
        if non_linear:
            raise CosmologyInputError('The native engine serves linear P(k); apply halofit/hmcode via '
                                      'pipelines.apply_non_linear.')
        k, z, pk_m, pk_cb, _ = self.engine.pk_tables()
        if of in ('delta_m', ('delta_m', 'delta_m')):
            pk = pk_m
        elif of in ('delta_cb', ('delta_cb', 'delta_cb')):
            pk = pk_cb
        else:
            raise CosmologyInputError(f'Native engine provides delta_m / delta_cb spectra, not {of}.')
        return k, z, (pk * batch_scalar(self._rsigma8 ** 2, 2)).transpose(-1, -2)

    def pk_interpolator(self, non_linear=False, of='delta_m', **kwargs):
        k, z, pk = self.table(non_linear=non_linear, of=of)
        return PowerSpectrumInterpolator2D(k, z, pk, **kwargs)

    def pk_kz(self, k, z, non_linear=False, of='delta_m'):
        return self.pk_interpolator(non_linear=non_linear, of=of)(k, z)

    def sigma_rz(self, r, z, of='delta_m', **kwargs):
        return self.pk_interpolator(of=of, **kwargs).sigma_rz(r, z)

    def sigma8_z(self, z, of='delta_m'):
        return self.sigma_rz(8.0, z, of=of)

    @property
    def sigma8_m(self):
        return self.sigma8_z(0.0, of='delta_m')

    @property
    def sigma8_cb(self):
        return self.sigma8_z(0.0, of='delta_cb')
