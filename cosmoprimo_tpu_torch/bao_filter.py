r"""BAO wiggle/peak removal filters (cosmoprimo_tpu/bao_filter.py), batch-first.

==============  =========================================================  ==========
name            method                                                     runs on
==============  =========================================================  ==========
hinton2017      degree-12 constrained poly fit in log-log                  device
savgol          Savitzky-Golay on log(k pk) (static coefficients)          device
ehsavgol        Savitzky-Golay on the ratio to EH-nowiggle                 device
ehpoly          6-term poly fit of pk / EH-nowiggle (constrained LSQ)      device
wallish2018     DST-II to real space, excise the peak, inverse DST         host
brieden2022     peak/trough averaging at fiducial peak positions           host
peakaverage     simplified Brieden with frozen fiducial peak k's           device
bspline         velocileptors-style constrained B-spline fit               device
kirkby2013      (xi) cut the peak window, poly fit outside, blend          device
==============  =========================================================  ==========

The filters work on rows: an interpolator of batch shape ``batch`` and nz
redshifts gives prod(batch) * nz rows of nk points, k last, and every row
is filtered at once. Per-cosmology quantities (the sound-horizon ratio to
the fiducial, the EH no-wiggle spectrum) are broadcast over the redshifts
of their rows. ``_prepare`` runs once on the host and freezes what depends
on the data there, as the JAX package does: the peak of row 0 (the first
cosmology at the first z) for hinton2017, and the fiducial cosmology's peak
positions for peakaverage and brieden2022. ``_compute`` runs on the device
without a host synchronisation. wallish2018 and brieden2022 stay on the
host, as in the JAX package (scipy's DST, find_peaks and splines on index
boxes that depend on the data): their rows go to the host and come back to
the caller's device explicitly.
"""

import numpy as np
import torch

from . import tracing
from .cosmology import Cosmology
from .interpolator import CorrelationFunctionInterpolator2D, PowerSpectrumInterpolator2D
from .ops import cubic_eval_rows, interp, linspace_rows, natural_cubic_coeffs, natural_cubic_coeffs_rows, simpson
from .utils import LeastSquareSolver, fit_operator

_FIDUCIAL_RS_DRAG = 100.91463132327911  # DESI fiducial, Mpc/h

_PK_FILTER_REGISTRY = {}
_XI_FILTER_REGISTRY = {}


def register_pk_filter(cls):
    _PK_FILTER_REGISTRY[cls.name] = cls
    return cls


def register_xi_filter(cls):
    _XI_FILTER_REGISTRY[cls.name] = cls
    return cls


def _on(device, array):
    return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float64)).to(device)


def _span(mask):
    """The slice of the one contiguous run of True in the 1D numpy ``mask``."""
    index = np.flatnonzero(mask)
    return slice(int(index[0]), int(index[-1]) + 1)


def _edge_constraints(values):
    """The four constraint values of the fits (first, first step, last, last
    step) along the last axis of ``values``."""
    return torch.stack([values[..., 0], values[..., 1] - values[..., 0],
                        values[..., -1], values[..., -2] - values[..., -1]], dim=-1)


def _edge_constraint_gradient(gradient):
    """The four constraint columns of the fits for the (nbasis, ndata)
    numpy ``gradient``: (nbasis, 4)."""
    return np.column_stack([gradient[..., 0], gradient[..., 1] - gradient[..., 0],
                            gradient[..., -1], gradient[..., -2] - gradient[..., -1]])


class _BaseBAOFilter(object):
    """Rows, the cosmologies and the sound-horizon ratio, shared by the
    P(k) and xi filters."""

    def _set_rows(self, values, is2d):
        """``values`` (..., n, nz) if ``is2d`` else (..., n) as rows (R, n)."""
        self.shape = values.shape
        self._is2d = is2d
        rows = values.transpose(-1, -2) if is2d else values[..., None, :]
        self._rows_shape = rows.shape
        self.device = values.device
        return rows.reshape(-1, rows.shape[-1])

    def _unrows(self, rows):
        rows = rows.reshape(self._rows_shape)
        return rows.transpose(-1, -2) if self._is2d else rows[..., 0, :]

    def _per_row(self, x, ntrail=0):
        """A per-cosmology tensor (batch + ``ntrail`` trailing axes) on the
        rows: (R,) + trailing; a float stays a float."""
        if not isinstance(x, torch.Tensor):
            return x
        batch, nz = self._rows_shape[:-2], self._rows_shape[-2]
        lead, trail = x.shape[:x.dim() - ntrail], x.shape[x.dim() - ntrail:]
        x = x.reshape(lead + (1,) + trail).expand(batch + (nz,) + trail)
        return x.reshape((-1,) + trail)

    @property
    def cosmo(self):
        if self._cosmo is None:
            self._cosmo = Cosmology(device=self.device)
        return self._cosmo

    @property
    def cosmo_fid(self):
        if self._cosmo_fid is None:
            self._cosmo_fid = Cosmology(device=self.device)
        return self._cosmo_fid

    def rs_drag_ratio(self):
        """rs_drag of each cosmology over the fiducial's: the cosmology's
        batch shape (1.0 without a cosmology)."""
        if self._cosmo is None:
            return 1.0
        rs_fid = _FIDUCIAL_RS_DRAG if self._cosmo_fid is None else self.cosmo_fid.rs_drag.to(self.device)
        return self.cosmo.rs_drag / rs_fid

    def _rescale(self, enabled=True):
        """The sound-horizon ratio on the rows, (R,), or 1.0."""
        return self._per_row(self.rs_drag_ratio()) if enabled else 1.0


# ----------------------------------------------------------------------------
# Power spectrum filters
# ----------------------------------------------------------------------------

class BasePowerSpectrumBAOFilter(_BaseBAOFilter):
    """Base BAO filter for power spectra: evaluates the input interpolator
    on a geometric k-grid of ``nk`` points (1024) and exposes pk, pknow and
    wiggles in the interpolator's layout, batch + (nk,) [+ (nz,)]."""

    name = 'base'

    def __init__(self, pk_interpolator, cosmo=None, cosmo_fid=None, **kwargs):
        with tracing.span('cosmoprimo.bao_filter'):
            self._cosmo_fid = cosmo_fid
            self._cosmo = cosmo
            self.pk_interpolator = pk_interpolator
            self.set_k(**kwargs)
            with tracing.span('cosmoprimo.bao_filter.evaluate'):
                self.set_pk(pk_interpolator, cosmo=cosmo)
            with tracing.span('cosmoprimo.bao_filter.prepare'):
                self._prepare()
            with tracing.span('cosmoprimo.bao_filter.compute'):
                self._compute()
            self.pk, self.pknow = self._unrows(self.pk), self._unrows(self.pknow)

    def _prepare(self):
        """One-time host-side setup (data-dependent indices are frozen here)."""

    def set_k(self, nk=1024):
        self.k = np.geomspace(float(self.pk_interpolator.extrap_kmin), float(self.pk_interpolator.extrap_kmax), nk)

    def _evaluate(self, pk_interpolator, k):
        """The interpolator at ``k`` (a tensor), growth ignored: (..., nk, nz)
        for a 2D interpolator, (..., nk) for a 1D one."""
        if isinstance(pk_interpolator, PowerSpectrumInterpolator2D):
            return pk_interpolator(k, pk_interpolator.z, ignore_growth=True)
        return pk_interpolator(k)

    def set_pk(self, pk_interpolator, cosmo=None):
        if cosmo is not None:
            self._cosmo = cosmo
        self.pk_interpolator = pk_interpolator
        self._k = _on(pk_interpolator.device, self.k)
        self.pk = self._set_rows(self._evaluate(pk_interpolator, self._k),
                                 isinstance(pk_interpolator, PowerSpectrumInterpolator2D))

    def __call__(self, pk_interpolator, cosmo=None):
        with tracing.span('cosmoprimo.bao_filter'):
            with tracing.span('cosmoprimo.bao_filter.evaluate'):
                self.set_pk(pk_interpolator, cosmo=cosmo)
            with tracing.span('cosmoprimo.bao_filter.compute'):
                self._compute()
            self.pk, self.pknow = self._unrows(self.pk), self._unrows(self.pknow)
        return self

    @property
    def wiggles(self):
        return self.pk / self.pknow

    def smooth_pk_interpolator(self, **kwargs):
        return self.pk_interpolator.clone(k=self.k, pk=self.pknow, **kwargs)

    def smooth_xi_interpolator(self, **kwargs):
        return self.smooth_pk_interpolator().to_xi(**kwargs)

    def _pknow_eh(self, k, cosmo=None):
        """EH no-wiggle power spectrum at ``k`` (z = 0, growth ignored):
        the cosmology's batch shape + k.shape."""
        cosmo = cosmo if cosmo is not None else self.cosmo
        return cosmo.get_fourier(engine='eisenstein_hu_nowiggle', set_engine=False).pk_interpolator()(k, z=0.0)


@register_pk_filter
class Hinton2017PowerSpectrumBAOFilter(BasePowerSpectrumBAOFilter):
    """Degree-12 polynomial fit of log pk in log k with a Gaussian
    down-weight around the spectrum peak (of row 0, frozen at prepare) and
    6 endpoint constraints (arXiv:1611.08040 heritage)."""

    name = 'hinton2017'

    def __init__(self, pk_interpolator, degree=12, sigma=0.5, weight=0.9, **kwargs):
        self.degree = degree
        self.sigma = sigma
        self.weight = weight
        super().__init__(pk_interpolator, **kwargs)

    def _prepare(self):
        self._span = _span((self.k > 1e-4) & (self.k < 5.0))
        logk = np.log10(self.k[self._span])
        logpk0 = np.log10(self.pk[0, self._span].cpu().numpy())
        maxk = logk[np.argmax(logpk0)]
        meanlogk, stdlogk = np.mean(logk), np.std(logk)
        w = 1.0 - self.weight * np.exp(-0.5 * ((logk - maxk) / self.sigma) ** 2)
        gradient = np.array([((logk - meanlogk) / stdlogk) ** i for i in range(self.degree + 1)])
        constraint_gradient = np.column_stack([
            gradient[..., 0], gradient[..., 1] - gradient[..., 0],
            gradient[..., 2] - 2.0 * gradient[..., 1] + gradient[..., 0],
            gradient[..., -1], gradient[..., -2] - gradient[..., -1],
            gradient[..., -3] - 2.0 * gradient[..., -2] + gradient[..., -1]])
        # a degree-12 fit (cond 5.3e12): its linear map is made in extended precision
        self._fit = [_on(self.device, a) for a in fit_operator(gradient, w ** 2, constraint_gradient)]

    def _compute(self):
        logpk = torch.log10(self.pk[:, self._span])
        constraint = torch.stack([
            logpk[..., 0], logpk[..., 1] - logpk[..., 0],
            logpk[..., 2] - 2.0 * logpk[..., 1] + logpk[..., 0],
            logpk[..., -1], logpk[..., -2] - logpk[..., -1],
            logpk[..., -3] - 2.0 * logpk[..., -2] + logpk[..., -1]], dim=-1)
        model = logpk @ self._fit[0].T + constraint @ self._fit[1].T
        lo, hi = self._span.start, self._span.stop
        self.pknow = torch.cat([self.pk[:, :lo], 10 ** model, self.pk[:, hi:]], dim=-1)


def _savgol_coeffs(window, polyorder):
    """Savitzky-Golay smoothing coefficients (host, static): the weights of
    the least-squares polynomial's value at the window center."""
    half = window // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    A = np.vander(x, polyorder + 1, increasing=True)
    return np.linalg.lstsq(A, np.eye(window), rcond=None)[0][0]


def _savgol_smooth(y, weights, edge):
    """Savitzky-Golay smoothing of the rows ``y`` (R, n) with the static
    ``weights`` (a correlation, 'same' size, zero padding); the ``edge``
    first and last samples keep the input."""
    half = weights.shape[0] // 2
    out = torch.nn.functional.conv1d(y[:, None, :], weights[None, None, :], padding=half)[:, 0]
    return torch.cat([y[:, :edge], out[:, edge:y.shape[-1] - edge], y[:, y.shape[-1] - edge:]], dim=-1)


class _SavGolMixin(object):

    def _prepare(self):
        self.nfilter = int(np.ceil(np.log(7) / np.log(self.k[-1] / self.k[-2])) // 2 * 2 + 1)
        self._weights = _on(self.device, _savgol_coeffs(self.nfilter, 4))


@register_pk_filter
class SavGolPowerSpectrumBAOFilter(_SavGolMixin, BasePowerSpectrumBAOFilter):
    """Savitzky-Golay smoothing of log(k pk), window of ln(7) in ln k."""

    name = 'savgol'

    def _compute(self):
        logkpk = torch.log(self._k * self.pk)
        self.pknow = torch.exp(_savgol_smooth(logkpk, self._weights, self.nfilter // 2)) / self._k


@register_pk_filter
class EHNoWiggleSavGolPowerSpectrumBAOFilter(_SavGolMixin, BasePowerSpectrumBAOFilter):
    """Savitzky-Golay smoothing of the ratio to the EH no-wiggle spectrum."""

    name = 'ehsavgol'

    def _compute(self):
        pknow = self._per_row(self._pknow_eh(self._k), 1)
        self.pknow = _savgol_smooth(self.pk / pknow, self._weights, self.nfilter // 2) * pknow


@register_pk_filter
class EHNoWigglePolyPowerSpectrumBAOFilter(BasePowerSpectrumBAOFilter):
    """6-term polynomial (k^-2 .. k^3) fit of pk / EH-nowiggle over
    ``krange`` (rescaled by each cosmology's sound-horizon ratio), with the
    fit held to the data at the first two and last two points of the
    range. The range differs by row, so its edges are gathered per row and
    the fit is a batch of 10 x 10 bordered systems, one per row: the JAX
    package's exact (concrete-rescale) form, without boolean indexing."""

    name = 'ehpoly'

    def __init__(self, pk_interpolator, krange=(1e-3, 1.0), rescale_krange=True, cosmo=None, **kwargs):
        self.krange = krange
        self.rescale_krange = rescale_krange
        super().__init__(pk_interpolator, cosmo=cosmo, **kwargs)

    def _prepare(self):
        self._gradient = torch.stack([self._k ** (i - 2) for i in range(6)])

    def _compute(self):
        rescale = torch.as_tensor(self._rescale(self.rescale_krange), dtype=torch.float64, device=self.device)
        k = self._k
        mask = (k >= (self.krange[0] / rescale)[..., None]) & (k <= (self.krange[1] / rescale)[..., None])
        mask = mask.expand(self.pk.shape)
        n = k.shape[0]
        first = torch.argmax(mask.to(torch.int8), dim=-1)
        last = n - 1 - torch.argmax(mask.flip(-1).to(torch.int8), dim=-1)
        edges = torch.stack([first, first + 1, last - 1, last], dim=-1)                  # (R, 4)
        ratio = self.pk / self._per_row(self._pknow_eh(k), 1)
        g = self._gradient.T[edges]                                                       # (R, 4, 6)
        constraint_gradient = torch.stack([g[:, 0], g[:, 1] - g[:, 0], g[:, 3], g[:, 2] - g[:, 3]], dim=-1)
        r = torch.gather(ratio, -1, edges)
        constraint = torch.stack([r[:, 0], r[:, 1] - r[:, 0], r[:, 3], r[:, 2] - r[:, 3]], dim=-1)
        solver = LeastSquareSolver(self._gradient, precision=torch.where(mask, k ** 2, 0.0),
                                   constraint_gradient=constraint_gradient)
        solver(ratio, constraint=constraint)
        wiggles = torch.where(mask, ratio / solver.model(), 1.0)
        self.pknow = self.pk / wiggles


@register_pk_filter
class Wallish2018PowerSpectrumBAOFilter(BasePowerSpectrumBAOFilter):
    """DST-II of log(k pk) on a 4096-point linear k-grid; the BAO bump is
    located via the curvature maximum of the even/odd sine coefficients,
    excised and re-splined (x idx^2), then inverse-transformed
    (arXiv:1810.02800 App. D). On the host: the rows are copied there and
    the result back to the caller's device."""

    name = 'wallish2018'

    def _compute(self):
        from scipy import fftpack, interpolate
        k = np.linspace(float(self.pk_interpolator.extrap_kmin), 2.0, 4096)
        pk = self._evaluate(self.pk_interpolator, _on(self.device, k))
        pk = (pk.transpose(-1, -2) if self._is2d else pk).reshape(-1, k.size).cpu().numpy().T   # (4096, R)

        kpk = np.log(k[:, None] * pk)
        kpkffted = fftpack.dst(kpk, type=2, axis=0, norm='ortho')
        even = kpkffted[::2].copy()
        odd = kpkffted[1::2].copy()

        xeven = 1 + np.arange(even.shape[0])
        xodd = 1 + np.arange(odd.shape[0])
        dd_even = interpolate.CubicSpline(xeven, even, axis=0, bc_type='clamped')(xeven, nu=2)
        dd_odd = interpolate.CubicSpline(xodd, odd, axis=0, bc_type='clamped')(xodd, nu=2)
        margin_first, margin_second = 20, 5
        offset = (-10, 20)

        def smooth(vals, x, dd):
            argmax = dd[margin_first:-margin_first].argmax() + margin_first
            hi = argmax + margin_second + dd[argmax + margin_second:-margin_first].argmax() + offset[1]
            box = (argmax + offset[0], hi)
            mask = np.ones_like(vals, dtype=bool)
            mask[box[0]:box[1] + 1] = False
            spline = interpolate.CubicSpline(x[mask], vals[mask] * x[mask] ** 2, bc_type='clamped')
            return spline(x) / x ** 2

        for iz in range(pk.shape[-1]):
            even[:, iz] = smooth(even[:, iz], xeven, dd_even[:, iz])
            odd[:, iz] = smooth(odd[:, iz], xodd, dd_odd[:, iz])

        merged = np.empty_like(kpkffted)
        merged[::2] = even
        merged[1::2] = odd
        kpknow = fftpack.idst(merged, type=2, axis=0, norm='ortho')
        pknow = np.exp(kpknow) / k[:, None]

        mask = (k > 1e-2) & (k < 1.5)
        k, pknow = k[mask], pknow[mask]
        pk_self = self.pk.cpu().numpy().T
        mask_left, mask_right = self.k < 5e-4, self.k > 2.0
        k = np.concatenate([self.k[mask_left], k, self.k[mask_right]], axis=0)
        pknow = np.concatenate([pk_self[mask_left], pknow, pk_self[mask_right]], axis=0)
        pknow = interpolate.CubicSpline(k, pknow, axis=0, bc_type='clamped', extrapolate=False)(self.k)
        tophat = self._tophat(self.k, kmax=1.0, scale=20.0)[..., None]
        wiggles = (pk_self / pknow - 1.0) * tophat + 1.0
        self.pknow = _on(self.device, (pk_self / wiggles).T)

    @staticmethod
    def _tophat(k, kmax=1, scale=1):
        tophat = np.ones_like(k)
        mask = k > kmax
        tophat[mask] = np.exp(-scale ** 2 * (k[mask] / kmax - 1.0) ** 2)
        return tophat


def _find_peaks(y):
    """Indices of the peaks of ``y``. The fits pin the smooth correction to
    the data at the last two points of the range, so the ratio is 1 there
    up to rounding and one of them may rise above the other by ~1e-13: such
    a peak, of prominence at the rounding level, is not kept (the JAX
    package's scipy call keeps it or not, depending on the last bit)."""
    from scipy import signal
    return signal.find_peaks(y, prominence=1e-10)[0]


def _fiducial_peaks(filt, k_fid):
    """The fiducial spectrum over EH no-wiggle at ``k_fid`` (host numpy),
    and its smooth correction: a constrained fit of k^-1 .. k^2."""
    tracing.counters['bao_filter.fiducial_fits'] += 1
    cosmo_fid = filt.cosmo_fid
    k = _on(cosmo_fid.device, k_fid)
    pk_fid = cosmo_fid.get_fourier().pk_interpolator()(k, z=0.0).cpu().numpy()
    ratio = pk_fid / filt._pknow_eh(k, cosmo=cosmo_fid).cpu().numpy()
    gradient = np.array([k_fid ** (i - 1) for i in range(4)])
    solver = LeastSquareSolver(gradient, precision=k_fid ** 2, constraint_gradient=_edge_constraint_gradient(gradient))
    solver(ratio, constraint=_edge_constraints(torch.from_numpy(ratio)))
    return ratio, solver.model().numpy()


class _NeedsFiducial(object):

    @property
    def cosmo_fid(self):
        if self._cosmo_fid is None:
            raise ValueError('cosmo_fid must be provided, with an engine')
        return self._cosmo_fid


@register_pk_filter
class Brieden2022PowerSpectrumBAOFilter(_NeedsFiducial, BasePowerSpectrumBAOFilter):
    """Peak/trough averaging of pk/pknow_EH at the fiducial's peak positions
    (arXiv:2204.11868 App. D). Needs ``cosmo_fid`` with an engine. On the
    host (scipy find_peaks and quadratic interpolation, one cosmology at a
    time): its rows are copied there and the result back to the caller's
    device."""

    name = 'brieden2022'

    def _prepare(self):
        self.kmask_fid = (self.k >= 1e-3) & (self.k <= 1.0)
        self.k_fid = self.k[self.kmask_fid]
        ratio, correction = _fiducial_peaks(self, self.k_fid)
        self.pknow_correction = correction[:, None]
        self.ratio_fid = ratio[:, None] / self.pknow_correction
        ik0 = np.searchsorted(self.k_fid, 0.02, side='right') + 1
        self.ik_fid_peaks = []
        for si in [1.0, -1.0]:
            ix = _find_peaks(si * self.ratio_fid[ik0:, 0]) + ik0
            ix = np.concatenate([[0]] * bool(ix[0] > 0) + [ix] + [[-1]] * bool(ix[-1] < self.k_fid.size - 1), axis=0)
            self.ik_fid_peaks.append(ix)
        self.ratio_now_fid = self._interp(*self.ik_fid_peaks, self.k_fid, self.ratio_fid)

    @staticmethod
    def _interp(ixh, ixl, x, y, kind=2):
        from scipy import interpolate
        toret = 0.0
        for ix in [ixh, ixl]:
            toret = toret + interpolate.interp1d(x[ix], np.asarray(y)[ix], kind=kind, axis=0,
                                                 fill_value='extrapolate', assume_sorted=True)(x)
        return toret / 2.0

    def _compute(self):
        batch, nz = self._rows_shape[:-2], self._rows_shape[-2]
        nb = int(np.prod(batch, dtype=int))
        rescale = torch.as_tensor(self.rs_drag_ratio(), dtype=torch.float64, device=self.device)
        rescale = rescale.expand(batch).reshape(nb).cpu().numpy()                              # host, per cosmology
        nf = self.k_fid.size
        k_pk = _on(self.device, self.k_fid[None, :] / rescale[:, None])                       # (nb, nf)
        k_eh = _on(self.device, self.k_fid[None, :] * rescale[:, None])
        # each cosmology at its own grid: the blocks on the diagonal of one evaluation on all the grids
        diag = torch.arange(nb, device=self.device)
        pk = self._evaluate(self.pk_interpolator, k_pk.reshape(-1))
        pk = pk.reshape((nb, nb, nf) + ((nz,) if self._is2d else ()))[diag, diag]
        pk = (pk if self._is2d else pk[..., None]).cpu().numpy()                               # (nb, nf, nz)
        eh = self._pknow_eh(k_eh.reshape(-1))
        eh = eh.expand(batch + eh.shape[-1:]).reshape(nb, nb, nf)[diag, diag].cpu().numpy()    # (nb, nf)
        pknow_out = self.pk.reshape(nb, nz, -1).cpu().numpy().copy()
        for b in range(nb):
            pknow = eh[b][:, None] * self.pknow_correction
            ratio = pk[b] / pknow / self.ratio_fid
            pknow = self._interp(*self.ik_fid_peaks, self.k_fid, ratio) * pknow * self.ratio_now_fid
            table = torch.from_numpy(pknow if self._is2d else pknow[:, 0])
            smooth = self.pk_interpolator.clone(k=self.k_fid / rescale[b], pk=table)
            pkv = self._evaluate(smooth, torch.from_numpy(self.k_fid)).numpy()
            pknow_out[b][:, self.kmask_fid] = pkv.T if self._is2d else pkv[None, :]
        self.pknow = _on(self.device, pknow_out.reshape(-1, self.k.size))


@register_pk_filter
class PeakAveragePowerSpectrumBAOFilter(_NeedsFiducial, BasePowerSpectrumBAOFilter):
    """Simplified Brieden 2022: the fiducial's peak positions, frozen at
    prepare, rescaled by each cosmology's sound-horizon ratio, averaged
    through cubic splines in log k. The knots differ by row, so the splines
    through them are solved together by batched tridiagonal scans."""

    name = 'peakaverage'

    def _prepare(self):
        index = np.flatnonzero((self.k >= 1e-3) & (self.k <= 1.0))
        k_fid = self.k[index]
        ratio, correction = _fiducial_peaks(self, k_fid)
        ik0 = np.searchsorted(k_fid, 1e-2, side='right') + 1
        self.k_peaks, self.pad_peaks = [], []
        for si in [1.0, -1.0]:
            ik = _find_peaks(si * ratio[ik0:] / correction[ik0:]) + ik0
            npadlow = int(index[0])
            ik = ik + npadlow
            ikmax = max(index[-1], ik[-1] + 1)
            self.pad_peaks.append((npadlow, len(ik), self.k.size - ikmax))
            self.k_peaks.append(self.k[np.concatenate([np.arange(npadlow), ik, np.arange(ikmax, self.k.size)], axis=0)])
        self._k_peaks = [_on(self.device, k) for k in self.k_peaks]
        self._logk = torch.log10(self._k)

    def _interp(self, xh, xl, y):
        """Average of the splines in log k through ``y`` (R, nk) sampled at
        the per-row knots ``xh`` and ``xl`` (R, n), at the k-grid."""
        logx = self._logk
        M = natural_cubic_coeffs(logx, y.T).T
        toret = 0.0
        for xx in [xh, xl]:
            logxx = torch.log10(xx)
            yy = cubic_eval_rows(logx, y, M, logxx)
            toret = toret + cubic_eval_rows(logxx, yy, natural_cubic_coeffs_rows(logxx, yy), logx)
        return toret / 2.0

    def _compute(self):
        rescale = torch.as_tensor(self._rescale(), dtype=torch.float64, device=self.device)
        one = torch.ones_like(rescale)
        knots = []
        for k_peaks, npad in zip(self._k_peaks, self.pad_peaks):
            rescales = torch.cat([linspace_rows(one, rescale, npad[0]),
                                  rescale[..., None].expand(rescale.shape + (npad[1],)),
                                  linspace_rows(rescale, one, npad[2])], dim=-1)
            knots.append((k_peaks / rescales).expand(self.pk.shape[:1] + k_peaks.shape))
        pknow = self._per_row(self._pknow_eh(self._k), 1)
        self.pknow = self._interp(*knots, self.pk / pknow) * pknow


@register_pk_filter
class BSplinePowerSpectrumBAOFilter(BasePowerSpectrumBAOFilter):
    """Constrained B-spline fit of pk / EH-nowiggle (arXiv:1509.02120 App.
    A); the solutions of several knot counts are combined to preserve sigma8
    (and optionally sigma_d) of the input spectrum."""

    name = 'bspline'

    def __init__(self, pk_interpolator, constraint=('sigma8',), cosmo=None, **kwargs):
        if not isinstance(constraint, (tuple, list)):
            constraint = [constraint]
        self.constraint = list(constraint)
        super().__init__(pk_interpolator, cosmo=cosmo, **kwargs)

    def _prepare(self):
        from scipy import interpolate
        kmin, kmax = 5e-3, 1.0
        logk = np.log10(self.k)
        self._span = _span((self.k >= kmin) & (self.k <= kmax))
        logk_fid = logk[self._span]
        weights_fid = 1 + 1e6 * np.tanh(0.005 * (logk_fid + 1.1) ** 16)
        weights_fid /= np.sum(weights_fid)
        nknots_degrees = [(14, 5), (14, 6), (15, 7)][:1 + len(self.constraint)]
        self.solvers = []
        for nknots, degree in nknots_degrees:
            ts = np.concatenate([np.zeros(degree + 1), np.arange(1, nknots - 2 * degree) / (nknots - 2 * degree),
                                 np.ones(degree + 1)])
            ts = np.log10((kmax - kmin) * ts + kmin)
            gradient = []
            for ii in range(nknots - degree):
                cn = np.zeros(len(ts) - degree - 1)
                cn[ii] = 1
                gradient.append(interpolate.BSpline(ts, cn, degree)(logk_fid))
            gradient = np.array(gradient)
            self.solvers.append(LeastSquareSolver(gradient, precision=weights_fid,
                                                  constraint_gradient=_edge_constraint_gradient(gradient),
                                                  device=self.device))

    def _compute(self):
        pknow = self._per_row(self._pknow_eh(self._k), 1)
        lo, hi = self._span.start, self._span.stop
        ratio_fid = self.pk[:, lo:hi] / pknow[:, lo:hi]
        constraint = _edge_constraints(ratio_fid)
        spline_models = []
        for solver in self.solvers:
            solver(ratio_fid, constraint=constraint)
            spline_models.append(torch.cat([self.pk[:, :lo], solver.model() * pknow[:, lo:hi], self.pk[:, hi:]],
                                           dim=-1))
        k = self._k

        def tophat(kr):
            return 3 * (torch.sin(kr) - kr * torch.cos(kr)) / kr ** 3

        def sigma8(pk):
            return 1 / (2.0 * np.pi ** 2) * simpson(k ** 2 * tophat(k * 8.0) ** 2 * pk, x=k, axis=-1)

        def sigmad(pk):
            return 1 / (6.0 * np.pi ** 2) * simpson(pk, x=k, axis=-1)

        callables = {'sigma8': sigma8, 'sigmad': sigmad}
        rows = self.pk.shape[0]
        system = [self.pk.new_ones((rows, 1, len(spline_models)))]
        target = [self.pk.new_ones((rows, 1))]
        for constraint in self.constraint:
            fn = callables.get(constraint, constraint)
            system.append(torch.stack([fn(model) for model in spline_models], dim=-1)[:, None, :])
            target.append(fn(self.pk)[:, None])
        coeffs = torch.linalg.solve(torch.cat(system, dim=1), torch.cat(target, dim=1)[..., None])[..., 0]
        self.pknow = torch.sum(coeffs.T[..., None] * torch.stack(spline_models), dim=0)


# ----------------------------------------------------------------------------
# Correlation function filters
# ----------------------------------------------------------------------------

class BaseCorrelationFunctionBAOFilter(_BaseBAOFilter):
    """Base BAO filter for correlation functions: evaluates the input
    interpolator on a geometric s-grid of ``ns`` points (1024)."""

    name = 'base'

    def __init__(self, xi_interpolator, cosmo=None, cosmo_fid=None, **kwargs):
        self._cosmo_fid = cosmo_fid
        self._cosmo = cosmo
        self.xi_interpolator = xi_interpolator
        self.set_s(**kwargs)
        self.set_xi(xi_interpolator, cosmo=cosmo)
        self._prepare()
        self._compute()
        self.xi, self.xinow = self._unrows(self.xi), self._unrows(self.xinow)

    def _prepare(self):
        pass

    def set_s(self, ns=1024):
        self.s = np.geomspace(float(self.xi_interpolator.extrap_smin), float(self.xi_interpolator.extrap_smax), ns)

    def set_xi(self, xi_interpolator, cosmo=None):
        if cosmo is not None:
            self._cosmo = cosmo
        self.xi_interpolator = xi_interpolator
        self._s = _on(xi_interpolator.device, self.s)
        is2d = isinstance(xi_interpolator, CorrelationFunctionInterpolator2D)
        xi = xi_interpolator(self._s, xi_interpolator.z, ignore_growth=True) if is2d else xi_interpolator(self._s)
        self.xi = self._set_rows(xi, is2d)

    def __call__(self, xi_interpolator, cosmo=None):
        self.set_xi(xi_interpolator, cosmo=cosmo)
        self._compute()
        self.xi, self.xinow = self._unrows(self.xi), self._unrows(self.xinow)
        return self

    def smooth_xi_interpolator(self, **kwargs):
        return self.xi_interpolator.clone(s=self.s, xi=self.xinow, **kwargs)

    def smooth_pk_interpolator(self, **kwargs):
        return self.smooth_xi_interpolator().to_pk(**kwargs)


@register_xi_filter
class Kirkby2013CorrelationFunctionBAOFilter(BaseCorrelationFunctionBAOFilter):
    """Cut the BAO peak window (rescaled by each cosmology's sound-horizon
    ratio) and fit s^(1-i), i < 5 outside it, blending smoothly
    (arXiv:1301.3456, picca heritage). The window weights differ by row, so
    the fit is a batch of 5 x 5 normal systems, one per row."""

    name = 'kirkby2013'

    def __init__(self, xi_interpolator, srange_left=(50.0, 82.0), srange_right=(150.0, 190.0),
                 rescale_sbox=True, cosmo=None, **kwargs):
        self.srange_left = np.asarray(srange_left)
        self.srange_right = np.asarray(srange_right)
        self.rescale_sbox = rescale_sbox
        super().__init__(xi_interpolator, cosmo=cosmo, **kwargs)

    def _prepare(self):
        factor = 2.0
        self._span = _span((self.s >= self.srange_left[0] / factor) & (self.s <= self.srange_right[1] * factor))
        self.model = np.array([self.s ** (1 - i) for i in range(5)])
        frac = 1.0 / 100.0
        shift = (self.srange_right[0] - self.srange_left[1]) * frac
        self.window = (np.concatenate([[self.srange_left[0] * (1.0 - frac)], self.srange_left,
                                       [self.srange_left[1] + shift, self.srange_right[0] - shift],
                                       self.srange_right, [self.srange_right[1] * (1.0 + frac)]], axis=0),
                       np.array([0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0, 0.0]))
        self._model = _on(self.device, self.model)
        self._window = [_on(self.device, w) for w in self.window]

    def _compute(self):
        rescale = torch.as_tensor(self._rescale(self.rescale_sbox), dtype=torch.float64, device=self.device)
        s = self._s / rescale[..., None]                             # (R, ns) or (ns,)
        # the window is 0 at both ends, so interp's clamping is jnp.interp's left = right = 0
        precision = interp(s[..., self._span], *self._window)
        center = interp(s, self._window[0][2:-2], 1.0 - self._window[1][2:-2])
        solver = LeastSquareSolver(self._model[:, self._span], precision=precision)
        params = solver(self.xi[:, self._span])
        self.xinow = self.xi * (1.0 - center) + (params @ self._model) * center


def PowerSpectrumBAOFilter(pk_interpolator, engine='wallish2018', **kwargs):
    """Run the power-spectrum BAO filter named ``engine``."""
    engine = engine.lower()
    try:
        cls = _PK_FILTER_REGISTRY[engine]
    except KeyError:
        raise ValueError(f'Power spectrum BAO filter {engine} is unknown '
                         f'(available: {sorted(_PK_FILTER_REGISTRY)})')
    return cls(pk_interpolator, **kwargs)


def CorrelationFunctionBAOFilter(xi_interpolator, engine='kirkby2013', **kwargs):
    """Run the correlation-function BAO filter named ``engine``."""
    engine = engine.lower()
    try:
        cls = _XI_FILTER_REGISTRY[engine]
    except KeyError:
        raise ValueError(f'Correlation function BAO filter {engine} is unknown '
                         f'(available: {sorted(_XI_FILTER_REGISTRY)})')
    return cls(xi_interpolator, **kwargs)
