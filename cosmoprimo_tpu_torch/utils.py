"""General utilities (cosmoprimo_tpu/utils.py): ``addproperty``, the state
files (``write_state``, ``read_state``), the constrained least-squares
solver, the distance-to-redshift inversion and the profiler's trace
(``profile_trace``)."""

import contextlib
import json
import os

import numpy as np
import torch

from . import tracing
from .ops import Interpolator1D, cubic_eval_rows, interp, natural_cubic_coeffs_rows


def mkdir(dirname):
    if dirname:
        os.makedirs(dirname, exist_ok=True)


def addproperty(*attrs):
    """Class decorator adding read-only properties exposing ``self._<attr>``."""

    def decorator(cls):
        def make_prop(name):
            return property(lambda self: getattr(self, '_' + name))
        for attr in attrs:
            setattr(cls, attr, make_prop(attr))
        return cls

    return decorator


def _prepare_for_json(state):
    """Arrays (numpy, or tensors) in ``state`` as JSON objects, recursively:
    the JAX package's format."""
    if isinstance(state, dict):
        return {key: _prepare_for_json(value) for key, value in state.items()}
    if isinstance(state, (list, tuple)):
        return [_prepare_for_json(value) for value in state]
    if isinstance(state, torch.Tensor):
        state = state.detach().cpu().numpy()
    if isinstance(state, np.ndarray):
        return {'__array__': state.tolist(), 'dtype': str(state.dtype)}
    if isinstance(state, np.generic):
        return state.item()
    return state


def _restore_from_json(state):
    if isinstance(state, dict):
        if '__array__' in state:
            return np.array(state['__array__'], dtype=state['dtype'])
        return {key: _restore_from_json(value) for key, value in state.items()}
    if isinstance(state, list):
        return [_restore_from_json(value) for value in state]
    return state


def write_state(filename, state):
    """Write ``state`` (a dict of numpy arrays and Python values) as JSON
    if ``filename`` ends in '.json', else with ``np.save``; the files of
    the JAX package's ``write_state``."""
    filename = str(filename)
    mkdir(os.path.dirname(filename))
    if filename.endswith('.json'):
        with open(filename, 'w') as file:
            json.dump(_prepare_for_json(state), file)
    else:
        np.save(filename, state, allow_pickle=True)


def read_state(filename):
    """The state that :func:`write_state` (of either package) wrote."""
    filename = str(filename)
    if filename.endswith('.json'):
        with open(filename, 'r') as file:
            return _restore_from_json(json.load(file))
    return np.load(filename, allow_pickle=True)[()]


class DistanceToRedshift(object):
    """Redshift of a distance, inverting the monotonic ``distance(z)`` by a
    natural cubic spline (``interp_order`` = 3) or linearly (else) in z
    against the distance, at the redshifts 0 and ``nz - 1`` geometric ones
    from 1e-8 to ``zmax``; NaN outside them.

    ``distance`` takes the (nz,) z grid as a CPU tensor (the port's
    background methods move it to their device) and returns (nz,) for one
    cosmology (shared knots, :class:`~ops.Interpolator1D`) or batch + (nz,)
    for a batch (knots per row: the tridiagonal solves of
    :func:`~ops.natural_cubic_coeffs_rows`), on the device where the
    inversion then runs."""

    def __init__(self, distance, zmax=100.0, nz=2048, interp_order=3):
        zgrid = torch.from_numpy(np.concatenate([[0.0], np.geomspace(1e-8, zmax, nz - 1)]))
        self.dgrid = distance(zgrid)
        self.zgrid = zgrid.to(self.dgrid.device)
        self._cubic = interp_order == 3
        if self.dgrid.dim() == 1:
            self._interp = Interpolator1D(self.dgrid, self.zgrid, k=interp_order, assume_sorted=True)
        elif self._cubic:
            self._M = natural_cubic_coeffs_rows(self.dgrid, self.zgrid)

    def __call__(self, distance):
        """z at ``distance``: of its shape for one cosmology; for a batch,
        ``distance`` broadcasts against batch + (m,) (the last axis holds
        each row's queries) and so does the result."""
        distance = torch.as_tensor(distance, dtype=torch.float64, device=self.zgrid.device)
        if self.dgrid.dim() == 1:
            return self._interp(distance)
        shape = torch.broadcast_shapes(distance.shape, self.dgrid.shape[:-1] + (1,))
        distance = distance.expand(shape)
        if self._cubic:
            z = cubic_eval_rows(self.dgrid, self.zgrid, self._M, distance)
        else:
            z = interp(distance, self.dgrid, self.zgrid)
        inside = (distance >= self.dgrid[..., :1]) & (distance <= self.dgrid[..., -1:])
        return torch.where(inside, z, torch.nan)


class LeastSquareSolver(object):
    r"""Linear least squares with optional linear equality constraints,
    solved through the bordered (KKT) system:

    minimize :math:`(d - G^T x)^T P (d - G^T x)` subject to :math:`C^T x = c`.

    ``gradient`` G is (nbasis, ndata) and static. The precision P is
    diagonal: a scalar, (ndata,), or one diagonal per row (..., ndata). The
    constraint gradient C is (nbasis, nconstraints), or one per row
    (..., nbasis, nconstraints). With a per-row precision or constraint the
    system is a batch of small (nbasis + nconstraints)^2 matrices, inverted
    together. ``compute_inverse`` is accepted for the reference signature
    and ignored: the system is always inverted, as in the reference. Tensors
    go to the device of the first tensor argument, else to ``device``, else
    the CPU.
    """

    def __init__(self, gradient, precision=1.0, constraint_gradient=None, compute_inverse=True, device=None):
        for value in (gradient, precision, constraint_gradient):
            if isinstance(value, torch.Tensor):
                device = value.device
                break

        def tensor(value):
            if isinstance(value, np.ndarray):
                value = np.ascontiguousarray(value)
            return torch.as_tensor(value, dtype=torch.float64, device=device)

        self.gradient = torch.atleast_2d(tensor(gradient))
        self.precision = tensor(precision)
        # G P, then the Fisher matrix (G P) G^T: (..., nbasis, ndata), (..., nbasis, nbasis)
        self._gp = self.gradient * self.precision[..., None, :] if self.precision.dim() else self.gradient * self.precision
        fisher = self._gp @ self.gradient.T
        self.constraint_gradient = None
        if constraint_gradient is not None:
            C = tensor(constraint_gradient)
            C = C.reshape(C.shape[:-1] + (1,)) if C.dim() == 1 else C
            self.constraint_gradient = C
            batch = torch.broadcast_shapes(fisher.shape[:-2], C.shape[:-2])
            nbasis, ncon = C.shape[-2:]
            zero = fisher.new_zeros(batch + (ncon, ncon))
            # bordered (KKT) system [[F, -C], [C^T, 0]]
            fisher = torch.cat([torch.cat([fisher.expand(batch + (nbasis, nbasis)), -C.expand(batch + C.shape[-2:])], dim=-1),
                                torch.cat([C.mT.expand(batch + (ncon, nbasis)), zero], dim=-1)], dim=-2)
        self._system = fisher
        self._inverse = torch.linalg.inv(fisher)
        self._x = self._d = None

    def __call__(self, delta, constraint=None):
        """Coefficients (..., nbasis) for the data ``delta`` (..., ndata) and
        the constraint values ``constraint`` (..., nconstraints)."""
        delta = torch.as_tensor(delta, dtype=torch.float64, device=self.gradient.device)
        if self._gp.dim() == 2:
            rhs = delta @ self._gp.T
        else:
            rhs = (self._gp @ delta[..., None])[..., 0]
        nbasis = self.gradient.shape[0]
        if self.constraint_gradient is not None:
            ncon = self.constraint_gradient.shape[-1]
            if constraint is None:
                constraint = rhs.new_zeros(ncon)
            constraint = torch.as_tensor(constraint, dtype=torch.float64, device=rhs.device)
            batch = torch.broadcast_shapes(rhs.shape[:-1], constraint.shape[:-1])
            rhs = torch.cat([rhs.expand(batch + rhs.shape[-1:]), constraint.expand(batch + (ncon,))], dim=-1)
        # one step of iterative refinement: a bordered system can be ill-conditioned
        # (cond 5e12 for a degree-12 fit), and the inverse alone then loses ~1e-9
        sol = self._apply(self._inverse, rhs)
        sol = sol + self._apply(self._inverse, rhs - self._apply(self._system, sol))
        self._x = sol[..., :nbasis]
        self._d = delta
        return self._x

    @property
    def coefficients(self):
        """The coefficients (..., nbasis) of the last solve."""
        return self._x

    @staticmethod
    def _apply(matrix, vector):
        """``matrix`` (shared, or one per row) times the rows of ``vector``."""
        return vector @ matrix.T if matrix.dim() == 2 else (matrix @ vector[..., None])[..., 0]

    def model(self):
        """Best-fit model G^T x of the last solve: (..., ndata)."""
        return self._x @ self.gradient

    def chi2(self):
        """(d - G^T x)^T P (d - G^T x) of the last solve: (...)."""
        resid = self._d - self.model()
        return torch.sum(resid * self.precision * resid, dim=-1)


def _solve_longdouble(system, rhs):
    """Gauss-Jordan elimination with partial pivoting in numpy's long double."""
    a = np.concatenate([system, rhs], axis=1).astype(np.longdouble)
    n = system.shape[0]
    for i in range(n):
        p = i + int(np.argmax(np.abs(a[i:, i])))
        a[[i, p]] = a[[p, i]]
        a[i] /= a[i, i]
        others = np.arange(n) != i
        a[others] -= a[others, i:i + 1] * a[i]
    return a[:, n:]


def fit_operator(gradient, precision, constraint_gradient):
    """The constrained least-squares fit of :class:`LeastSquareSolver` with
    a static design as one linear map: the model G^T x for the data d
    (..., ndata) and the constraint values c (..., nconstraints) is
    ``d @ A.T + c @ Bc.T``. A (ndata, ndata) and Bc (ndata, nconstraints)
    are made on the host in numpy's long double, so that the cancellations
    of an ill-conditioned bordered system (cond 5.3e12 for the degree-12 fit
    of hinton2017) happen there: applied in float64 the model keeps ~1e-14,
    where the float64 inverse of the system loses ~1e-9."""
    G = np.asarray(gradient, dtype=np.longdouble)
    w = np.asarray(precision, dtype=np.longdouble)
    C = np.asarray(constraint_gradient, dtype=np.longdouble)
    (nbasis, ndata), ncon = G.shape, C.shape[1]
    system = np.zeros((nbasis + ncon, nbasis + ncon), dtype=np.longdouble)
    system[:nbasis, :nbasis], system[:nbasis, nbasis:], system[nbasis:, :nbasis] = (G * w) @ G.T, -C, C.T
    rhs = np.zeros((nbasis + ncon, ndata + ncon), dtype=np.longdouble)
    rhs[:nbasis, :ndata], rhs[nbasis:, ndata:] = G * w, np.eye(ncon)
    model = G.T @ _solve_longdouble(system, rhs)[:nbasis]
    return model[:, :ndata].astype(np.float64), model[:, ndata:].astype(np.float64)


def setup_logging(level='info'):
    """Logging to standard output at ``level`` ('debug', 'info', ...), each
    line prefixed with the process's rank when torch.distributed runs more
    than one process."""
    import logging
    import sys
    rank = None
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        rank = torch.distributed.get_rank()
    fmt = '[%(asctime)s] %(levelname)s %(name)s: %(message)s'
    if rank is not None:
        fmt = f'[rank {rank}] ' + fmt
    logging.basicConfig(level=getattr(logging, level.upper()), format=fmt, datefmt='%m-%d %H:%M', stream=sys.stdout,
                        force=True)


@contextlib.contextmanager
def profile_trace(dirname='cosmoprimo-trace'):
    """Context manager profiling its block with ``torch.profiler`` (the CPU,
    and CUDA where there is a card) with the program's spans on
    (:mod:`tracing`). On exit it writes ``dirname/trace.json``, a
    Chrome/Perfetto trace that holds the spans, and beside it
    ``dirname/counters.json``, the program's counters
    (``tracing.counters``, the counts by shape keyed by
    'rows,size,padded,nparallel'). Yields ``dirname``."""
    mkdir(dirname)
    with tracing.profile() as prof:
        yield dirname
    prof.export_chrome_trace(os.path.join(dirname, 'trace.json'))
    counters = {name: {','.join(map(str, shape)): n for shape, n in value.items()} if isinstance(value, dict)
                else value for name, value in tracing.counters.items()}
    with open(os.path.join(dirname, 'counters.json'), 'w') as f:
        json.dump(counters, f, indent=1)


def savefig(filename, fig=None, bbox_inches='tight', pad_inches=0.1, dpi=200, **kwargs):
    """Save and close a matplotlib figure (the current one by default),
    making its directory; matplotlib is imported here, when it is needed.
    Returns the figure."""
    from matplotlib import pyplot as plt
    mkdir(os.path.dirname(str(filename)))
    if fig is None:
        fig = plt.gcf()
    fig.savefig(str(filename), bbox_inches=bbox_inches, pad_inches=pad_inches, dpi=dpi, **kwargs)
    plt.close(fig)
    return fig
