"""General utilities (the part of cosmoprimo_tpu/utils.py this port needs):
``addproperty`` and the constrained least-squares solver."""

import numpy as np
import torch


def addproperty(*attrs):
    """Class decorator adding read-only properties exposing ``self._<attr>``."""

    def decorator(cls):
        def make_prop(name):
            return property(lambda self: getattr(self, '_' + name))
        for attr in attrs:
            setattr(cls, attr, make_prop(attr))
        return cls

    return decorator


class LeastSquareSolver(object):
    r"""Linear least squares with optional linear equality constraints,
    solved through the bordered (KKT) system:

    minimize :math:`(d - G^T x)^T P (d - G^T x)` subject to :math:`C^T x = c`.

    ``gradient`` G is (nbasis, ndata) and static. The precision P is
    diagonal: a scalar, (ndata,), or one diagonal per row (..., ndata). The
    constraint gradient C is (nbasis, nconstraints), or one per row
    (..., nbasis, nconstraints). With a per-row precision or constraint the
    system is a batch of small (nbasis + nconstraints)^2 matrices, inverted
    together. Tensors go to the device of the first tensor argument, else
    to ``device``, else the CPU.
    """

    def __init__(self, gradient, precision=1.0, constraint_gradient=None, device=None):
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
        self._x = None

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
        return self._x

    @staticmethod
    def _apply(matrix, vector):
        """``matrix`` (shared, or one per row) times the rows of ``vector``."""
        return vector @ matrix.T if matrix.dim() == 2 else (matrix @ vector[..., None])[..., 0]

    def model(self):
        """Best-fit model G^T x of the last solve: (..., ndata)."""
        return self._x @ self.gradient


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
