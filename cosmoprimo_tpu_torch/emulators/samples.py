"""Sample containers and samplers for emulator training
(cosmoprimo_tpu/emulators/samples.py): the :class:`Samples` dict-of-arrays
with attrs and its files, .npy (everywhere) and .h5 (where h5py is
installed), and the samplers, whose points are numpy and equal the JAX
package's.

Batch-first: a sampler calls its calculator once per chunk of rows, with
each parameter a (n,) float64 tensor on the sampler's device, and the
calculator returns each output as (n,) + its shape. A chunk that raises
:class:`CalculatorComputationError` is evaluated again row by row, so that
only its failing points become NaN rows, as the JAX package's per-point
loop records them.
"""

import json
import os
import re

import numpy as np
import torch

from .. import utils
from ..parallel.distributed import get_comm, rank_device, split_ranks


class CalculatorComputationError(Exception):
    """Error raised by a calculator for a given input; a sampler records
    NaN for this point and continues."""


def _import_h5py(filename):
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(f'reading or writing {filename} needs h5py, which is not installed; '
                          'use a .npy file') from exc
    return h5py


class Samples(dict):
    """Dictionary of numpy arrays (leading axis = sample index) with
    attributes.

    Columns follow the reference convention: 'X.<param>' for inputs,
    'Y.<name>' for calculator outputs.
    """

    def __init__(self, data=None, attrs=None):
        super().__init__(data or {})
        self.attrs = dict(attrs or {})

    @property
    def size(self):
        for value in self.values():
            return len(value)
        return 0

    def columns(self, pattern=None):
        names = list(self.keys())
        if pattern is None:
            return names
        regex = re.compile(pattern.replace('.', r'\.').replace('*', '.*') + '$')
        return [name for name in names if regex.match(name)]

    def select(self, index):
        return Samples({name: np.asarray(value)[index] for name, value in self.items()}, attrs=dict(self.attrs))

    def isfinite(self):
        """Mask of samples with all-finite entries."""
        mask = np.ones(self.size, dtype=bool)
        for value in self.values():
            value = np.asarray(value)
            mask &= np.isfinite(value).reshape(len(value), -1).all(axis=-1)
        return mask

    @classmethod
    def concatenate(cls, samples_list):
        samples_list = [s for s in samples_list if s is not None and s.size]
        if not samples_list:
            return cls()
        names = samples_list[0].keys()
        data = {name: np.concatenate([np.asarray(s[name]) for s in samples_list], axis=0) for name in names}
        attrs = dict(samples_list[0].attrs)
        return cls(data, attrs=attrs)

    def write(self, filename):
        filename = str(filename)
        utils.mkdir(os.path.dirname(filename))
        if filename.endswith(('.h5', '.hdf5')):
            h5py = _import_h5py(filename)
            with h5py.File(filename, 'w') as f:
                for name, value in self.items():
                    f.create_dataset(name, data=np.asarray(value))
                f.attrs['__attrs__'] = json.dumps(utils._prepare_for_json(self.attrs))
        else:
            np.save(filename, {'data': {name: np.asarray(value) for name, value in self.items()},
                               'attrs': self.attrs}, allow_pickle=True)

    save = write

    @classmethod
    def read(cls, filename):
        filename = str(filename)
        if filename.endswith(('.h5', '.hdf5')):
            h5py = _import_h5py(filename)
            with h5py.File(filename, 'r') as f:
                data = {name: f[name][...] for name in f.keys()}
                attrs = utils._restore_from_json(json.loads(str(f.attrs.get('__attrs__', '{}'))))
            return cls(data, attrs=attrs)
        state = np.load(filename, allow_pickle=True)[()]
        return cls(state['data'], attrs=state.get('attrs', {}))

    load = read


def resolve_device(device=None):
    """``device`` as tensors report it, or the CUDA card; without one,
    raise: an entry point never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card by default; pass device='cpu' to run on "
                               'the CPU')
        device = 'cuda'
    return torch.empty(0, device=device).device


def calculator_device(calculator, device=None):
    """The device a calculator is called on: ``device``, else the
    calculator's own (``get_calculator`` gives its cosmology's), else the
    CUDA card (:func:`resolve_device`)."""
    return resolve_device(device if device is not None else getattr(calculator, 'device', None))


def evaluate_rows(calculator, points, device, reparam=None):
    """The outputs of the batch-first ``calculator`` at ``points`` (name ->
    (n,) numpy array), through ``reparam``, as numpy arrays of (n,) + their
    shape; raises what the calculator raises."""
    n = len(next(iter(points.values())))
    X = {name: torch.as_tensor(np.asarray(value, dtype=np.float64), device=device) for name, value in points.items()}
    state = calculator(**(reparam(dict(X)) if reparam is not None else X))
    out = {}
    for name, value in state.items():
        value = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        if value.shape[:1] != (n,):
            raise ValueError(f'the calculator returned {name!r} of shape {value.shape}: a batch-first calculator leads '
                             f'each output with the number of rows, {n}')
        out[name] = value
    return out


class RQuasiRandomSequence(object):
    """R-sequence quasi-random generator (additive recurrence with the
    generalized golden ratio), matching the reference's 'rqrs' engine."""

    def __init__(self, d, seed=0.5):
        self.d = int(d)
        self.seed = float(seed)
        phi = 2.0
        for _ in range(100):
            phi = (1 + phi) ** (1.0 / (self.d + 1))
        self.alpha = ((1.0 / phi) ** np.arange(1, d + 1)) % 1.0
        self._index = 0

    def random(self, n=1):
        idx = self._index + np.arange(1, n + 1)
        self._index += n
        return (self.seed + idx[:, None] * self.alpha) % 1.0


def _get_qmc_engine(engine, d, seed=None):
    if engine == 'rqrs':
        return RQuasiRandomSequence(d)
    from scipy.stats import qmc
    return {'sobol': qmc.Sobol, 'halton': qmc.Halton, 'lhs': qmc.LatinHypercube}[engine](d=d, seed=seed)


# rows a sampler gives its calculator in one call, unless told otherwise
CHUNK_SIZE = 1024


class BaseSampler(object):
    """Evaluate a batch-first ``calculator(**params) -> dict`` over sample
    points, ``chunk_size`` rows a call on ``device`` (by default the
    calculator's, else the CUDA card); failures become NaN rows; results
    gathered on rank 0."""

    def __init__(self, calculator, params, save_fn=None, save_every=100, comm=None, reparam=None,
                 chunk_size=CHUNK_SIZE, device=None):
        self.calculator = calculator
        self.params = dict(params)
        self.save_fn = save_fn
        self.save_every = int(save_every)
        self.comm = comm if comm is not None else get_comm()
        # optional transform of a chunk's points (name -> (n,) tensor) before
        # the calculator; the X columns record the *sampled* coordinates (e.g.
        # sampling theta_MC_100 while the calculator takes h). It may raise
        # CalculatorComputationError, which sends the chunk row by row.
        self.reparam = reparam if reparam is not None else (lambda x: x)
        self.chunk_size = int(chunk_size)
        self.device = device
        self.samples = None

    def _device(self):
        """The device of this rank's chunks: the sampler's, else the
        calculator's, else this rank's card (:func:`rank_device`, with
        more than one rank) or the CUDA card."""
        if self.device is None and getattr(self.calculator, 'device', None) is None and self.comm.Get_size() > 1:
            return rank_device(self.comm.Get_rank())
        return calculator_device(self.calculator, self.device)

    def _evaluate(self, points, lo, hi):
        """[(points, outputs or None)] of rows lo:hi: one call for the
        chunk, or one a row if the chunk raises."""
        device = self._device()
        chunk = {name: value[lo:hi] for name, value in points.items()}
        try:
            return [(chunk, evaluate_rows(self.calculator, chunk, device, reparam=self.reparam))]
        except CalculatorComputationError:
            if hi - lo == 1:
                return [(chunk, None)]
        blocks = []
        for i in range(lo, hi):
            blocks += self._evaluate(points, i, i + 1)
        return blocks

    def _run_points(self, points, start=0):
        """points: dict name -> (n,) array; evaluated by this process,
        starting at local index ``start`` (resume support). Intermediate
        results are checkpointed after each chunk that completes a multiple
        of ``save_every`` points, when a ``save_fn`` is set."""
        n = len(next(iter(points.values()))) if points else 0
        blocks, template, done = [], None, 0
        for lo in range(start, n, self.chunk_size):
            hi = min(lo + self.chunk_size, n)
            blocks += self._evaluate(points, lo, hi)
            if template is None:
                template = next(({name: value.shape[1:] for name, value in state.items()}
                                 for _, state in blocks if state is not None), None)
            before, done = done, done + hi - lo
            if self.save_fn is not None and self.save_every and done // self.save_every > before // self.save_every:
                self._checkpoint(blocks, template)
        if template is None:
            raise ValueError('All calculator evaluations failed')
        return self._collect(blocks, template, start=start)

    @staticmethod
    def _collect(blocks, template, start=0):
        data = {'X.' + name: np.concatenate([chunk[name] for chunk, _ in blocks]) for name in blocks[0][0]}
        for name, shape in template.items():
            data['Y.' + name] = np.concatenate([state[name] if state is not None
                                                else np.full((len(next(iter(chunk.values()))),) + shape, np.nan)
                                                for chunk, state in blocks])
        samples = Samples(data)
        samples.attrs['start'] = start
        return samples

    def _checkpoint(self, blocks, template):
        if template is None:
            return
        rank = self.comm.Get_rank()
        fn = str(self.save_fn)
        if self.comm.Get_size() > 1:
            base, dot, ext = fn.rpartition('.')
            fn = f'{base}.rank{rank}{dot}{ext}' if dot else f'{fn}.rank{rank}'
        self._collect(blocks, template).write(fn + '.progress.npy' if not fn.endswith('.npy') else fn)

    def run(self, resume_from=None, **kwargs):
        """Evaluate all points (block-distributed over processes); pass
        ``resume_from`` (a Samples checkpoint, or its file) to continue an
        interrupted run without recomputing finished points."""
        points = self.points(**kwargs)
        rank, size = self.comm.Get_rank(), self.comm.Get_size()
        n = len(next(iter(points.values())))
        index = split_ranks(n, rank, size)
        local_points = {name: np.asarray(value)[index] for name, value in points.items()}
        prior = None
        start = 0
        if resume_from is not None:
            prior = resume_from if isinstance(resume_from, Samples) else Samples.read(resume_from)
            start = prior.size
        local = self._run_points(local_points, start=start)
        if prior is not None:
            local = Samples.concatenate([prior, local])
        gathered = self.comm.gather(local, root=0)
        if rank == 0:
            self.samples = Samples.concatenate(gathered)
            if self.save_fn is not None:
                self.samples.write(self.save_fn)
        return self.samples

    def points(self, **kwargs):
        raise NotImplementedError


class InputSampler(BaseSampler):
    """Evaluate at explicitly provided points (dict of arrays)."""

    def __init__(self, calculator, samples=None, params=None, **kwargs):
        self._input_points = {name: np.asarray(value) for name, value in (samples or {}).items()}
        params = params if params is not None else {name: None for name in self._input_points}
        super().__init__(calculator, params, **kwargs)

    def points(self, **kwargs):
        return dict(self._input_points)


class GridSampler(BaseSampler):
    """Regular grid over parameter limits (``ngrid`` points per axis)."""

    def points(self, ngrid=3):
        axes = []
        for name, limits in self.params.items():
            if limits is None or np.ndim(limits) == 0:
                axes.append(np.atleast_1d(limits if limits is not None else 0.0))
            else:
                axes.append(np.linspace(limits[0], limits[1], ngrid))
        mesh = np.meshgrid(*axes, indexing='ij')
        return {name: m.ravel() for name, m in zip(self.params, mesh)}


class DiffSampler(BaseSampler):
    """Finite-difference stencil points around the parameter-box center, for
    Taylor-expansion emulators."""

    def points(self, order=3, accuracy=2):
        center, deltas = {}, {}
        for name, limits in self.params.items():
            limits = np.asarray(limits, dtype=np.float64)
            center[name] = limits.mean()
            # stencil step: spread the needed points over the limits
            nsteps = (order + accuracy // 2 * 2 - 1) // 2
            deltas[name] = (limits[1] - limits[0]) / 2.0 / max(nsteps, 1)
        names = list(self.params)
        offsets = np.arange(-(order + accuracy // 2 * 2 - 1) // 2, (order + accuracy // 2 * 2 - 1) // 2 + 1)
        grids = [center[name] + offsets * deltas[name] for name in names]
        mesh = np.meshgrid(*grids, indexing='ij')
        points = {name: m.ravel() for name, m in zip(names, mesh)}
        self.center = center
        self.deltas = deltas
        self.offsets = offsets
        return points


class QMCSampler(BaseSampler):
    """Quasi-Monte-Carlo sampling of the parameter box ('sobol', 'halton',
    'lhs' via scipy.stats.qmc, or the dependency-free 'rqrs' sequence)."""

    def __init__(self, calculator, params, engine='rqrs', seed=None, **kwargs):
        super().__init__(calculator, params, **kwargs)
        self.engine_name = engine
        self.seed = seed

    def points(self, niterations=300):
        engine = _get_qmc_engine(self.engine_name, len(self.params), seed=self.seed)
        unit = engine.random(int(niterations))
        points = {}
        for i, (name, limits) in enumerate(self.params.items()):
            limits = np.asarray(limits, dtype=np.float64)
            points[name] = limits[0] + unit[:, i] * (limits[1] - limits[0])
        return points
