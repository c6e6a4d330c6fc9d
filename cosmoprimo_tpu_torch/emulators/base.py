"""Emulator orchestration and files (cosmoprimo_tpu/emulators/base.py):
the per-quantity engines' registry, their fits and predictions through
their x/y operation chains, the :class:`Emulator` that classifies a
calculator's outputs, attaches samples, fits one engine per varied output
and serves them, and its .npy / .h5 files, in the JAX package's format
both ways.

Batch-first: a prediction takes parameters of a batch shape (tensors, or
Python numbers) and returns batch + the quantity's shape. The operation
expressions describe one cosmology, so each engine evaluates its chain
under ``torch.func.vmap`` over the batch (:func:`batch_vmap`), when it fits
as when it predicts; that also composes with ``torch.func.jvp`` /
``jacfwd``. The emulator-level typed operations take the whole batch.
Fits run on the emulator's ``device``: the CUDA card unless the caller
names another.
"""

import copy
import fnmatch
import inspect
import json
import os
import warnings

import numpy as np
import torch

from .. import utils
from ..parallel.distributed import get_comm
from .operations import (Operation, _DeviceCached, _device_of, _to_device, canonical_device, get_operation,
                         in_forward_transform)
from .samples import Samples, _import_h5py, calculator_device, resolve_device


def make_list(li):
    if li is None:
        return []
    if not isinstance(li, (tuple, list)):
        li = [li]
    return list(li)


def find_names(allnames, patterns):
    """Expand wildcard patterns against available names (order-preserving)."""
    patterns = make_list(patterns)
    toret = []
    for pattern in patterns:
        for name in allnames:
            if fnmatch.fnmatch(name, pattern) and name not in toret:
                toret.append(name)
    return toret


def expand_dict(di, names):
    """Map each name to the value of the LAST matching (wildcard) key, so
    later, more specific patterns override earlier globs."""
    toret = {name: None for name in names}
    for pattern, value in di.items():
        for name in find_names(names, pattern):
            toret[name] = value
    return toret


# the rows of one vmapped prediction are evaluated in chunks whose output
# stays within this many bytes: a batch of 4096 Fourier tables (12 660
# values a row) is one chunk, and a larger batch does not grow the peak
PREDICT_CHUNK_BYTES = 2 ** 30


def batch_vmap(func, *vargs, batch_size=None, **vkwargs):
    """``torch.func.vmap`` of ``func`` over the leading axis, ``batch_size``
    rows at a time (all at once if None): bounds peak memory when mapping
    big emulator batches. ``vargs``/``vkwargs`` go to ``torch.func.vmap``
    (``in_dims``, ...)."""
    return torch.func.vmap(func, *vargs, chunk_size=batch_size, **vkwargs)


def _params_device(params):
    """The device of a prediction: that of the first tensor among
    ``params``, else the CUDA card; without one, raise (an entry point
    never falls back to the CPU silently)."""
    device = _device_of(params)
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port runs on the card by default; pass the parameters as CPU '
                           'tensors to predict on the CPU')
    return canonical_device('cuda')


def map_rows(func, *arrays, device):
    """``func`` of one row of each of ``arrays`` (numpy, leading axis the
    rows), under ``torch.func.vmap`` on ``device``, rows chunked as in
    :meth:`BaseEmulatorEngine.predict`: numpy, rows + the output's shape."""
    tensors = [torch.as_tensor(np.asarray(array, dtype=np.float64), device=device) for array in arrays]
    size = max(int(np.prod(tensors[0].shape[1:])), 1)
    out = batch_vmap(func, batch_size=max(PREDICT_CHUNK_BYTES // (8 * size), 1))(*tensors)
    return out.cpu().numpy()


_ENGINE_REGISTRY = {}


def register_emulator_engine(cls):
    _ENGINE_REGISTRY[cls.name] = cls
    return cls


def _import_engine_module(name):
    if name == 'mlp':
        from . import mlp  # noqa: F401
    elif name == 'taylor':
        from . import taylor  # noqa: F401


def get_engine(engine):
    """Resolve str / class / instance to an emulator engine instance."""
    if isinstance(engine, str):
        engine = engine.lower()
        _import_engine_module(engine)
        try:
            engine = _ENGINE_REGISTRY[engine]()
        except KeyError:
            raise ValueError(f'Unknown engine {engine}.')
    if isinstance(engine, type):
        engine = engine()
    return engine


class BaseEmulatorEngine(_DeviceCached):
    """Base per-quantity emulator engine. Subclasses implement
    ``_predict_no_operation`` for one cosmology."""

    name = 'base'

    def __init__(self, xoperation=None, yoperation=None, attrs=None):
        self.xoperations = [get_operation(op) for op in make_list(xoperation)]
        self.yoperations = [get_operation(op) for op in make_list(yoperation)]
        self.attrs = dict(attrs or {})

    def initialize(self, params, comm=None, device=None):
        """Set the input names, the communicator and the device the fit
        runs on (None: the CUDA card)."""
        self.params = list(params)
        self.comm = comm if comm is not None else get_comm()
        self.device = device

    def get_default_samples(self, calculator, params, **kwargs):
        raise NotImplementedError

    def fit(self, X, Y, attrs, **kwargs):
        """Initialize the y then the x operations on the samples (numpy X
        (n, nparams), Y (n,) + yshape), apply them row by row under
        ``torch.func.vmap`` on the engine's device (the y operations see
        each row's parameters as ``X``), and fit the flattened rows."""
        X, Y = np.asarray(X), np.asarray(Y)
        device = resolve_device(self.device)
        for operation in self.yoperations:
            operation.initialize(Y)
            Y = map_rows(lambda y, x: operation(y, X={name: x[i] for i, name in enumerate(self.params)}), Y, X,
                         device=device)
        for operation in self.xoperations:
            operation.initialize(X)
            X = map_rows(operation, X, device=device)
        self.xshape, self.yshape = X.shape[1:], Y.shape[1:]
        X, Y = X.reshape(len(X), -1), Y.reshape(len(Y), -1)
        self._fit_no_operation(X, Y, attrs, **kwargs)
        self.__dict__.pop('_device_cache', None)

    def _fit_no_operation(self, X, Y, attrs):
        raise NotImplementedError

    def _operations(self):
        return self.xoperations + self.yoperations

    def to(self, device):
        """Copy the state's arrays and the operations' locals to ``device``
        once (see :meth:`Operation.to`)."""
        device = canonical_device(device)
        self._on(device)
        for operation in self._operations():
            operation.to(device)
        return self

    def predict(self, params, kw_yoperation=None):
        """The quantity at ``params`` (name -> tensor of the batch shape, or
        a number; the names of :attr:`params` are needed, the others are
        passed to the y operations as ``X``): batch + yshape, on the
        parameters' device. Each row goes through the x operations,
        ``_predict_no_operation`` and the y operations' inverses with its own
        ``X``, under ``torch.func.vmap``."""
        device = _params_device(params)
        values = [torch.as_tensor(params[name], dtype=torch.float64, device=device) for name in self.params]
        batch = torch.broadcast_shapes(*(value.shape for value in values))
        x = torch.stack([value.expand(batch) for value in values], dim=-1).reshape(-1, len(values))
        rows, shared = {}, {}
        for name, value in params.items():
            if isinstance(value, torch.Tensor) and value.dim() and value.shape == batch:
                rows[name] = value.reshape(-1)
            else:
                shared[name] = value
        kw_yoperation = kw_yoperation or {}
        yshape = tuple(self.yshape)

        def one(x, rows):
            X = {**shared, **rows}
            for operation in self.xoperations:
                x = operation(x)
            y = self._predict_no_operation(x.reshape(-1)).reshape(yshape)
            for operation in self.yoperations[::-1]:
                y = operation.inverse(y, X=X, **kw_yoperation)
            return y

        chunk = max(PREDICT_CHUNK_BYTES // (8 * max(int(np.prod(yshape)), 1)), 1)
        out = batch_vmap(one, batch_size=chunk)(x, rows)
        return out.reshape(batch + out.shape[1:])

    def _predict_no_operation(self, X):
        raise NotImplementedError

    def copy(self):
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        # bypass __getstate__ (serialization form): keep live configuration
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        new.__dict__.update(copy.deepcopy({k: v for k, v in self.__dict__.items() if k != '_device_cache'}, memo))
        return new

    def __getstate__(self):
        state = {'name': self.name, 'attrs': self.attrs}
        for name in ['params', 'xshape', 'yshape']:
            if hasattr(self, name):
                state[name] = getattr(self, name)
        state['xoperations'] = [op.__getstate__() for op in self.xoperations]
        state['yoperations'] = [op.__getstate__() for op in self.yoperations]
        return state

    def __setstate__(self, state):
        self.__dict__.update({k: v for k, v in state.items() if k not in ('name', 'xoperations', 'yoperations')})
        self.xoperations = [Operation.from_state(s) for s in state.get('xoperations', [])]
        self.yoperations = [Operation.from_state(s) for s in state.get('yoperations', [])]

    @classmethod
    def from_state(cls, state):
        state = dict(state)
        name = state.pop('name')
        _import_engine_module(name)
        cls = _ENGINE_REGISTRY[name]
        new = cls.__new__(cls)
        BaseEmulatorEngine.__init__(new)
        new.__setstate__(state)
        return new


@register_emulator_engine
class PointEmulatorEngine(BaseEmulatorEngine):
    """Constant predictor (pipeline sanity check)."""

    name = 'point'
    _tensor_attrs = ('point',)

    def get_default_samples(self, calculator, params, **kwargs):
        from .samples import GridSampler
        sampler = GridSampler(calculator, params, device=self.device)
        return sampler.run(**kwargs)

    def _fit_no_operation(self, X, Y, attrs):
        self.point = np.asarray(Y[0])

    def _predict_no_operation(self, X):
        return self._on(X.device)['point']

    def __getstate__(self):
        state = super().__getstate__()
        if hasattr(self, 'point'):
            state['point'] = self.point
        return state


def _deep_eq(a, b):
    try:
        return np.array_equal(np.asarray(a), np.asarray(b))
    except Exception:
        return a == b


def _numpy(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else value


class Emulator(object):
    """Emulate a batch-first calculator ``f(**params) -> dict of arrays``:
    classify its varied and fixed outputs, fit one engine per varied
    output, serve predictions through the operation chains.

    The emulator-level operations are batch-first (see
    :class:`~cosmoprimo_tpu_torch.emulators.operations.SplitDerivedOperation`):
    ``X``'s values have the batch shape, each predicted value leads with it
    and a fixed value has none. Samples are taken on ``device`` (None: the
    calculator's, else the CUDA card); the operations and the fits run on
    ``device`` (None: the CUDA card).
    """

    def __init__(self, calculator=None, samples=None, engine=None, xoperation=None, yoperation=None, comm=None,
                 device=None, **kwargs):
        self.comm = comm if comm is not None else get_comm()
        self.device = device
        self.xoperations = [get_operation(op) for op in make_list(xoperation)]
        self.yoperations = [get_operation(op) for op in make_list(yoperation)]
        self.engines, self.defaults, self.fixed = {}, {}, {}
        self._input_engines, self._init_engines, self._samples = {}, {}, {}
        if engine is not None:
            self.set_engine(engine)
        if calculator is not None:
            self._calculator, self._params, self._varied, self._fixed = self._classify_calculator(
                calculator, params=kwargs.get('params', None))
        if samples is not None:
            self.set_samples(samples=samples, **{k: v for k, v in kwargs.items() if k != 'params'})

    # ------------------------------------------------------------- setup
    def set_engine(self, engine, update=True):
        if not hasattr(engine, 'items'):
            engine = {'*': engine}
        engines = {key: get_engine(eng) for key, eng in engine.items()}
        if update:
            self._input_engines.update(engines)
        else:
            self._input_engines = engines

    @staticmethod
    def _sort_varied_fixed(samples, subsample=None):
        varied, fixed = {}, {}
        index = slice(None)
        if subsample is not None:
            size = len(next(iter(samples.values())))
            rng = np.random.RandomState(seed=42)
            index = rng.choice(size, min(subsample, size), replace=False)
        for name, values in samples.items():
            values = np.asarray(values)[index]
            if all(_deep_eq(value, values[0]) for value in values):
                fixed[name] = values[0]
            else:
                varied[name] = values[0].shape
        return varied, fixed

    def _classify_calculator(self, calculator, params=None):
        """(calculator, params, varied, fixed) from one call at three points
        drawn in ``params``' boxes, the JAX package's RandomState(42)
        draws, as a batch of 3."""
        from .samples import evaluate_rows
        params = dict(params)
        sig = inspect.signature(calculator)
        self.defaults = {}
        for param in sig.parameters.values():
            if param.kind == param.POSITIONAL_OR_KEYWORD and param.default is not param.empty:
                self.defaults[param.name] = param.default
        rng = np.random.RandomState(seed=42)
        rows = [{param: rng.uniform(*limits) for param, limits in params.items()} for _ in range(3)]
        points = {param: np.array([row[param] for row in rows]) for param in params}
        state = evaluate_rows(calculator, points, calculator_device(calculator, self.device))
        varied, fixed = self._sort_varied_fixed(state)
        if not varied:
            raise ValueError('Found no varying quantity in provided calculator')
        return calculator, params, varied, fixed

    def set_samples(self, engine=None, samples=None, params=None, calculator=None, **kwargs):
        """Attach samples (computing them via the engines' default samplers
        if not provided) and instantiate per-quantity engines. The
        emulator-level y operations are initialized on the samples and
        applied to the whole batch on the emulator's device, in their
        forward direction; then the x operations. Returns (samples,
        processed samples)."""
        if engine is not None:
            self.set_engine(engine)

        if samples is None:
            if calculator is not None:
                calculator, params, varied, fixed = self._classify_calculator(calculator, params=params)
            else:
                calculator, params, varied, fixed = (getattr(self, name, None) for name in
                                                     ('_calculator', '_params', '_varied', '_fixed'))
            engines = expand_dict(self._input_engines, list(varied))
            for name, eng in engines.items():
                if eng is None:
                    raise ValueError(f'Engine not specified for varying attribute {name}')
                eng.initialize(params=params, comm=self.comm, device=self.device)
                samples = eng.get_default_samples(calculator, params=params, **kwargs)
                break
        else:
            samples = samples if isinstance(samples, Samples) else Samples.read(samples)
            if params is None:
                params = {name[2:]: None for name in samples.columns('X.*')}
            varied, fixed = self._sort_varied_fixed(
                {name[2:]: samples[name] for name in samples.columns('Y.*')}, subsample=10)

        notfinite = [name for name, value in samples.items() if not np.isfinite(np.asarray(value)).all()]
        if notfinite:
            warnings.warn(f'{notfinite} are not finite')

        # global x/y operations, batch-first
        X = {name[2:]: np.asarray(samples[name]) for name in samples.columns('X.*')}
        Y = {name[2:]: np.asarray(samples[name]) for name in samples.columns('Y.*')}
        if self.yoperations or self.xoperations:
            device = resolve_device(self.device)
        for operation in self.yoperations:
            operation.initialize({**fixed, **Y}, X=X)
            on = {name: _to_device(value, device) for name, value in {**fixed, **Y}.items()}
            out = operation(on, X={name: _to_device(value, device) for name, value in X.items()})
            Y = {name: _numpy(value) for name, value in out.items() if name not in fixed}
        for operation in self.xoperations:
            operation.initialize(X)
            X = {name: _numpy(value) for name, value in
                 operation({name: _to_device(value, device) for name, value in X.items()}).items()}

        self.fixed.update(fixed)
        params = list(X)
        processed = Samples({**{'X.' + name: X[name] for name in X}, **{'Y.' + name: Y[name] for name in Y}},
                            attrs=dict(samples.attrs))
        varied, _fixed2 = self._sort_varied_fixed(Y, subsample=10)
        self.fixed.update(_fixed2)

        engines = expand_dict(self._input_engines, list(varied))
        for name, eng in engines.items():
            if eng is None:
                raise ValueError(f'Engine not specified for varying attribute {name}')
            eng = eng.copy()
            eng.initialize(params=params, comm=self.comm, device=self.device)
            self._init_engines[name] = eng
            self._samples[name] = processed
        return samples, processed

    # ------------------------------------------------------------- fit / predict
    def fit(self, name=None, **kwargs):
        """Fit the engine of each varied output matching ``name`` (a
        pattern; all by default) on its samples; ``kwargs`` go to the
        engines' fits."""
        names = find_names(list(self._samples.keys()), name if name is not None else '*')
        for name in names:
            engine = self._init_engines[name].copy()
            samples = self._samples[name]
            X = np.column_stack([samples['X.' + p] for p in engine.params])
            Y = np.asarray(samples['Y.' + name])
            if not np.isfinite(X).all():
                raise ValueError('X is not finite')
            if not np.isfinite(Y).all():
                raise ValueError(f'{name} is not finite')
            engine.fit(X, Y, dict(samples.attrs), **kwargs)
            self.engines[name] = engine

    @property
    def params(self):
        params = []
        for engine in self.engines.values():
            params += [p for p in engine.params if p not in params]
        return params

    def to(self, device):
        """Copy every array the predictions use (the engines' states, the
        operations' locals, the fixed outputs) to ``device`` once."""
        device = canonical_device(device)
        for engine in self.engines.values():
            engine.to(device)
        for operation in self.xoperations + self.yoperations:
            operation.to(device)
        self.fixed_on(device)
        return self

    def fixed_on(self, device):
        """The fixed outputs as tensors on ``device``, copied there once
        (not inside a forward-mode transform)."""
        cache = self.__dict__.setdefault('_fixed_cache', {})
        if device in cache:
            return cache[device]
        tensors = {name: _to_device(np.asarray(value), device) for name, value in self.fixed.items()}
        if not in_forward_transform():
            cache[device] = tensors
        return tensors

    def predict(self, params, kw_yoperation=None):
        """Every output at ``params`` (name -> tensor of the batch shape, or
        a number): the fixed outputs as tensors on the parameters' device,
        each engine's batch + its shape, through the y operations."""
        params = {**self.defaults, **params}
        X = dict(params)
        for operation in self.xoperations:
            params = operation(params)
        predict = dict(self.fixed_on(_params_device(params)))
        predict.update({name: engine.predict(params) for name, engine in self.engines.items()})
        kw_yoperation = kw_yoperation or {}
        for operation in self.yoperations[::-1]:
            predict = operation.inverse(predict, X=X, **kw_yoperation)
        return predict

    def to_calculator(self):
        def calculator(**params):
            return self.predict(params)
        return calculator

    # ------------------------------------------------------------- io
    def __getstate__(self):
        return {'engines': {name: engine.__getstate__() for name, engine in self.engines.items()},
                'xoperations': [op.__getstate__() for op in self.xoperations],
                'yoperations': [op.__getstate__() for op in self.yoperations],
                'defaults': self.defaults, 'fixed': self.fixed}

    def __setstate__(self, state):
        self.comm = get_comm()
        self.device = None
        self._input_engines, self._init_engines, self._samples = {}, {}, {}
        self.engines = {name: BaseEmulatorEngine.from_state(s) for name, s in state['engines'].items()}
        self.xoperations = [Operation.from_state(s) for s in state.get('xoperations', [])]
        self.yoperations = [Operation.from_state(s) for s in state.get('yoperations', [])]
        self.defaults = dict(state.get('defaults', {}))
        self.fixed = {name: np.asarray(value) for name, value in state.get('fixed', {}).items()}

    @classmethod
    def from_state(cls, state):
        new = cls.__new__(cls)
        new.__setstate__(state)
        return new

    def write(self, filename):
        """Write the state: HDF5 for '.h5' / '.hdf5' (needs h5py), else
        ``np.save``; the JAX package reads both."""
        state = self.__getstate__()
        filename = str(filename)
        utils.mkdir(os.path.dirname(filename))
        if filename.endswith(('.h5', '.hdf5')):
            h5py = _import_h5py(filename)
            with h5py.File(filename, 'w') as f:
                engines_grp = f.create_group('engines')
                for engine_name, engine_state in state['engines'].items():
                    _h5_write_state(engines_grp.create_group(engine_name), engine_state)
                fixed_grp = f.create_group('fixed')
                for name, arr in state.get('fixed', {}).items():
                    fixed_grp.create_dataset(name, data=np.asarray(arr))
                meta = {k: v for k, v in state.items() if k not in ('engines', 'fixed')}
                f.attrs['__meta__'] = json.dumps(utils._prepare_for_json(meta))
        else:
            np.save(filename, state, allow_pickle=True)

    @classmethod
    def read(cls, filename):
        """Read a file that :meth:`write` of either package wrote. A .npy
        file is a pickle of numpy arrays and Python values: trusted input."""
        filename = str(filename)
        if filename.endswith(('.h5', '.hdf5')):
            h5py = _import_h5py(filename)
            with h5py.File(filename, 'r') as f:
                engines = {name: _h5_read_state(f['engines'][name], h5py) for name in f['engines'].keys()}
                fixed = {name: f['fixed'][name][...] for name in f['fixed'].keys()}
                meta = utils._restore_from_json(json.loads(str(f.attrs.get('__meta__', '{}'))))
            state = {**meta, 'engines': engines, 'fixed': fixed}
        else:
            state = np.load(filename, allow_pickle=True)[()]
        return cls.from_state(state)


class EmulatedCalculator(object):
    """Load an emulator file as a plain calculator."""

    @classmethod
    def read(cls, filename):
        return Emulator.read(filename).to_calculator()


def _h5_write_state(group, state):
    """Recursively write a nested state dict to an h5 group: ndarrays as
    datasets, everything else as JSON in attrs."""
    meta = {}
    for key, value in state.items():
        if isinstance(value, np.ndarray) and value.dtype.kind in 'fiu':
            group.create_dataset(key, data=value)
        elif isinstance(value, dict):
            _h5_write_state(group.create_group(key), value)
        elif isinstance(value, (list, tuple)) and value and isinstance(value[0], dict):
            sub = group.create_group(key)
            sub.attrs['__list__'] = len(value)
            for i, item in enumerate(value):
                _h5_write_state(sub.create_group(str(i)), item)
        else:
            meta[key] = value
    group.attrs['__meta__'] = json.dumps(utils._prepare_for_json(meta))


def _h5_read_state(group, h5py):
    state = utils._restore_from_json(json.loads(str(group.attrs.get('__meta__', '{}'))))
    if '__list__' in group.attrs:
        return [_h5_read_state(group[str(i)], h5py) for i in range(int(group.attrs['__list__']))]
    for key in group.keys():
        item = group[key]
        if isinstance(item, h5py.Group):
            state[key] = _h5_read_state(item, h5py)
        else:
            state[key] = item[...]
    return state
