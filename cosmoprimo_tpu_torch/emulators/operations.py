"""Pre/post-processing operation algebra for emulators
(cosmoprimo_tpu/emulators/operations.py).

Operations transform calculator inputs 'x' / outputs 'y' before fitting and
invert after prediction. They are stored as Python expression strings over
``jnp`` / ``np`` names (the on-disk schema of the JAX package and the
reference, so their files load unchanged), evaluated by a *restricted*
evaluator that exposes only a torch-backed ``jnp``/``np`` namespace and the
operation's locals, and no builtins.

An expression describes ONE cosmology: the engines evaluate it under
``torch.func.vmap`` over the batch (emulators/base.py). An operation's
locals are numpy arrays in its state; :meth:`Operation.to` copies them to a
device once and caches them there, so a call copies nothing from the host.
"""

import ast
import functools

import numpy as np
import torch

_OPERATION_REGISTRY = {}


def register_operation(cls):
    _OPERATION_REGISTRY[cls.name] = cls
    return cls


def get_operation(operation):
    """Resolve str / class / instance to an Operation instance."""
    if isinstance(operation, str):
        try:
            operation = _OPERATION_REGISTRY[operation.lower()]()
        except KeyError:
            raise ValueError(f'Unknown operation {operation}.')
    if isinstance(operation, type):
        operation = operation()
    return operation


_ALLOWED_AST_NODES = (
    'Expression', 'BinOp', 'UnaryOp', 'BoolOp', 'Compare', 'IfExp', 'Call',
    'Name', 'Attribute', 'Constant', 'Subscript', 'Slice', 'Tuple', 'List',
    'keyword', 'Load',
    # operators
    'Add', 'Sub', 'Mult', 'Div', 'FloorDiv', 'Mod', 'Pow', 'MatMult',
    'UAdd', 'USub', 'Not', 'And', 'Or', 'Eq', 'NotEq', 'Lt', 'LtE', 'Gt', 'GtE',
)

_IMPORTABLE = ('torch', 'functorch', 'numpy', 'opt_einsum')


def _guarded_import(name, globals=None, locals=None, fromlist=(), level=0):
    """__import__ restricted to the torch/numpy family, the only imports a
    torch call may trigger lazily from inside an operation expression."""
    import builtins
    root = name.partition('.')[0]
    if level != 0 or root not in _IMPORTABLE:
        raise ImportError(f'operation expressions may not import {name!r}')
    return builtins.__import__(name, globals, locals, fromlist, level)


@functools.lru_cache(maxsize=None)
def _compile(expression):
    """The AST gate, then the code object of ``expression`` (cached: the
    engines evaluate the same few expressions on every call)."""
    tree = ast.parse(expression, mode='eval')
    for node in ast.walk(tree):
        kind = type(node).__name__
        if kind not in _ALLOWED_AST_NODES:
            raise ValueError(f'Disallowed construct {kind!r} in operation expression {expression!r}')
        if isinstance(node, ast.Name) and node.id.startswith('_'):
            raise ValueError(f'Disallowed identifier {node.id!r} in operation expression {expression!r}')
        if isinstance(node, ast.Attribute) and node.attr.startswith('_'):
            raise ValueError(f'Disallowed attribute {node.attr!r} in operation expression {expression!r}')
    return compile(tree, '<operation>', 'eval')


class _Linalg(object):
    """``jnp.linalg`` onto ``torch.linalg``: the norm."""

    def __init__(self, namespace):
        self.namespace = namespace

    def norm(self, x, ord=None, axis=None, keepdims=False):
        return torch.linalg.norm(self.namespace.asarray(x), ord=ord, dim=axis, keepdim=keepdims)


def _unary(fun):
    def wrapper(self, x):
        return fun(self.asarray(x))
    return wrapper


def _binary(fun):
    def wrapper(self, x, y):
        return fun(*self.operands(x, y))
    return wrapper


def _reduction(fun):
    def wrapper(self, x, axis=None, keepdims=False):
        x = self.asarray(x)
        if axis is None:
            return fun(x)
        return fun(x, dim=axis, keepdim=keepdims)
    return wrapper


class TorchNumpy(object):
    """The ``jnp`` / ``np`` of an operation expression: numpy names mapped
    onto torch, new arrays float64 on ``device``. Covers the names the
    operation files use (exp, log10, tanh, maximum, concatenate, zeros,
    linalg.norm, ...), the usual elementwise functions and sums; another
    name raises AttributeError."""

    pi, e, inf = np.pi, np.e, np.inf
    float64 = torch.float64

    def __init__(self, device):
        self.device = torch.device(device)
        self.linalg = _Linalg(self)

    def asarray(self, x, dtype=None):
        if isinstance(x, torch.Tensor):
            return x if dtype is None else x.to(dtype)
        if isinstance(x, (list, tuple)) and any(isinstance(item, torch.Tensor) for item in x):
            return torch.stack([self.asarray(item, dtype=dtype) for item in x])
        if dtype is None:
            dtype = torch.float64 if np.asarray(x).dtype.kind in 'fc' or np.ndim(x) == 0 else None
        if dtype is None:
            return torch.as_tensor(np.asarray(x), device=self.device)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    array = asarray

    def operands(self, *args):
        """Tensors of the arguments, Python numbers kept as they are."""
        return [arg if isinstance(arg, (int, float)) else self.asarray(arg) for arg in args]

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or torch.float64, device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, dtype=dtype or torch.float64, device=self.device)

    def full(self, shape, fill_value, dtype=None):
        return torch.full(shape, fill_value, dtype=dtype or torch.float64, device=self.device)

    def zeros_like(self, x):
        return torch.zeros_like(self.asarray(x))

    def ones_like(self, x):
        return torch.ones_like(self.asarray(x))

    def arange(self, *args, dtype=None):
        return torch.arange(*args, dtype=dtype or torch.float64, device=self.device)

    def linspace(self, start, stop, num=50, endpoint=True):
        if endpoint:
            return torch.linspace(start, stop, num, dtype=torch.float64, device=self.device)
        return torch.linspace(start, stop, num + 1, dtype=torch.float64, device=self.device)[:-1]

    def concatenate(self, arrays, axis=0):
        return torch.cat([self.asarray(a) for a in arrays], dim=axis)

    def stack(self, arrays, axis=0):
        return torch.stack([self.asarray(a) for a in arrays], dim=axis)

    def where(self, condition, x, y):
        condition, x, y = self.operands(condition, x, y)
        return torch.where(condition, x, y)

    def clip(self, x, a_min=None, a_max=None):
        return torch.clamp(self.asarray(x), a_min, a_max)

    def expand_dims(self, x, axis):
        x = self.asarray(x)
        for ax in sorted(axis if isinstance(axis, (tuple, list)) else [axis]):
            x = x.unsqueeze(ax)
        return x

    exp = _unary(torch.exp)
    expm1 = _unary(torch.expm1)
    log = _unary(torch.log)
    log10 = _unary(torch.log10)
    log1p = _unary(torch.log1p)
    sqrt = _unary(torch.sqrt)
    square = _unary(torch.square)
    abs = _unary(torch.abs)
    sin = _unary(torch.sin)
    cos = _unary(torch.cos)
    arctan = _unary(torch.atan)
    sinh = _unary(torch.sinh)
    cosh = _unary(torch.cosh)
    tanh = _unary(torch.tanh)
    arcsinh = _unary(torch.asinh)
    maximum = _binary(lambda x, y: torch.maximum(*_tensors(x, y)))
    minimum = _binary(lambda x, y: torch.minimum(*_tensors(x, y)))
    power = _binary(torch.pow)
    matmul = _binary(torch.matmul)
    sum = _reduction(torch.sum)
    prod = _reduction(torch.prod)
    mean = _reduction(torch.mean)


def _tensors(x, y):
    """Both arguments as tensors, a Python number taking the other's dtype
    and device."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=y.dtype, device=y.device)
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return x, y


def canonical_device(device):
    """``device`` as tensors report it ('cuda' -> 'cuda:0'), the key of
    the operations' caches."""
    return torch.empty(0, device=device).device


@functools.lru_cache(maxsize=None)
def _namespace(device):
    return TorchNumpy(device)


def _device_of(*values):
    """The device of the first tensor among ``values`` (also inside dicts,
    lists and tuples), else the CPU."""
    for value in values:
        if isinstance(value, torch.Tensor):
            return value.device
        if isinstance(value, dict):
            value = list(value.values())
        if isinstance(value, (list, tuple)):
            device = _device_of(*value)
            if device is not None:
                return device
    return None


def evaluate(expression, locals=None, device=None):
    """Evaluate an operation expression with ``jnp`` / ``np`` (torch on
    ``device``: by default that of the first tensor in ``locals``, else the
    CPU) and the given locals only.

    As the JAX package's evaluator: no builtins, and the expression is
    AST-checked first: only arithmetic/call/index nodes are allowed and no
    identifier or attribute may start with an underscore, which blocks
    dunder-chain escapes like ``().__class__...``. This guards the
    expression strings; emulator files as a whole (pickled .npy) are
    trusted input, as pickle is: do not load emulator files from untrusted
    sources.
    """
    code = _compile(expression)
    locals = locals or {}
    if device is None:
        device = _device_of(locals) or 'cpu'
    namespace = _namespace(torch.device(device))
    env = {'jnp': namespace, 'np': namespace}
    env.update(locals)
    return eval(code, {'__builtins__': {'__import__': _guarded_import}}, env)


def in_forward_transform():
    """True inside ``torch.func.jvp`` / ``jacfwd``, where a new tensor is
    wrapped for that call: a cache must not keep it."""
    try:
        torch.zeros(()).data_ptr()
    except RuntimeError:
        return True
    return False


class _DeviceCached(object):
    """Arrays of the state named in ``_tensor_attrs``, copied to a device
    once (:meth:`_on`) and cached there (not inside a forward-mode
    transform, see :func:`in_forward_transform`)."""

    _tensor_attrs = ()

    def _on(self, device):
        cache = self.__dict__.setdefault('_device_cache', {})
        if device in cache:
            return cache[device]
        tensors = {name: _to_device(getattr(self, name), device) for name in self._tensor_attrs if hasattr(self, name)}
        if not in_forward_transform():
            cache[device] = tensors
        return tensors


def _to_device(value, device):
    """``value`` with every numpy array (also inside lists, tuples and
    dicts) a tensor on ``device``, float64 for a floating array; numpy
    scalars become Python numbers, anything else is kept."""
    if isinstance(value, np.ndarray):
        if value.dtype.kind in 'fc':
            return torch.as_tensor(value, dtype=torch.float64 if value.dtype.kind == 'f' else None, device=device)
        if value.dtype.kind in 'iub':
            return torch.as_tensor(value, device=device)
        return value
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float64 if value.is_floating_point() else None)
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, dict):
        return {name: _to_device(item, device) for name, item in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_device(item, device) for item in value)
    return value


@register_operation
class Operation(_DeviceCached):
    """Expression-backed transform with a direct and an inverse form.

    ``direct`` / ``inverse`` are expressions in the variable ``v`` (plus any
    name in ``locals`` and keyword arguments passed at call time).
    """

    name = 'base'
    _tensor_attrs = ('_locals',)

    def __init__(self, direct='v', inverse=None, locals=None, input_type=None):
        self._direct = str(direct)
        self._inverse = str(inverse) if inverse is not None else None
        self._locals = dict(locals or {})
        self.input_type = input_type

    @property
    def locals(self):
        return dict(self._locals)

    def initialize(self, v, **kwargs):
        return

    def to(self, device):
        """Copy the locals (and the arrays of a subclass's state) to
        ``device`` once; later calls on tensors there find them cached."""
        self._on(canonical_device(device))
        return self

    def _evaluate(self, expression, v, kwargs):
        device = _device_of(v, kwargs) or torch.device('cpu')
        return evaluate(expression, locals={**self._on(device)['_locals'], 'v': v, **kwargs}, device=device)

    def __call__(self, v, **kwargs):
        return self._evaluate(self._direct, v, kwargs)

    def inverse(self, v, **kwargs):
        return self._evaluate(self._inverse, v, kwargs)

    def update(self, **kwargs):
        if 'locals' in kwargs:
            self._locals = dict(kwargs['locals'] or {})
        if 'direct' in kwargs:
            self._direct = str(kwargs['direct'])
        if 'inverse' in kwargs:
            self._inverse = str(kwargs['inverse']) if kwargs['inverse'] is not None else None
        self.__dict__.pop('_device_cache', None)

    def clone(self, **kwargs):
        new = self.copy()
        new.update(**kwargs)
        return new

    def copy(self):
        new = self.__class__.__new__(self.__class__)
        new.__dict__.update({k: (dict(v) if isinstance(v, dict) else v) for k, v in self.__dict__.items()})
        return new

    def __deepcopy__(self, memo):
        # bypass __getstate__ (which serializes only the expression fields):
        # keep subclass configuration like ScaleOperation.limits
        import copy as _copy
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        new.__dict__.update(_copy.deepcopy({k: v for k, v in self.__dict__.items() if k != '_device_cache'}, memo))
        return new

    def __getstate__(self):
        return {'name': self.name, '_direct': self._direct, '_inverse': self._inverse, '_locals': self._locals}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.input_type = state.get('input_type', None)

    @classmethod
    def from_state(cls, state):
        state = dict(state)
        name = state.pop('name')
        cls = _OPERATION_REGISTRY[name]
        new = cls.__new__(cls)
        new.__setstate__(state)
        return new


@register_operation
class Log10Operation(Operation):
    """log10 <-> 10^x."""

    name = 'log10'

    def __init__(self):
        super().__init__('jnp.log10(v)', inverse='10**v', locals={})


@register_operation
class ArcsinhOperation(Operation):
    """arcsinh <-> sinh."""

    name = 'arcsinh'

    def __init__(self):
        super().__init__('jnp.arcsinh(v)', inverse='jnp.sinh(v)', locals={})


@register_operation
class ScaleOperation(Operation):
    """Rescale to [0, 1] by (sample or provided) limits."""

    name = 'scale'

    def __init__(self, limits=None):
        self.limits = list(limits) if limits else [None] * 2
        super().__init__('v')

    def initialize(self, values, **kwargs):
        values = np.asarray(values)
        limits = list(self.limits)
        if limits[0] is None:
            limits[0] = np.min(values, axis=0)
        if limits[1] is None:
            limits[1] = np.max(values, axis=0)
        mask = limits[1] == limits[0]
        limits[0] = np.where(mask, 0.0, limits[0])
        limits[1] = np.where(mask, 1.0, limits[1])
        self.limits = limits
        self.update(direct='(v - limits[0]) / (limits[1] - limits[0])',
                    inverse='v * (limits[1] - limits[0]) + limits[0]',
                    locals={'limits': limits})


@register_operation
class NormOperation(Operation):
    """Standardize by sample mean / std."""

    name = 'norm'

    def __init__(self):
        super().__init__('v')

    def initialize(self, v, **kwargs):
        v = np.asarray(v)
        mean, sigma = np.mean(v, axis=0), np.std(v, ddof=1, axis=0)
        sigma = np.where(sigma == 0.0, 1.0, sigma)
        self.update(direct='(v - mean) / sigma', inverse='v * sigma + mean',
                    locals={'mean': mean, 'sigma': sigma})


def _subspace(X, npcs=None):
    """Principal directions of X (nsamples, ...), from the eigenvectors of
    the covariance of the flattened matrix."""
    X = np.asarray(X).reshape(len(X), -1)
    cov = X.T @ X / len(X)
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1]
    evecs = evecs[:, order]
    if npcs is not None:
        evecs = evecs[:, :npcs]
    return evecs


@register_operation
class PCAOperation(Operation):
    """Project onto the ``npcs`` leading principal components."""

    name = 'pca'
    _tensor_attrs = ('mean', 'sigma', 'eigenvectors')

    def __init__(self, npcs=1):
        self.npcs = npcs
        super().__init__('v')

    def initialize(self, v, **kwargs):
        v = np.asarray(v)
        self.mean, self.sigma = np.mean(v, axis=0), np.std(v, ddof=1, axis=0)
        self.sigma = np.where(self.sigma == 0.0, 1.0, self.sigma)
        eig = _subspace((v - self.mean) / self.sigma, npcs=self.npcs)
        self.eigenvectors = eig.T.reshape((-1,) + self.mean.shape)
        self.__dict__.pop('_device_cache', None)

    def __call__(self, v, **kwargs):
        t = self._on(v.device)
        eig = t['eigenvectors']
        return torch.sum(((v - t['mean']) / t['sigma']).unsqueeze(0) * eig, dim=tuple(range(1, eig.dim())))

    def inverse(self, v, **kwargs):
        t = self._on(v.device)
        eig = t['eigenvectors']
        return torch.sum(v.reshape(v.shape + (1,) * (eig.dim() - 1)) * eig, dim=0) * t['sigma'] + t['mean']

    def __getstate__(self):
        return {name: getattr(self, name) for name in ['name', 'mean', 'sigma', 'eigenvectors'] if hasattr(self, name)}

    def __setstate__(self, state):
        self.__dict__.update(state)


@register_operation
class ChebyshevOperation(Operation):
    """Project onto a Chebyshev basis up to ``order`` along ``axis``."""

    name = 'chebyshev'
    _tensor_attrs = ('poly', 'proj')

    def __init__(self, order=10, axis=-1):
        self.order = int(order)
        self.axis = int(axis)
        super().__init__('v')

    def initialize(self, v, **kwargs):
        size = v.shape[1:][self.axis]
        ndim = v.ndim - 1
        self.axis = self.axis % ndim
        x = np.linspace(-1.0, 1.0, size)
        # Chebyshev polynomials T_n by recurrence
        polys = [np.ones_like(x), x]
        for n in range(2, self.order + 1):
            polys.append(2 * x * polys[-1] - polys[-2])
        poly = np.stack(polys[:self.order + 1], axis=-1)  # (size, order+1)
        full_shape = [1] * (ndim + 1)
        full_shape[self.axis] = size
        full_shape[self.axis + 1] = self.order + 1
        self.poly = poly.reshape(full_shape)
        flatpoly = poly.reshape(size, -1)
        self.proj = (flatpoly @ np.linalg.inv(flatpoly.T @ flatpoly)).reshape(self.poly.shape)
        self.__dict__.pop('_device_cache', None)

    def __call__(self, v, **kwargs):
        return torch.sum(v.unsqueeze(self.axis + 1) * self._on(v.device)['poly'], dim=self.axis)

    def inverse(self, v, **kwargs):
        return torch.sum(v.unsqueeze(self.axis) * self._on(v.device)['proj'], dim=self.axis + 1)

    def __getstate__(self):
        return {name: getattr(self, name) for name in ['name', 'proj', 'poly', 'axis'] if hasattr(self, name)}

    def __setstate__(self, state):
        self.__dict__.update(state)


def _per_row(x, value):
    """``x`` (the batch shape) with trailing axes to broadcast against
    ``value``, which leads with the batch shape."""
    x = torch.as_tensor(x, dtype=torch.float64, device=value.device)
    return x.reshape(x.shape + (1,) * (value.dim() - x.dim()))


@register_operation
class SplitDerivedOperation(Operation):
    """Unpack a packed derived-parameter vector (e.g. cosmopower's
    'thermodynamics.all': [..., z_star, rs_star, z_drag, rs_drag, ...])
    into named quantities at serving time, optionally rescaling sound
    horizons from Mpc to Mpc/h (a typed operation: the expression sandbox
    is expression-only by design).

    Batch-first, as the emulator-level operations of the port: ``X``'s
    values have the batch shape, and each value of ``v`` leads with it."""

    name = 'split_derived'

    def __init__(self, conversion=None, key='thermodynamics.all',
                 h_scale=('thermodynamics.rs_drag', 'thermodynamics.rs_star')):
        self.conversion = dict(conversion or {})
        self.key = str(key)
        self.h_scale = tuple(h_scale)
        super().__init__('v')

    def __call__(self, v, X=None, cosmo=None):
        # training direction: drop the unpacked names (the packed vector is
        # the stored target); converted emulators never fit, so this is
        # only for symmetry
        return {name: value for name, value in dict(v).items()
                if name not in self.conversion}

    def inverse(self, v, X=None, cosmo=None):
        v = dict(v)
        if self.key not in v:
            return v
        derived = v.pop(self.key)
        for name, index in self.conversion.items():
            value = derived[..., index]
            if name in self.h_scale and X is not None:
                value = value * _per_row(X['h'], value)
            v[name] = value
        return v

    def __getstate__(self):
        return {'name': self.name, 'conversion': self.conversion, 'key': self.key,
                'h_scale': list(self.h_scale)}

    def __setstate__(self, state):
        self.conversion = dict(state['conversion'])
        self.key = state['key']
        self.h_scale = tuple(state['h_scale'])
        self._direct, self._inverse, self._locals = 'v', None, {}
        self.input_type = None


@register_operation
class FourierUnitOperation(Operation):
    """Convert served fourier tables from the foreign network's units to
    this framework's (Mpc/h, (Mpc/h)^3) convention: k -> k / h and
    (optionally, for cosmopower v1 networks trained in Mpc^3) pk -> pk h^3.

    Batch-first: ``X``'s values have the batch shape, each pk table leads
    with it, and 'fourier.k' is one grid (nk,), or one per row; the k it
    returns is one per row, batch + (nk,)."""

    name = 'fourier_unit'

    def __init__(self, pk_h3=True):
        self.pk_h3 = bool(pk_h3)
        super().__init__('v')

    def __call__(self, v, X=None, cosmo=None):
        v = dict(v)
        if 'fourier.k' in v and X is not None:
            h = torch.as_tensor(X['h'], dtype=torch.float64)
            v['fourier.k'] = v['fourier.k'] * h[..., None]
            if self.pk_h3:
                v = {name: value / _per_row(h, value) ** 3 if name.startswith('fourier.pk') else value
                     for name, value in v.items()}
        return v

    def inverse(self, v, X=None, cosmo=None):
        v = dict(v)
        if 'fourier.k' in v and X is not None:
            h = torch.as_tensor(X['h'], dtype=torch.float64)
            v['fourier.k'] = v['fourier.k'] / h[..., None]
            if self.pk_h3:
                v = {name: value * _per_row(h, value) ** 3 if name.startswith('fourier.pk') else value
                     for name, value in v.items()}
        return v

    def __getstate__(self):
        return {'name': self.name, 'pk_h3': self.pk_h3}

    def __setstate__(self, state):
        self.pk_h3 = bool(state['pk_h3'])
        self._direct, self._inverse, self._locals = 'v', None, {}
        self.input_type = None
