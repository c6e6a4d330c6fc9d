"""MLP emulator network, its training and its engine
(cosmoprimo_tpu/emulators/mlp.py).

:class:`MLP` is a ``torch.nn.Module`` in float64 with the JAX package's
flax semantics: dense kernels (in, out) applied as ``v @ kernel + bias``,
flax's initialization, the reference's activation set ('silu', 'relu',
'tanh', and the cosmopower-style 'identity-silu' with learnable scalar
(alpha, beta) per layer) and flax's batch normalization
(:class:`BatchNorm`). The engine fits it with ``torch.optim.Adam`` in
stages on the card (the JAX package's staged batch-fraction / learning-rate
schedule with early stopping) and serves it as its exported Operation
chain: the dense products are ``torch.matmul``, evaluated for one cosmology
and vmapped over the batch by the base engine.
"""

import math
import time

import numpy as np
import torch

from .base import BaseEmulatorEngine, make_list, map_rows, register_emulator_engine
from .operations import Operation, ScaleOperation, get_operation
from .samples import resolve_device

# flax's lecun_normal: a truncated normal in [-2, 2] scaled to unit variance
# by the std of that truncation, .87962566103423978
_TRUNCATED_STD = .87962566103423978


class Dense(torch.nn.Module):
    """flax ``nn.Dense``: ``v @ kernel + bias``, the kernel (in, out), one
    ``addmm`` on a batch of rows."""

    def __init__(self, fan_in, features, device=None):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.zeros(fan_in, features, dtype=torch.float64, device=device))
        self.bias = torch.nn.Parameter(torch.zeros(features, dtype=torch.float64, device=device))

    def forward(self, x):
        return torch.addmm(self.bias, x, self.kernel)


class BatchNorm(torch.nn.Module):
    """flax 0.12's ``nn.BatchNorm`` over the batch axis, as the JAX
    package's MLP uses it (not ``torch.nn.BatchNorm1d``): in training the
    batch mean and the *biased* variance, mean(x^2) - mean(x)^2 clipped at
    0, normalize, and the running averages move as ``momentum * average +
    (1 - momentum) * batch`` with momentum 0.99; in evaluation the running
    averages normalize. ``(x - mean) * (rsqrt(var + 1e-5) * scale) + bias``;
    ``scale``/``bias`` are parameters, ``mean``/``var`` buffers.

    As in flax, the running averages start as float32 zeros and ones and
    become float64 at their first update (``momentum * average`` is taken
    in float32 then), and normalizing by the float32 start takes its rsqrt
    in float32; the type promotions are the same as JAX's."""

    momentum = 0.99
    epsilon = 1e-5

    def __init__(self, features, device=None):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(features, dtype=torch.float64, device=device))
        self.bias = torch.nn.Parameter(torch.zeros(features, dtype=torch.float64, device=device))
        self.register_buffer('mean', torch.zeros(features, dtype=torch.float32, device=device))
        self.register_buffer('var', torch.ones(features, dtype=torch.float32, device=device))

    def forward(self, x):
        if self.training:
            mean = x.mean(0)
            var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean = self.momentum * self.mean + (1 - self.momentum) * mean
                self.var = self.momentum * self.var + (1 - self.momentum) * var
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


class MLP(torch.nn.Module):
    """Dense network with the reference's activation set; optional batch
    normalization before each hidden-to-hidden Dense. Its submodules and
    parameters carry the flax names: 'layer_{i}' (kernel, bias),
    'batch_{i}' (scale, bias; buffers mean, var), 'alpha_{i}', 'beta_{i}'."""

    def __init__(self, fan_in, features, activation, batch_norm=False, device=None):
        super().__init__()
        self.features = tuple(features)      # hidden sizes + (output size,)
        self.activation = tuple(activation)  # one name per hidden layer
        self.batch_norm = bool(batch_norm)
        nlayers = len(self.features)
        for ilayer, feat in enumerate(self.features):
            if self.batch_norm and ilayer > 0:
                setattr(self, f'batch_{ilayer}', BatchNorm(fan_in, device=device))
            setattr(self, f'layer_{ilayer}', Dense(fan_in, feat, device=device))
            if ilayer < nlayers - 1:
                name = self.activation[ilayer]
                if name not in ('identity-silu', 'silu', 'relu', 'tanh'):
                    raise ValueError(f'unknown activation {name}')
                if name == 'identity-silu':
                    for pname in (f'beta_{ilayer}', f'alpha_{ilayer}'):
                        setattr(self, pname, torch.nn.Parameter(torch.zeros((), dtype=torch.float64, device=device)))
            fan_in = feat

    def forward(self, x):
        nlayers = len(self.features)
        for ilayer in range(nlayers):
            if self.batch_norm and ilayer > 0:
                x = getattr(self, f'batch_{ilayer}')(x)
            x = getattr(self, f'layer_{ilayer}')(x)
            if ilayer < nlayers - 1:
                name = self.activation[ilayer]
                if name == 'identity-silu':
                    beta, alpha = getattr(self, f'beta_{ilayer}'), getattr(self, f'alpha_{ilayer}')
                    x = ((1.0 - beta) + beta / (1 + torch.exp(-alpha * x))) * x
                elif name == 'silu':
                    x = x / (1 + torch.exp(-x))
                elif name == 'relu':
                    x = torch.clamp(x, min=0.0)
                else:
                    x = torch.tanh(x)
        return x


def get_state(model):
    """Device clones of ``model``'s parameters and running averages."""
    return {name: value.detach().clone() for name, value in model.state_dict().items()}


def set_state(model, state):
    """Copy ``state`` (name -> tensor or array, every name of
    ``model.state_dict()``) into ``model``: the parameters in float64, the
    running averages with their own dtype (float32 until their first
    update, as flax's)."""
    missing = set(model.state_dict()) ^ set(state)
    if missing:
        raise KeyError(f'the state does not match the network: {sorted(missing)}')
    with torch.no_grad():
        for name, tensor in model.named_parameters():
            value = state[name]
            tensor.copy_(torch.as_tensor(value if isinstance(value, torch.Tensor) else np.array(value),
                                         dtype=torch.float64))
    for name, tensor in list(model.named_buffers()):
        module, _, leaf = name.rpartition('.')
        value = state[name]
        value = torch.as_tensor(value if isinstance(value, torch.Tensor) else np.array(value))
        setattr(model.get_submodule(module), leaf, value.to(tensor.device, copy=True))
    return model


def init_mlp(model, generator):
    """flax's initialization of ``model``, drawn on the CPU from the
    ``torch.Generator`` ``generator`` (so the same seed gives the same
    network on every device): each kernel from lecun_normal, a normal of
    std sqrt(1 / fan_in) / .8796 truncated at 2 std; biases, alpha and
    beta 0; batch normalization scale 1, bias 0, mean 0 and var 1 (the
    running averages float32)."""
    state = {}
    for name, tensor in model.state_dict().items():
        if name.endswith('kernel'):
            draw = torch.empty(tensor.shape, dtype=torch.float64)
            torch.nn.init.trunc_normal_(draw, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
            state[name] = draw * (math.sqrt(1.0 / tensor.shape[0]) / _TRUNCATED_STD)
        elif name.endswith(('.mean', '.var')):
            state[name] = (torch.ones if name.endswith('var') else torch.zeros)(tensor.shape, dtype=torch.float32)
        else:
            state[name] = (torch.ones if name.endswith('scale') else torch.zeros)(tensor.shape, dtype=torch.float64)
    return set_state(model, state)


def load_flax_variables(model, params, batch_stats=None):
    """Copy the JAX package's flax ``params`` and ``batch_stats`` (nested
    dicts of arrays) into ``model``, which must have the same layout."""
    state = {}
    for variables in (params, batch_stats or {}):
        for name, value in variables.items():
            if isinstance(value, dict):
                state.update({f'{name}.{key}': item for key, item in value.items()})
            else:
                state[name] = value
    return set_state(model, state)


def flax_variables(model):
    """(params, batch_stats): ``model``'s tensors as numpy arrays in the
    flax layout of the JAX package ('layer_{i}': {'kernel', 'bias'}, ...),
    as :meth:`MLPEmulatorEngine._export_operations` takes them."""
    params, batch_stats = {}, {}
    for key, value in model.state_dict().items():
        name, _, leaf = key.partition('.')
        target = batch_stats if leaf in ('mean', 'var') else params
        value = value.detach().cpu().numpy()
        if leaf:
            target.setdefault(name, {})[leaf] = value
        else:
            target[name] = value
    return params, batch_stats


def mse(y_true, y_pred):
    return torch.mean((y_true - y_pred) ** 2)


def cosine_decay_schedule(init_value, decay_steps):
    """optax.cosine_decay_schedule(init_value, decay_steps): the rate at
    update ``count`` (the first update is count 0)."""
    def schedule(count):
        count = min(count, decay_steps)
        return init_value * ((1 - 0.0) * (0.5 * (1 + math.cos(math.pi * count / decay_steps))) + 0.0)
    return schedule


def make_adam(model, learning_rate):
    """``torch.optim.Adam`` matching optax's adam(b1=0.9, b2=0.999,
    eps=1e-8, eps_root=0), fused (one launch a step for all the
    parameters); ``learning_rate`` a number or a schedule (count -> rate),
    which :func:`make_train_step` applies."""
    lr = learning_rate(0) if callable(learning_rate) else learning_rate
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=True)


def make_train_step(model, optimizer, learning_rate, loss='mse'):
    """The train step ``step(x, y) -> loss``: the loss ('mse', or a
    callable ``loss(y_true, y_pred)`` on tensors) of the module in training
    mode, its gradient, and one Adam update at the schedule's rate for this
    optimizer's update count. Reads nothing back to the host."""
    compute_loss = mse if loss == 'mse' else loss
    count = [0]

    def step(x, y):
        if callable(learning_rate):
            for group in optimizer.param_groups:
                group['lr'] = learning_rate(count[0])
        optimizer.zero_grad(set_to_none=True)
        value = compute_loss(y, model(x))
        value.backward()
        optimizer.step()
        count[0] += 1
        return value

    return step


def _make_tuple(obj, length=None):
    if np.ndim(obj) == 0:
        obj = (obj,)
        if length is not None:
            obj = obj * length
    return tuple(obj)


@register_emulator_engine
class MLPEmulatorEngine(BaseEmulatorEngine):
    """Multi-layer-perceptron engine (cosmopower/EmulateLSS heritage):
    staged batch-fraction / learning-rate training with early stopping on
    the card; the trained network is exported as an Operation chain, so
    the files of the JAX package and of the reference load unchanged."""

    name = 'mlp'

    def __init__(self, *args, nhidden=(32, 32, 32), activation='silu', loss='mse', model_yoperation=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.nhidden = tuple(nhidden)
        self.loss = loss
        self.activation = _make_tuple(activation, length=len(self.nhidden))
        self.batch_norm = False
        self.model_yoperations = [get_operation(op) for op in make_list(model_yoperation)]
        for operations in [self.xoperations, self.yoperations]:
            if len(operations) == 0 or operations[-1].name not in ['scale', 'norm', 'pca']:
                operations.append(ScaleOperation())

    def _operations(self):
        return super()._operations() + getattr(self, 'model_operations', []) + getattr(self, 'model_yoperations', [])

    def get_default_samples(self, calculator, params, engine='rqrs', niterations=int(1e4), **kwargs):
        from .samples import QMCSampler
        sampler = QMCSampler(calculator, params, engine=engine, device=self.device)
        return sampler.run(niterations=niterations)

    def _fit_no_operation(self, X, Y, attrs, validation_frac=0.1, optimizer='adam',
                          batch_frac=(0.1, 0.3, 1.0), epochs=1000, learning_rate=(1e-2, 1e-3, 1e-5),
                          patience=100, seed=42, mesh=None, learning_rate_scheduling=True,
                          batch_norm=False):
        """The JAX package's staged fit, step for step, on the engine's
        device: at each stage the validation rows are redrawn from one
        ``np.random.RandomState(seed)``, the training rows are cut into
        contiguous batches (no shuffling; a partial last batch is dropped),
        a new Adam state starts from the best parameters so far (the freshly
        initialized network before the first), and the stage stops after
        ``patience`` epochs without a better validation loss (a non-finite
        one counts as a stall). One host read an epoch: the validation
        loss. :attr:`history` records each stage."""
        if mesh is not None:
            raise NotImplementedError('mesh= (the dp x tp sharded fit) is ROADMAP slice 6c, not ported yet')
        if optimizer != 'adam':
            raise ValueError(f'the port fits with adam only, not {optimizer!r}')
        device = resolve_device(self.device)
        self.batch_norm = bool(batch_norm)
        list_batch_frac = _make_tuple(batch_frac)
        list_epochs = _make_tuple(epochs, length=len(list_batch_frac))
        list_learning_rate = _make_tuple(learning_rate, length=len(list_batch_frac))
        list_patience = _make_tuple(patience, length=len(list_batch_frac))
        rng = np.random.RandomState(seed=seed)

        for operation in self.model_yoperations:
            operation.initialize(Y)
            Y = map_rows(operation, Y, device=device)

        nsamples = len(X)
        nvalidation = int(nsamples * validation_frac + 0.5)
        if nvalidation >= nsamples:
            raise ValueError('validation fraction leaves no training samples')
        X_all = torch.as_tensor(np.asarray(X, dtype=np.float64), device=device)
        Y_all = torch.as_tensor(np.asarray(Y, dtype=np.float64), device=device)

        model = MLP(X.shape[-1], self.nhidden + (Y.shape[-1],), self.activation, batch_norm=self.batch_norm,
                    device=device)
        best = None
        self.history = []
        for bfrac, nepochs, lr, pat in zip(list_batch_frac, list_epochs, list_learning_rate, list_patience):
            t0 = time.perf_counter()
            idx_val = rng.choice(nsamples, size=nvalidation, replace=False)
            mask_train = ~np.isin(np.arange(nsamples), idx_val)
            index_train = torch.as_tensor(np.flatnonzero(mask_train), device=device)
            index_val = torch.as_tensor(idx_val, device=device)
            X_train, Y_train = X_all[index_train], Y_all[index_train]
            X_val, Y_val = X_all[index_val], Y_all[index_val]
            ntrain = len(X_train)
            batch_size = max(int(ntrain * min(bfrac, 1.0) + 0.5), 1)
            nbatch = max(ntrain // batch_size, 1)

            if learning_rate_scheduling:
                # cosine decay over the stage (reference tools/mlp.py:7-25)
                lr = cosine_decay_schedule(lr, decay_steps=max(nepochs * nbatch, 1))
            if best is None:
                # the freshly initialized network is the fallback export: a fit
                # whose validation loss never lands finite still exports a
                # servable (if useless) operation chain
                init_mlp(model, torch.Generator().manual_seed(seed))
                best = get_state(model)
            else:
                set_state(model, best)
            step = make_train_step(model, make_adam(model, lr), lr, loss=self.loss)

            best_loss, stall, losses = np.inf, 0, []
            for epoch in range(nepochs):
                model.train()
                for ib in range(nbatch):
                    sl = slice(ib * batch_size, (ib + 1) * batch_size)
                    step(X_train[sl], Y_train[sl])
                model.eval()
                with torch.no_grad():
                    loss = float(mse(Y_val, model(X_val)))
                losses.append(loss)
                if not np.isfinite(loss):  # divergence counts as a stall
                    stall += 1
                    if stall >= pat:
                        break
                    continue
                if loss < best_loss:
                    best_loss, stall = loss, 0
                    best = get_state(model)
                else:
                    stall += 1
                if stall >= pat:
                    break
            self.history.append({'ntrain': ntrain, 'nvalidation': nvalidation, 'batch_size': batch_size,
                                 'nbatch': nbatch, 'epochs': len(losses), 'steps': len(losses) * nbatch,
                                 'best_loss': best_loss, 'losses': losses, 'seconds': time.perf_counter() - t0})

        set_state(model, best)
        self.model_operations = self._export_operations(*flax_variables(model))

    def _export_operations(self, params, batch_stats=None):
        """The network as the serialized Operation chain (the JAX package's
        and the reference's schema): ``params`` holds per layer
        'layer_{i}' {'kernel', 'bias'}, with batch normalization
        'batch_{i}' {'scale', 'bias'} (and ``batch_stats`` 'batch_{i}'
        {'mean', 'var'}), folded into 'scale * (v - mean) + bias', and
        'alpha_{i}', 'beta_{i}' of the 'identity-silu' activation; numpy
        arrays."""
        operations = []
        nlayers = len(self.nhidden) + 1
        for ilayer in range(nlayers):
            if self.batch_norm and ilayer > 0:
                pbatch, sbatch = params[f'batch_{ilayer}'], batch_stats[f'batch_{ilayer}']
                operations.append(Operation('scale * (v - mean) + bias',
                                            locals={'scale': np.asarray(pbatch['scale'] / np.sqrt(sbatch['var'] + 1e-5)),
                                                    'mean': np.asarray(sbatch['mean']),
                                                    'bias': np.asarray(pbatch['bias'])}))
            player = params[f'layer_{ilayer}']
            operations.append(Operation('v @ kernel + bias',
                                        locals={name: np.asarray(player[name]) for name in ['kernel', 'bias']}))
            if ilayer < nlayers - 1:
                act = self.activation[ilayer]
                if act == 'identity-silu':
                    operations.append(Operation('((1 - beta) + beta / (1 + jnp.exp(-alpha * v))) * v',
                                                locals={'beta': np.asarray(params[f'beta_{ilayer}']),
                                                        'alpha': np.asarray(params[f'alpha_{ilayer}'])}))
                elif act == 'silu':
                    operations.append(Operation('v / (1 + jnp.exp(-v))', locals={}))
                elif act == 'relu':
                    operations.append(Operation('jnp.maximum(v, 0.)', locals={}))
                elif act == 'tanh':
                    operations.append(Operation('jnp.tanh(v)', locals={}))
                else:
                    raise ValueError(f'unknown activation {act}')
        return operations

    def _predict_no_operation(self, X):
        x = X
        for operation in self.model_operations:
            x = operation(x)
        for operation in self.model_yoperations:
            x = operation.inverse(x)
        return x

    def __getstate__(self):
        state = super().__getstate__()
        for name in ['nhidden']:
            if hasattr(self, name):
                state[name] = getattr(self, name)
        for name in ['model_operations', 'model_yoperations']:
            if hasattr(self, name):
                state[name] = [operation.__getstate__() for operation in getattr(self, name)]
        return state

    def __setstate__(self, state):
        super().__setstate__(state)
        for name in ['model_operations', 'model_yoperations']:
            if name in state:
                setattr(self, name, [Operation.from_state(s) for s in state[name]])
