"""MLP emulator engine, serving (cosmoprimo_tpu/emulators/mlp.py): a
trained network is an Operation chain ('v @ kernel + bias', the
activations, the folded batch normalization), evaluated for one cosmology
and vmapped over the batch by the base engine; the dense products are
``torch.matmul``. The network module, its train step and the staged fit
are not ported yet (ROADMAP slice 6b)."""

import numpy as np

from .base import BaseEmulatorEngine, make_list, register_emulator_engine
from .operations import Operation, ScaleOperation, get_operation


def _make_tuple(obj, length=None):
    if np.ndim(obj) == 0:
        obj = (obj,)
        if length is not None:
            obj = obj * length
    return tuple(obj)


@register_emulator_engine
class MLPEmulatorEngine(BaseEmulatorEngine):
    """Multi-layer-perceptron engine (cosmopower/EmulateLSS heritage): the
    network is served as its exported Operation chain, so the files of the
    JAX package and of the reference load unchanged."""

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
