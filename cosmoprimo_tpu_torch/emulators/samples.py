"""Sample containers for emulators (cosmoprimo_tpu/emulators/samples.py):
the :class:`Samples` dict-of-arrays with attrs and its files, .npy
(everywhere) and .h5 (where h5py is installed). The samplers are not
ported yet (ROADMAP slice 6b)."""

import json
import os
import re

import numpy as np

from .. import utils


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
