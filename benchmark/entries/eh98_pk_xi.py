"""The ``eh98_pk_xi`` call: the program's batched P(k) -> xi pipeline
(``make_pk_to_xi_pipeline_batched``) at the configuration's k grid and z:
EH98 P(k), sigma8, chi at z = 0.5, 1, 2 and one batched FFTLog."""

import numpy as np
import torch

PARAMS = ('omega_cdm', 'omega_b', 'h', 'n_s', 'logA')


class Entry:

    def __init__(self, config, device):
        from cosmoprimo_tpu_torch import Cosmology, PowerToCorrelation, make_pk_to_xi_pipeline_batched
        self.Cosmology = Cosmology
        self.fn, k, _ = make_pk_to_xi_pipeline_batched(nk=config['nk'], kmin=config['kmin'], kmax=config['kmax'],
                                                       z=config['z'])
        self.k = torch.from_numpy(k).to(device)
        self.z = torch.from_numpy(np.asarray(config['z'], dtype=np.float64)).to(device)
        self.transform = PowerToCorrelation(k)

    def call(self, batch):
        xi, chi, sigma8 = self.fn(*(batch[name] for name in PARAMS))
        return {'xi': xi, 'chi': chi, 'sigma8': sigma8}

    def cosmology(self, batch):
        return self.Cosmology(engine='eisenstein_hu', **{name: batch[name] for name in PARAMS})

    def spans(self, batch):
        """The layers' calls at the cell's shapes, for the trace."""
        cosmo = self.cosmology(batch)
        rows = cosmo.get_fourier().pk_interpolator()(self.k, self.z).transpose(-1, -2).contiguous()
        return {'params': lambda: self.cosmology(batch),
                'linear_pk': lambda: cosmo.get_fourier().pk_interpolator()(self.k, self.z),
                'fftlog': lambda: self.transform(rows)}

    def counters(self, batch):
        rows = batch[PARAMS[0]].shape[0] * self.z.shape[0]
        return {'fftlog': {'rows': rows, 'size': self.transform.size, 'padded': self.transform.padded_size,
                           'nparallel': self.transform.nparallel}}


def build(config, device):
    return Entry(config, device)
