"""The ``desi_bao_template`` call, composed from the program's public API:
an EH98 cosmology with one massive neutrino, its P(k) interpolator at the
DESI DR1 redshifts, the 'peakaverage' BAO filter against the DESI fiducial
(built once, in set-up), the no-wiggle P(k), the correlation functions of
the wiggly and the no-wiggle P(k) by ``to_xi()``, the linear P(k, z) with
its growth factor at the same redshifts, rs_drag and chi."""

import numpy as np
import torch

PARAMS = ('omega_cdm', 'omega_b', 'h', 'n_s', 'logA')


class Entry:

    def __init__(self, config, device):
        from cosmoprimo_tpu_torch import Cosmology, PowerSpectrumBAOFilter, PowerToCorrelation
        from cosmoprimo_tpu_torch.fiducial import DESI
        self.Cosmology, self.Filter = Cosmology, PowerSpectrumBAOFilter
        self.config = config
        self.fiducial = DESI(engine='eisenstein_hu', device=device)
        self.z_np = np.asarray(config['z'], dtype=np.float64)
        self.z = torch.from_numpy(self.z_np).to(device)
        self.k_np = np.geomspace(config['kmin'], config['kmax'], config['nk'])
        self.k = torch.from_numpy(self.k_np).to(device)
        self.transform = PowerToCorrelation(self.k_np)

    def cosmology(self, batch):
        return self.Cosmology(engine='eisenstein_hu', m_ncdm=[batch['m_ncdm']], N_eff=self.config['N_eff'],
                              **{name: batch[name] for name in PARAMS})

    def pk_interpolator(self, cosmo):
        pk = cosmo.get_fourier().pk_interpolator(z=self.z_np)
        if (pk.extrap_kmin, pk.extrap_kmax) != (self.config['kmin'], self.config['kmax']):
            raise ValueError('the interpolator spans another k range than the configuration states')
        return pk

    def call(self, batch):
        cosmo = self.cosmology(batch)
        pk = self.pk_interpolator(cosmo)
        filt = self.Filter(pk, engine=self.config['filter'], cosmo=cosmo, cosmo_fid=self.fiducial,
                           nk=self.config['nk'])
        return {'pk': filt.pk, 'pknow': filt.pknow, 'xi': pk.to_xi(nk=self.config['nk']).xi,
                'xi_smooth': filt.smooth_pk_interpolator().to_xi(nk=self.config['nk']).xi,
                'pk_z': pk(self.k, self.z), 'rs_drag': cosmo.rs_drag, 'chi': cosmo.comoving_radial_distance(self.z)}

    def spans(self, batch):
        """The layers' calls at the cell's shapes, for the trace."""
        cosmo = self.cosmology(batch)
        pk = self.pk_interpolator(cosmo)
        filt = self.Filter(pk, engine=self.config['filter'], cosmo=cosmo, cosmo_fid=self.fiducial,
                           nk=self.config['nk'])
        rows = pk(self.k, self.z, ignore_growth=True).transpose(-1, -2).contiguous()

        def to_xi():
            pk.to_xi(nk=self.config['nk'])
            filt.smooth_pk_interpolator().to_xi(nk=self.config['nk'])

        return {'params': lambda: self.cosmology(batch),
                'linear_pk': lambda: self.pk_interpolator(cosmo)(self.k, self.z),
                'bao_filter': lambda: self.Filter(pk, engine=self.config['filter'], cosmo=cosmo,
                                                  cosmo_fid=self.fiducial, nk=self.config['nk']).pknow,
                'to_xi': to_xi,
                'fftlog': lambda: self.transform(rows)}

    def counters(self, batch):
        rows = batch[PARAMS[0]].shape[0] * self.z.shape[0]
        return {'fftlog': {'rows': rows, 'size': self.transform.size, 'padded': self.transform.padded_size,
                           'nparallel': self.transform.nparallel}}


def build(config, device):
    return Entry(config, device)
