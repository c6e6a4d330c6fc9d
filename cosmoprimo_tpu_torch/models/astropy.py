"""Background-only engine backed by astropy.cosmology
(cosmoprimo_tpu/models/astropy.py), on the host: it picks the flat or
curved (w0wa/w/Lambda)CDM class of astropy that matches the parameters.

astropy is optional and imported when the engine is built; without it the
engine raises :class:`CosmologyInputError`. One cosmology at a time: the
astropy objects are not batched.
"""

import numpy as np
import torch

from ..cosmology import BaseEngine, BaseSection, CosmologyInputError, register_engine
from ..ops import flatarray


@register_engine
class AstropyEngine(BaseEngine):
    """Engine wrapping astropy.cosmology (background only)."""

    name = 'astropy'

    def __init__(self, cosmo, **extra_params):
        super().__init__(cosmo, **extra_params)
        try:
            from astropy import cosmology, units
        except ImportError as exc:
            raise CosmologyInputError("astropy is required for engine 'astropy'; install it or use the "
                                      "'tabulated' / analytic engines.") from exc
        if self.batch_shape != ():
            raise CosmologyInputError("engine 'astropy' takes one cosmology, not a batch")

        def scalar(name):
            return float(self[name])

        flat = scalar('Omega_k') == 0.0
        w0, wa = scalar('w0_fld'), scalar('wa_fld')
        kwargs = dict(H0=scalar('H0'), Om0=scalar('Omega_cdm') + scalar('Omega_b'), Tcmb0=scalar('T_cmb'),
                      Neff=scalar('N_eff'), Ob0=scalar('Omega_b'),
                      m_nu=self['m_ncdm'].cpu().numpy() * units.eV if self['N_ncdm'] else None)
        if bool(self._has_fld):
            if wa != 0.0:
                cls = cosmology.Flatw0waCDM if flat else cosmology.w0waCDM
                kwargs.update(w0=w0, wa=wa)
            else:
                cls = cosmology.FlatwCDM if flat else cosmology.wCDM
                kwargs.update(w0=w0)
        else:
            cls = cosmology.FlatLambdaCDM if flat else cosmology.LambdaCDM
        if not flat:
            kwargs['Ode0'] = scalar('Omega_de')
        self.astropy = cls(**{name: value for name, value in kwargs.items() if value is not None})


class Background(BaseSection):
    """Background quantities from astropy (distances in Mpc/h)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._astropy = engine.astropy
        self._h = engine['h']

    def _call(self, name, z, unit=False):
        value = getattr(self._astropy, name)(z.cpu().numpy())
        return torch.as_tensor(np.asarray(value.value if unit else value), dtype=torch.float64, device=self.device)

    @flatarray()
    def efunc(self, z):
        return self._call('efunc', z)

    @flatarray()
    def hubble_function(self, z):
        return self._call('H', z, unit=True)

    @flatarray()
    def comoving_radial_distance(self, z):
        return self._call('comoving_distance', z, unit=True) * self._h

    @flatarray()
    def angular_diameter_distance(self, z):
        return self._call('angular_diameter_distance', z, unit=True) * self._h

    @flatarray()
    def luminosity_distance(self, z):
        return self._call('luminosity_distance', z, unit=True) * self._h

    @flatarray()
    def comoving_transverse_distance(self, z):
        return self._call('comoving_transverse_distance', z, unit=True) * self._h

    @flatarray()
    def Omega_m(self, z):
        return self._call('Om', z)

    @flatarray()
    def Omega_de(self, z):
        return self._call('Ode', z)

    @property
    def age(self):
        return torch.as_tensor(self._astropy.age(0.0).value, dtype=torch.float64, device=self.device)
