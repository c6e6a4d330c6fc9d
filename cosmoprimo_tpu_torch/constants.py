"""Physical constants for cosmology (SI unless noted).

The values of cosmoprimo_tpu/constants.py (CODATA 2018), copied so that this
package does not import the JAX package.
"""

import math

# CODATA 2018 / SI exact values
c = 299792458.0                       # speed of light, m/s
gravitational_constant = 6.6743e-11   # m^3 / kg / s^2
Boltzmann = 1.380649e-23              # J / K (exact, SI 2019)
Stefan_Boltzmann = 5.670374419184429e-08  # W / m^2 / K^4 (derived, exact)
parsec = 3.085677581491367e+16        # m (exact, IAU 2015)

electronvolt_over_joule = 1.602176634e-19   # J (exact)
megaparsec_over_m = 1e6 * parsec            # m
msun_over_kg = 1.98847e30                   # kg

# Critical density today / h^2, in kg/m^3:  3 (100 km/s/Mpc)^2 / (8 pi G)
rho_crit_over_kgph_per_mph3 = 3.0 * (100.0 * 1e3 / megaparsec_over_m) ** 2 / (8 * math.pi * gravitational_constant)
# Same in 1e10 Msun/h / (Mpc/h)^3
rho_crit_over_Msunph_per_Mpcph3 = rho_crit_over_kgph_per_mph3 / (1e10 * msun_over_kg) * megaparsec_over_m ** 3

# CLASS conventions (explanatory.ini)
TNCDM_OVER_CMB = 0.71611
NEFF = 3.044
TCMB = 2.7255

gigayear_over_megaparsec = 3.06601394e2  # Mpc -> Gyr conversion for c/H distances
