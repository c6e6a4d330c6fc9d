"""Numerical substrate of the port: the parts of cosmoprimo_tpu/ops/ that
the ported pipelines run, and the FFTLog core kernel."""

from .fftlog_kernel import fftlog_core, fftlog_core_torch
from .misc import batch_scalar, bcast_dtype, exception, exception_or_nan, flatarray, linspace_rows
from .odeint import cumquad_rk4, linear_ode2_magnus, linear_ode2_rk4_prefix, odeint
from .quadrature import (cumsum_blocked, fixed_quad_legendre, gauss_laguerre_nodes, gauss_legendre, leggauss, romberg,
                         simpson, trapezoid_weights)
from .roots import bisect, bracket
from .special import gamma, loggamma, sici
from .spline import (Interpolator1D, Interpolator2D, cubic_eval, cubic_eval_rows, interp, natural_cubic_coeffs,
                     natural_cubic_coeffs_rows, tridiagonal_solve)
