"""Numerical substrate of the port: the parts of cosmoprimo_tpu/ops/ that
the ported pipelines run, and the FFTLog core kernel."""

from .fftlog_kernel import fftlog_core, fftlog_core_torch
from .misc import batch_scalar, bcast_dtype, exception_or_nan, flatarray, linspace_rows
from .odeint import cumquad_rk4, linear_ode2_magnus, linear_ode2_rk4_prefix
from .quadrature import cumsum_blocked, gauss_laguerre_nodes, leggauss, romberg, simpson, trapezoid_weights
from .special import sici
from .spline import (Interpolator1D, Interpolator2D, cubic_eval, cubic_eval_rows, interp, natural_cubic_coeffs,
                     natural_cubic_coeffs_rows)
