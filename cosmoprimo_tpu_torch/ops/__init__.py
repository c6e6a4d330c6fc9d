"""Numerical substrate of the port: the parts of cosmoprimo_tpu/ops/ on the
headline path, and the FFTLog core kernel."""

from .fftlog_kernel import fftlog_core, fftlog_core_torch
from .misc import exception_or_nan, flatarray
from .odeint import cumquad_rk4
from .quadrature import simpson
from .spline import Interpolator1D, cubic_eval, natural_cubic_coeffs
