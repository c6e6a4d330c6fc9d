"""cosmoprimo_tpu_torch: the port of cosmoprimo_tpu to PyTorch and CUDA.

Float64 tensors throughout, batch-first: parameters are (B,) tensors and
every function works on the whole batch in one call. The FFTLog core runs as
a hand-written CUDA kernel on CUDA tensors (ops/fftlog_kernel.py,
csrc/fftlog_core.cu). This package imports neither JAX nor cosmoprimo_tpu.
"""

from . import constants
from .cosmology import Cosmology, CosmologyComputationError, CosmologyError, CosmologyInputError
from .fftlog import (CorrelationToPower, FFTlog, GaussianVariance, HankelTransform, PowerToCorrelation,
                     TophatVariance)
from .bao_filter import CorrelationFunctionBAOFilter, PowerSpectrumBAOFilter
from .fiducial import (DESI, AbacusSummit, BOSS, DESIDR2Flatw0waCDM, Planck2018FullFlatLCDM, TabulatedDESI, Uchuu,
                       save_TabulatedDESI)
from .interpolator import (CorrelationFunctionInterpolator1D, CorrelationFunctionInterpolator2D,
                           PowerSpectrumInterpolator1D, PowerSpectrumInterpolator2D, integrate_sigma_d2,
                           integrate_sigma_r2)
from .models.halofit import halofit, halofit_pk_interpolator
from .models.hmcode import hmcode2020, hmcode_pk_interpolator
from .pipelines import (apply_non_linear, make_distance_pipeline, make_native_pk_pipeline_batched,
                        make_pk_to_xi_pipeline, make_pk_to_xi_pipeline_batched)
from .utils import DistanceToRedshift

__version__ = '0.1.0'
