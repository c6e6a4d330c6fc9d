"""cosmoprimo_tpu_torch: the port of cosmoprimo_tpu to PyTorch and CUDA.

Float64 tensors throughout, batch-first: parameters are (B,) tensors and
every function works on the whole batch in one call. The FFTLog core runs as
a hand-written CUDA kernel on CUDA tensors (ops/fftlog_kernel.py,
csrc/fftlog_core.cu). This package imports neither JAX nor cosmoprimo_tpu.
"""

from .cosmology import Cosmology, CosmologyError, CosmologyInputError
from .fftlog import FFTlog, PowerToCorrelation, TophatVariance
from .pipelines import make_pk_to_xi_pipeline_batched

__version__ = '0.1.0'
