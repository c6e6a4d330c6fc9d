"""The reference's ``cosmoprimo.emulators.tools`` namespace
(cosmoprimo_tpu/emulators/tools.py): the engine, operation, sample and
sampler classes, which live in the sibling modules, and ``setup_logging``."""

from ..utils import setup_logging
from .base import EmulatedCalculator, Emulator, PointEmulatorEngine
from .mlp import MLPEmulatorEngine
from .operations import (ArcsinhOperation, ChebyshevOperation, Log10Operation, NormOperation,
                         Operation, PCAOperation, ScaleOperation)
from .samples import (CalculatorComputationError, DiffSampler, GridSampler, InputSampler,
                      QMCSampler, Samples)
from .taylor import TaylorEmulatorEngine

__all__ = ['Emulator', 'PointEmulatorEngine', 'EmulatedCalculator', 'Operation',
           'ScaleOperation', 'NormOperation', 'Log10Operation', 'ArcsinhOperation',
           'PCAOperation', 'ChebyshevOperation', 'TaylorEmulatorEngine',
           'MLPEmulatorEngine', 'Samples', 'InputSampler', 'GridSampler',
           'DiffSampler', 'QMCSampler', 'CalculatorComputationError', 'setup_logging']
