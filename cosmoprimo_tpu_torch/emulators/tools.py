"""The reference's ``cosmoprimo.emulators.tools`` namespace
(cosmoprimo_tpu/emulators/tools.py), for what the port serves: the
engine, operation and sample classes live in the sibling modules. The
samplers are not ported yet (ROADMAP slice 6b)."""

from .base import EmulatedCalculator, Emulator, PointEmulatorEngine
from .mlp import MLPEmulatorEngine
from .operations import (ArcsinhOperation, ChebyshevOperation, Log10Operation, NormOperation,
                         Operation, PCAOperation, ScaleOperation)
from .samples import CalculatorComputationError, Samples
from .taylor import TaylorEmulatorEngine

__all__ = ['Emulator', 'PointEmulatorEngine', 'EmulatedCalculator', 'Operation',
           'ScaleOperation', 'NormOperation', 'Log10Operation', 'ArcsinhOperation',
           'PCAOperation', 'ChebyshevOperation', 'TaylorEmulatorEngine',
           'MLPEmulatorEngine', 'Samples', 'CalculatorComputationError']
