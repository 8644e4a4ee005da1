"""Typing re-exports. Counterpart of ``da4ml_tpu/typing.py``."""

from .cmvm import solver_options_t
from .ir import CombLogic, Op, Pipeline, Precision, QInterval
from .trace import HWConfig

__all__ = ['solver_options_t', 'HWConfig', 'CombLogic', 'Pipeline', 'Op', 'QInterval', 'Precision']
