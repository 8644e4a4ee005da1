from .fixed_variable import FixedVariable, FixedVariableInput, HWConfig
from .fixed_variable_array import FixedVariableArray, FixedVariableArrayInput
from .tracer import comb_trace

__all__ = [
    'FixedVariable',
    'FixedVariableInput',
    'HWConfig',
    'FixedVariableArray',
    'FixedVariableArrayInput',
    'comb_trace',
]
