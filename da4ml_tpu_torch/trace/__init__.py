from .fixed_variable import FixedVariable, FixedVariableInput, HWConfig
from .fixed_variable_array import FixedVariableArray, FixedVariableArrayInput, LazyUnaryArray
from .pipeline import retime_pipeline, to_pipeline
from .tracer import comb_trace

__all__ = [
    'FixedVariable',
    'FixedVariableInput',
    'HWConfig',
    'FixedVariableArray',
    'FixedVariableArrayInput',
    'LazyUnaryArray',
    'comb_trace',
    'to_pipeline',
    'retime_pipeline',
]
