from .comb import CombLogic, Pipeline
from .dais_binary import DaisProgram, decode, encode
from .fuse import FUSABLE_OPCODES, FusionReport, fuse_binaries, fuse_pipeline, fuse_programs
from .lut import LookupTable, TableSpec, interpret_as, lsb_loc
from .optable import DAIS_V1_OPCODES, OP_TABLE, OPCODE_TO_SPEC, VECTOR_CLASS, OpSpec, family_of, spec_of
from .schedule import LevelSchedule, levelize, levelize_comb, levelize_program
from .types import Op, Precision, QInterval, minimal_kif, qint_add, quantize_float, relu_float

__all__ = [
    'CombLogic',
    'Pipeline',
    'DaisProgram',
    'decode',
    'encode',
    'FUSABLE_OPCODES',
    'FusionReport',
    'fuse_binaries',
    'fuse_pipeline',
    'fuse_programs',
    'OP_TABLE',
    'OPCODE_TO_SPEC',
    'VECTOR_CLASS',
    'OpSpec',
    'DAIS_V1_OPCODES',
    'family_of',
    'spec_of',
    'LevelSchedule',
    'levelize',
    'levelize_comb',
    'levelize_program',
    'LookupTable',
    'TableSpec',
    'Op',
    'Precision',
    'QInterval',
    'minimal_kif',
    'qint_add',
    'quantize_float',
    'relu_float',
    'interpret_as',
    'lsb_loc',
]
