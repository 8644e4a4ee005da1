"""Well-formedness pass: structural SSA validity of a DAIS program.

Checks that the program is executable at all — every operand reference names
an earlier buffer slot (SSA causality), every opcode is in the DAIS v1 table,
packed payloads (mux condition/shift, bitwise sub-opcodes, lookup table
indices) are in range, and the io binding arrays are consistent with
``shape``. Runs in O(n_ops); the other passes assume a program that passed
this one (the runner feeds them the set of structurally-bad ops to skip).

Everything opcode-specific here is *generated* from the declarative opcode
table (``ir/optable.py``): the legal opcode set, which ops read ``id1`` /
carry a condition slot in ``data``, how payload shifts are extracted, and
the per-row payload legality checks. A new opcode lands by adding a table
row — this pass picks it up without edits.

Counterpart of ``da4ml_tpu/analysis/wellformed.py``.
"""

from __future__ import annotations

from ..ir.comb import CombLogic, Pipeline
from ..ir.optable import (
    BINARY_OPCODES as _BINARY_OPCODES,  # noqa: F401  (re-export for consumers)
    DAIS_V1_OPCODES,
    OPCODE_TO_SPEC,
    SHIFT_LIMIT,
    op_operands,
    op_shift,
)
from .diagnostics import Diagnostic


def check_wellformed(comb: CombLogic, stage: int | None = None) -> list[Diagnostic]:
    diags: list[Diagnostic] = []

    def emit(rule: str, message: str, op_index: int | None = None, opcode: int | None = None):
        diags.append(Diagnostic(rule, message, op_index=op_index, stage=stage, opcode=opcode))

    # ---- container-level consistency
    n_in, n_out = (int(v) for v in comb.shape)
    if n_in <= 0 or n_out <= 0:
        emit('W101', f'shape must be positive, got ({n_in}, {n_out})')
    if len(comb.inp_shifts) != n_in:
        emit('W101', f'inp_shifts has {len(comb.inp_shifts)} entries for {n_in} inputs')
    if not (len(comb.out_idxs) == len(comb.out_shifts) == len(comb.out_negs) == n_out):
        emit(
            'W101',
            f'output bindings have {len(comb.out_idxs)}/{len(comb.out_shifts)}/{len(comb.out_negs)} '
            f'entries for {n_out} outputs',
        )

    n_ops = len(comb.ops)
    n_tables = len(comb.lookup_tables) if comb.lookup_tables is not None else None

    # ---- per-op checks (legality data generated from the opcode table)
    for i, op in enumerate(comb.ops):
        spec = OPCODE_TO_SPEC.get(op.opcode)
        if spec is None:
            emit('W102', f'opcode {op.opcode} is not in the DAIS v1 table', i, opcode=int(op.opcode))
            continue

        if spec.id0 == 'lane':
            lane = int(op.id0)
            if not 0 <= lane < n_in:
                emit('W104', f'copy op reads input lane {lane}, program has {n_in} inputs', i, opcode=op.opcode)
        else:
            for slot in op_operands(op):
                if not 0 <= slot < i:
                    which = 'condition' if spec.cond_in_data and slot not in (op.id0, op.id1) else 'operand'
                    emit(
                        'W103',
                        f'{which} slot {slot} is not an earlier SSA slot (op is at slot {i})',
                        i,
                        opcode=op.opcode,
                    )

        shift = op_shift(op)
        if shift is not None and abs(shift) > SHIFT_LIMIT:
            emit('W106', f'shift {shift} exceeds the plausible range +-{SHIFT_LIMIT}', i, opcode=op.opcode)

        if spec.payload_check is not None:
            for rule, message in spec.payload_check(op, n_tables):
                emit(rule, message, i, opcode=op.opcode)

    # ---- output bindings (out_idx == -1 marks an intentionally dead lane)
    for j, idx in enumerate(comb.out_idxs):
        idx = int(idx)
        if idx != -1 and not 0 <= idx < n_ops:
            emit('W105', f'output {j} bound to slot {idx}, program has {n_ops} ops')

    return diags


def check_pipeline_interfaces(pipeline: Pipeline) -> list[Diagnostic]:
    """Stage-to-stage interface consistency of a Pipeline."""
    diags: list[Diagnostic] = []
    if not pipeline.stages:
        return [Diagnostic('W101', 'pipeline has no stages')]
    for si in range(len(pipeline.stages) - 1):
        n_out = int(pipeline.stages[si].shape[1])
        n_in = int(pipeline.stages[si + 1].shape[0])
        if n_out != n_in:
            diags.append(
                Diagnostic(
                    'W120',
                    f'stage {si} produces {n_out} outputs but stage {si + 1} expects {n_in} inputs',
                    stage=si,
                )
            )
    return diags


def bad_op_indices(diags: list[Diagnostic]) -> frozenset[int]:
    """Op slots with structural errors — downstream passes skip these."""
    return frozenset(d.op_index for d in diags if d.op_index is not None and d.severity == 'error')


__all__ = [
    'DAIS_V1_OPCODES',
    'SHIFT_LIMIT',
    'check_wellformed',
    'check_pipeline_interfaces',
    'bad_op_indices',
    'op_operands',
    'op_shift',
]
