"""Dead-code & cost lint pass.

- **D301 dead-op** — an op whose result no output transitively reads. Copy
  ops (opcode -1) are exempt: keeping unread input fetches is how the IR
  preserves a program's input arity (``dead_statement_elimination``'s
  ``keep_dead_inputs``), and the CMVM solver always emits one per input.
- **D302 cost-model** — negative or non-finite latency/cost poisons every
  aggregate metric (``CombLogic.cost``, retiming cutoffs), so it is an error.
- **D303 latency-monotone** — an op scheduled before one of its operands
  finishes; the cost model guarantees ``latency >= max(operand latencies)``,
  a violation means the latency fields were corrupted or miscomputed.

Counterpart of ``da4ml_tpu/analysis/deadcode.py``.
"""

from __future__ import annotations

from math import isfinite

from ..ir.comb import CombLogic
from ..ir.optable import COPY_OPCODES
from .diagnostics import Diagnostic
from .wellformed import op_operands

_EPS = 1e-9


def live_ops(comb: CombLogic) -> bytearray:
    """Backward reachability from the output bindings (1 = live)."""
    n = len(comb.ops)
    live = bytearray(n)
    stack = [int(i) for i in comb.out_idxs if 0 <= int(i) < n]
    for i in stack:
        live[i] = 1
    while stack:
        i = stack.pop()
        for j in op_operands(comb.ops[i]):
            if 0 <= j < n and not live[j]:
                live[j] = 1
                stack.append(j)
    return live


def check_deadcode(
    comb: CombLogic,
    stage: int | None = None,
    skip_ops: frozenset[int] = frozenset(),
) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    n = len(comb.ops)
    live = live_ops(comb)

    for i, op in enumerate(comb.ops):
        if i in skip_ops:
            continue

        def emit(rule: str, message: str, op_index: int, _oc=op.opcode):
            diags.append(Diagnostic(rule, message, op_index=op_index, stage=stage, opcode=_oc))

        for name, v in (('latency', op.latency), ('cost', op.cost)):
            if not isinstance(v, (int, float)) or not isfinite(v):
                emit('D302', f'op {name} is {v!r}', i)
            elif v < 0:
                emit('D302', f'op {name} is negative ({v})', i)

        if not live[i] and op.opcode not in COPY_OPCODES:
            emit('D301', f'op result (opcode {op.opcode}) never reaches an output', i)

        if isinstance(op.latency, (int, float)) and isfinite(op.latency):
            for j in op_operands(op):
                if 0 <= j < min(i, n) and j not in skip_ops:
                    dep = comb.ops[j].latency
                    if isinstance(dep, (int, float)) and isfinite(dep) and op.latency + _EPS < dep:
                        emit(
                            'D303',
                            f'op latency {op.latency} is below operand slot {j} latency {dep}',
                            i,
                        )

    return diags


__all__ = ['check_deadcode', 'live_ops']
