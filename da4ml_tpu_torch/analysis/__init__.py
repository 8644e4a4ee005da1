"""Static analysis of DAIS programs: the verifier's default passes.

Three passes over ``CombLogic`` / ``Pipeline``:

- **wellformed** — SSA causality, opcode table membership, payload ranges,
  io-binding consistency, pipeline stage interfaces;
- **qinterval** — abstract interpretation recomputing every op's value
  interval and flagging unsound annotations (overflow hazards), bad steps,
  and precision loss;
- **deadcode** — unreachable ops, negative/NaN latency or cost, latency
  monotonicity.

The opcode-specific parts of every pass (legality ranges, interval transfer
functions) come from the opcode table (``ir/optable.py``).

Entry points: :func:`verify` (full diagnostics) and :func:`verify_or_raise`
(fail-fast, the precondition of codegen and of ``CombLogic.from_dict``).

Counterpart of ``da4ml_tpu/analysis/``, without its ``conformance`` pass,
transfer-soundness checker, mutation harness and lint catalogs.
"""

from .deadcode import check_deadcode, live_ops
from .diagnostics import ERROR, INFO, RULES, WARNING, Diagnostic, VerificationError, VerifyResult
from .interval import check_intervals, compute_intervals, is_pow2, representable
from .runner import (
    PASSES,
    codegen_verify_enabled,
    post_solve_verify_enabled,
    verify,
    verify_comb,
    verify_or_raise,
)
from .wellformed import DAIS_V1_OPCODES, bad_op_indices, check_pipeline_interfaces, check_wellformed

__all__ = [
    'Diagnostic',
    'VerifyResult',
    'VerificationError',
    'RULES',
    'ERROR',
    'WARNING',
    'INFO',
    'PASSES',
    'verify',
    'verify_comb',
    'verify_or_raise',
    'post_solve_verify_enabled',
    'codegen_verify_enabled',
    'check_wellformed',
    'check_pipeline_interfaces',
    'bad_op_indices',
    'check_intervals',
    'compute_intervals',
    'check_deadcode',
    'live_ops',
    'is_pow2',
    'representable',
    'DAIS_V1_OPCODES',
]
