"""Static analysis of DAIS programs: IR verifier & lint framework.

Three default passes over ``CombLogic`` / ``Pipeline``:

- **wellformed** — SSA causality, opcode table membership, payload ranges,
  io-binding consistency, pipeline stage interfaces;
- **qinterval** — abstract interpretation recomputing every op's value
  interval and flagging unsound annotations (overflow hazards), bad steps,
  and precision loss;
- **deadcode** — unreachable ops, negative/NaN latency or cost, latency
  monotonicity;
- **conformance** (opt-in) — differential execution of every runtime
  backend (numpy, the native interpreter, the CUDA kernel) against the
  reference interpreter generated from the declarative opcode table
  (``ir/optable.py``), reporting per-opcode bit mismatches.

The opcode-specific parts of every pass — legality ranges, interval
transfer functions, the mutation catalog — are generated from the same
table, and the :mod:`.soundness` checker fuzz-proves the transfers against
the concrete replay semantics.

Entry points: :func:`verify` (full diagnostics), :func:`verify_or_raise`
(fail-fast, used by codegen preconditions, ``CombLogic.from_dict`` and the
``DA4ML_VERIFY=1`` post-solve hook), the ``da4ml-tpu-torch verify`` CLI
subcommand (``--conformance`` per program, ``--fuzz`` for the corpus sweep),
and the :mod:`.mutation` corruption catalog for self-tests.

Counterpart of ``da4ml_tpu/analysis/``, without its lint catalogs,
concurrency lint, interleave explorer, docgen and
``apply_planned_corruptions``.
"""

from .conformance import CONFORMANCE_MODES, check_conformance, run_conformance_corpus
from .deadcode import check_deadcode, live_ops
from .diagnostics import ERROR, INFO, RULES, WARNING, Diagnostic, VerificationError, VerifyResult
from .interval import check_intervals, compute_intervals, is_pow2, representable
from .mutation import COMB_CORRUPTIONS, PIPELINE_CORRUPTIONS, Corruption, corruption_by_name
from .runner import (
    OPT_IN_PASSES,
    PASSES,
    codegen_verify_enabled,
    post_solve_verify_enabled,
    verify,
    verify_comb,
    verify_or_raise,
)
from .soundness import check_spec_soundness, check_transfer_soundness
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
    'OPT_IN_PASSES',
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
    'check_conformance',
    'run_conformance_corpus',
    'check_spec_soundness',
    'check_transfer_soundness',
    'CONFORMANCE_MODES',
    'live_ops',
    'is_pow2',
    'representable',
    'DAIS_V1_OPCODES',
    'COMB_CORRUPTIONS',
    'PIPELINE_CORRUPTIONS',
    'Corruption',
    'corruption_by_name',
]
