"""Transfer-soundness checker: the abstract interval transfers must contain
every concrete result.

For each opcode row of the declarative table (``ir/optable.py``), the row's
``sample`` builds an *honest* randomized one-op program: operand slots are
copy ops carrying randomized QIntervals, and the op under test carries the
annotation a correct producer would write. Concrete inputs are drawn from
the operand intervals' dyadic grids and replayed through the real
``CombLogic.__call__`` float path; the abstract output interval comes from
the same per-opcode ``transfer`` functions the ``qinterval`` verifier pass
dispatches on (``interval.compute_intervals``).

A concrete result escaping the abstract interval — or the verifier flagging
an honest program as unsound — is a **verifier bug**, surfaced as a
**D310 transfer-unsound** diagnostic (not a silent miscompile): it means the
``qinterval`` pass could green-light an annotation that overflows in
hardware, since codegen sizes every wire from ``minimal_kif(op.qint)``.

Counterpart of ``da4ml_tpu/analysis/soundness.py``.
"""

from __future__ import annotations

import numpy as np

from ..ir.comb import CombLogic
from ..ir.optable import COPY_OPCODES, OP_TABLE, OpSpec
from ..ir.types import QInterval
from .diagnostics import ERROR, Diagnostic
from .interval import compute_intervals

_TOL = 1e-9


def _grid_samples(rng: np.random.Generator, qi: QInterval, n: int) -> np.ndarray:
    """Concrete values on the interval's dyadic grid."""
    lo, hi = round(qi.min / qi.step), round(qi.max / qi.step)
    return rng.integers(lo, hi + 1, n) * qi.step


def _case_comb(case) -> CombLogic:
    n_lanes = max(1, sum(1 for o in case.ops if o.opcode in COPY_OPCODES))
    return CombLogic(
        shape=(n_lanes, 1),
        inp_shifts=[0] * n_lanes,
        out_idxs=[case.op_index],
        out_shifts=[0],
        out_negs=[False],
        ops=list(case.ops),
        carry_size=32,
        adder_size=32,
        lookup_tables=case.tables,
    )


def check_spec_soundness(
    spec: OpSpec, rng: np.random.Generator, n_cases: int = 25, n_samples: int = 16
) -> list[Diagnostic]:
    """Fuzz one table row: ``n_cases`` honest programs × ``n_samples``
    concrete grid points each."""
    diags: list[Diagnostic] = []
    for ci in range(n_cases):
        case = spec.sample(rng)
        comb = _case_comb(case)
        op = comb.ops[case.op_index]
        computed, interval_diags = compute_intervals(comb)
        false_positives = [d for d in interval_diags if d.severity == ERROR]
        if false_positives:
            diags.append(
                Diagnostic(
                    'D310',
                    f'{spec.key} case {ci}: the qinterval pass flags an honest program as unsound '
                    f'({false_positives[0].rule}: {false_positives[0].message})',
                    op_index=case.op_index,
                    opcode=op.opcode,
                )
            )
            continue
        ci_abs = computed[case.op_index]
        if ci_abs is None:
            continue
        lanes = [o for o in comb.ops if o.opcode in COPY_OPCODES and o is not op]
        tol = _TOL * max(1.0, abs(ci_abs.min), abs(ci_abs.max))
        for si in range(n_samples):
            x = np.zeros(comb.shape[0])
            for o in lanes:
                x[int(o.id0)] = _grid_samples(rng, o.qint, 1)[0]
            if op.opcode in COPY_OPCODES:  # the op under test reads the input directly
                x[int(op.id0)] = _grid_samples(rng, op.qint, 1)[0]
            y = float(comb(x)[0])
            if not (ci_abs.min - tol <= y <= ci_abs.max + tol):
                diags.append(
                    Diagnostic(
                        'D310',
                        f'{spec.key} case {ci} sample {si}: concrete result {y} escapes the abstract '
                        f'interval [{ci_abs.min}, {ci_abs.max}] (inputs {x.tolist()}, op {op})',
                        op_index=case.op_index,
                        opcode=op.opcode,
                    )
                )
                break
    return diags


def check_transfer_soundness(
    n_cases: int = 25, n_samples: int = 16, seed: int = 0
) -> tuple[dict, list[Diagnostic]]:
    """Fuzz every opcode row; returns ``(report, diagnostics)``.

    The report carries per-opcode case counts so the CI artifact shows what
    was proven, not just that nothing failed.
    """
    diags: list[Diagnostic] = []
    per_family: dict[str, dict] = {}
    for spec in OP_TABLE:
        rng = np.random.default_rng(seed * 1_000_003 + spec.vector_class)
        found = check_spec_soundness(spec, rng, n_cases=n_cases, n_samples=n_samples)
        per_family[spec.key] = {
            'family': spec.family,
            'opcodes': list(spec.opcodes),
            'cases': n_cases,
            'samples_per_case': n_samples,
            'counterexamples': len(found),
        }
        diags.extend(found)
    report = {
        'ok': not diags,
        'seed': seed,
        'per_family': per_family,
        'diagnostics': [d.to_dict() for d in diags],
    }
    return report, diags


__all__ = ['check_spec_soundness', 'check_transfer_soundness']
