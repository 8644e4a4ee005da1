"""QInterval soundness pass: abstract interpretation over the op list.

Recomputes each op's value interval from its operands per the DAIS opcode
semantics (the same semantics ``CombLogic.__call__`` replays) and flags
annotations that cannot hold the computed values — an overflow hazard, since
codegen sizes every wire from ``minimal_kif(op.qint)``.

The per-opcode transfer functions live in the declarative opcode table
(``ir/optable.py``, one ``transfer`` per row) — this pass only owns the
structural interval checks (finite ordered bounds, power-of-two step) and
the dispatch loop. The producer conventions the transfers respect:

- The greedy CMVM optimizer (cmvm/core.py ``to_solution``) tracks negative
  adder-tree contributions by *sign-flipping* the stored interval, so an
  add op's annotation may be the interval of the negated value — and after
  two levels of mixing, an interval of equal span but shifted position.
  Containment is therefore checked against the computed interval, its
  negation, and finally span+step (which is invariant under those flips).
- Quantize-family ops (copy, relu-quantize, quantize) *define* their result
  container — a narrower annotation is the whole point. They get
  precision-loss warnings (Q220) instead of errors, and their annotation is
  trusted for downstream propagation.
- ``msb_mux`` annotations may be narrower than the branch hull (the tracer
  exploits branch correlation, e.g. in ``abs``), so the mux gets only
  structural checks.
- Squaring (``mul`` with id0 == id1) is bounded by the squared endpoints,
  not the four-corner product hull.

Every interval is dyadic and computed the same way the producers compute it,
so comparisons use an epsilon only as belt-and-braces.

Counterpart of ``da4ml_tpu/analysis/interval.py``.
"""

from __future__ import annotations

from math import isfinite, log2

from ..ir.comb import CombLogic
from ..ir.optable import OPCODE_TO_SPEC
from ..ir.types import QInterval, minimal_kif
from .diagnostics import Diagnostic

_EPS = 1e-9


def is_pow2(step: float) -> bool:
    """True when ``step`` is a positive (finite) power of two."""
    if not isinstance(step, (int, float)) or not isfinite(step) or step <= 0:
        return False
    f = log2(step)
    return f == round(f)


def _tol(*vals: float) -> float:
    return _EPS * max(1.0, *(abs(v) for v in vals if isfinite(v)))


def compute_intervals(
    comb: CombLogic,
    skip_ops: frozenset[int] = frozenset(),
) -> tuple[list[QInterval | None], list[Diagnostic]]:
    """Abstractly interpret the op list; returns (per-op computed intervals,
    diagnostics). ``None`` marks a slot whose interval could not be computed
    (structurally bad or skipped)."""
    diags: list[Diagnostic] = []
    n_ops = len(comb.ops)
    computed: list[QInterval | None] = [None] * n_ops

    def operand(idx: int) -> QInterval | None:
        if 0 <= idx < n_ops:
            return computed[idx]
        return None

    for i, op in enumerate(comb.ops):
        if i in skip_ops:
            continue
        q = op.qint

        def emit(rule: str, message: str, _i=i, _oc=op.opcode):
            diags.append(Diagnostic(rule, message, op_index=_i, opcode=_oc))

        # ---- structural interval validity (applies to every opcode)
        bad = False
        for name, v in (('min', q.min), ('max', q.max), ('step', q.step)):
            if not isinstance(v, (int, float)) or not isfinite(v):
                emit('Q202', f'QInterval.{name} is {v!r}')
                bad = True
        if not bad and q.min > q.max + _tol(q.min, q.max):
            emit('Q202', f'QInterval has min {q.min} > max {q.max}')
            bad = True
        # zero-point intervals mark dead/constant-zero slots; any step is
        # accepted there, mirroring minimal_kif's early return
        if not bad and not (q.min == q.max == 0.0) and not is_pow2(q.step):
            emit('Q201', f'QInterval.step must be a positive power of two, got {q.step}')
            bad = True
        if bad:
            continue  # computed[i] stays None: downstream checks skip

        # ---- per-opcode abstract interpretation (table-generated dispatch)
        spec = OPCODE_TO_SPEC.get(op.opcode)
        if spec is None:
            continue  # W102 territory; wellformed flags it
        c, checks = spec.transfer(comb, op, q, operand)
        computed[i] = c
        for rule, message in checks:
            emit(rule, message)

    return computed, diags


def check_intervals(
    comb: CombLogic,
    stage: int | None = None,
    skip_ops: frozenset[int] = frozenset(),
) -> list[Diagnostic]:
    _, diags = compute_intervals(comb, skip_ops=skip_ops)
    if stage is not None:
        diags = [
            Diagnostic(d.rule, d.message, op_index=d.op_index, stage=stage, severity=d.severity, opcode=d.opcode)
            for d in diags
        ]
    return diags


def representable(q: QInterval) -> QInterval:
    """Full value range of the minimal fixed-point container of ``q``."""
    k, i, f = minimal_kif(q)
    step = 2.0**-f
    span = float(2.0**i)
    return QInterval(-span if k else 0.0, span - step, step)


__all__ = ['check_intervals', 'compute_intervals', 'is_pow2', 'representable']
