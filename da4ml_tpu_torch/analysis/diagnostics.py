"""Structured diagnostics of the DAIS verifier.

Every finding a pass emits is a :class:`Diagnostic`: a stable rule id from
the catalog below, a severity, the op index it anchors to (when applicable),
the DAIS opcode it concerns (when applicable, with its family label from the
opcode table), and a human-readable message. Diagnostics are plain data,
JSON-serializable via :meth:`Diagnostic.to_dict`.

Counterpart of ``da4ml_tpu/analysis/diagnostics.py``; the rule catalog is
the same, including the rules of passes the port does not run yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

ERROR = 'error'
WARNING = 'warning'
INFO = 'info'

_SEVERITY_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

#: rule id -> (short name, default severity, meaning)
RULES: dict[str, tuple[str, str, str]] = {
    'W101': ('shape-mismatch', ERROR, 'io binding arrays inconsistent with `shape`'),
    'W102': ('unknown-opcode', ERROR, 'opcode not in the DAIS v1 table'),
    'W103': ('operand-violation', ERROR, 'operand slot out of range or not earlier (SSA)'),
    'W104': ('input-lane', ERROR, 'copy op reads a non-existent input lane'),
    'W105': ('output-binding', ERROR, 'output bound to a non-existent op slot'),
    'W106': ('shift-range', ERROR, 'implausible power-of-two shift magnitude'),
    'W110': ('lut-binding', ERROR, 'lookup references a missing/invalid table'),
    'W111': ('bitwise-subop', ERROR, 'unknown bitwise sub-opcode'),
    'W120': ('stage-interface', ERROR, 'pipeline stage widths do not chain'),
    'Q201': ('step-not-pow2', ERROR, '`QInterval.step` not a positive power of two'),
    'Q202': ('interval-bounds', ERROR, 'NaN/inf interval bound, or min > max'),
    'Q210': ('interval-unsound', ERROR, 'annotation cannot hold the computed interval'),
    'Q220': ('precision-loss', WARNING, 'quantize op drops bits vs its operand'),
    'Q221': ('lut-interval', WARNING, 'lookup annotation disagrees with its table'),
    'D301': ('dead-op', WARNING, 'op result never reaches an output'),
    'D302': ('cost-model', ERROR, 'negative/NaN latency or cost'),
    'D303': ('latency-monotone', WARNING, 'op latency below an operand\'s latency'),
    'D310': ('transfer-unsound', ERROR, 'a concrete result escapes the abstract transfer interval (verifier bug)'),
    'C401': ('backend-mismatch', ERROR, 'a runtime backend diverges bit-wise from the table-generated reference'),
    'C402': ('coverage-gap', ERROR, 'an opcode of the DAIS v1 table has no coverage in the fuzz corpus'),
    'X501': ('unregistered-lock', ERROR, 'a `threading` lock/condition constructed outside `locktrace.LOCK_TABLE`'),
    'X502': ('stale-lock-entry', ERROR, 'a `LOCK_TABLE` entry with no construction site left in the library'),
    'X503': ('static-rank-inversion', ERROR, 'lexically nested lock acquisition against the declared rank order'),
    'X504': ('lock-over-io', ERROR, 'HTTP/subprocess/jax-dispatch/sleep call while lexically holding a lock (absent a documented `io_ok` waiver)'),
    'X505': ('unregistered-thread', ERROR, 'a `threading.Thread` whose name prefix is missing from `locktrace.THREAD_TABLE` (or unnamed)'),
    'X506': ('stale-thread-entry', ERROR, 'a `THREAD_TABLE` entry with no construction site left in the library'),
    'X507': ('no-shutdown-path', ERROR, 'a daemon thread whose table entry declares no shutdown/drain path'),
    'X510': ('lock-cycle', ERROR, 'runtime lock-order graph contains a cycle (potential deadlock) — DA4ML_LOCKTRACE'),
    'X511': ('rank-inversion', ERROR, 'runtime acquisition nested against the declared rank order — DA4ML_LOCKTRACE'),
    'X512': ('invariant-violation', ERROR, 'an interleaving-harness invariant (single winner, exact tally, no lost request) failed under a seeded schedule'),
    'X513': ('schedule-deadlock', ERROR, 'every runnable thread blocked under a seeded schedule — a real interleaving deadlock'),
    'X520': ('undocumented-metric', ERROR, 'a metric emitted by the library with no `telemetry.catalog.METRICS` entry (no HELP text)'),
    'X521': ('stale-metric-entry', ERROR, 'a `METRICS`/`DYNAMIC_SITES` entry with no emission site left in the library'),
    'X522': ('unregistered-dynamic-metric', ERROR, 'a dynamically-named metric emission in a module not registered in `telemetry.catalog.DYNAMIC_SITES`'),
    'X523': ('metric-doc-missing', ERROR, 'a catalogued metric family with no row in docs/telemetry.md'),
    'X524': ('undocumented-knob', ERROR, 'a `DA4ML_*` environment variable read by the library but missing from `analysis.catalogs.KNOBS`'),
    'X525': ('stale-knob-entry', ERROR, 'a `KNOBS` entry no longer read anywhere in the library'),
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding of a verifier pass."""

    rule: str
    message: str
    op_index: int | None = None
    stage: int | None = None
    severity: str = field(default='')
    opcode: int | None = None

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f'unknown rule id {self.rule!r}')
        if not self.severity:
            object.__setattr__(self, 'severity', RULES[self.rule][1])
        elif self.severity not in _SEVERITY_ORDER:
            raise ValueError(f'unknown severity {self.severity!r}')

    @property
    def name(self) -> str:
        return RULES[self.rule][0]

    @property
    def opcode_family(self) -> str | None:
        """Stable family label from the opcode table (None when no opcode)."""
        from ..ir.optable import family_of

        return family_of(self.opcode)

    def to_dict(self) -> dict:
        return {
            'rule': self.rule,
            'name': self.name,
            'severity': self.severity,
            'stage': self.stage,
            'op': self.op_index,
            'opcode': self.opcode,
            'opcode_family': self.opcode_family,
            'message': self.message,
        }

    def __str__(self) -> str:
        where = ''
        if self.stage is not None:
            where += f'stage {self.stage} '
        if self.op_index is not None:
            where += f'op {self.op_index} '
        if self.opcode is not None:
            where += f'(opcode {self.opcode}) '
        return f'{self.severity.upper()} {self.rule} [{self.name}] {where.strip()}: {self.message}'.replace(' :', ':')


class VerifyResult:
    """Outcome of running the verifier: an ordered list of diagnostics."""

    def __init__(self, diagnostics: list[Diagnostic], target: str = 'program'):
        self.diagnostics = list(diagnostics)
        self.target = target

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        """No errors (warnings/info allowed)."""
        return not self.errors

    def by_rule(self, rule: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.rule == rule]

    def by_opcode(self) -> dict[int | None, list[Diagnostic]]:
        """Diagnostics grouped by the DAIS opcode they concern."""
        groups: dict[int | None, list[Diagnostic]] = {}
        for d in self.diagnostics:
            groups.setdefault(d.opcode, []).append(d)
        return groups

    def sorted(self) -> list[Diagnostic]:
        return sorted(
            self.diagnostics,
            key=lambda d: (_SEVERITY_ORDER[d.severity], d.stage or 0, d.op_index if d.op_index is not None else -1),
        )

    def summary(self) -> str:
        n_err, n_warn = len(self.errors), len(self.warnings)
        verdict = 'FAILED' if n_err else 'ok'
        return f'{self.target}: {verdict} ({n_err} error(s), {n_warn} warning(s))'

    def format_text(self, show_warnings: bool = True) -> str:
        lines = [self.summary()]
        for d in self.sorted():
            if d.severity != ERROR and not show_warnings:
                continue
            lines.append(f'  {d}')
        return '\n'.join(lines)

    def to_dict(self) -> dict:
        return {
            'target': self.target,
            'ok': self.ok,
            'n_errors': len(self.errors),
            'n_warnings': len(self.warnings),
            'diagnostics': [d.to_dict() for d in self.sorted()],
        }

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def __repr__(self) -> str:
        return f'VerifyResult({self.summary()})'


class VerificationError(ValueError):
    """A DAIS program failed verification. Carries the full result."""

    def __init__(self, result: VerifyResult, context: str = ''):
        self.result = result
        prefix = f'{context}: ' if context else ''
        super().__init__(prefix + result.format_text(show_warnings=False))
