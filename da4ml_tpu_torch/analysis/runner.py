"""Pass runner: orchestrates the analysis passes over CombLogic / Pipeline.

The framework is a registry of named passes; each pass is a function
``(comb, stage, skip_ops, opts) -> list[Diagnostic]`` (``opts``: the options
of a pass that executes the program, ``check_conformance``'s ``device``,
``modes``, ``n_samples`` and ``seed``). ``verify`` runs a selection of
passes (all but the opt-in ones by default) over every stage of the program
and returns a :class:`~.diagnostics.VerifyResult`;
``verify_or_raise`` is the fail-fast form used as a precondition by codegen,
by ``CombLogic.from_dict`` and by the ``DA4ML_VERIFY=1`` post-solve hook
(cmvm/api.py).

The well-formedness pass always runs first: the op slots it flags as
structurally broken are skipped by the later passes, so a single corrupted
op yields one precise diagnostic instead of a cascade.

Counterpart of ``da4ml_tpu/analysis/runner.py``.
"""

from __future__ import annotations

import os
from typing import Callable, Protocol

from ..ir.comb import CombLogic, Pipeline
from .deadcode import check_deadcode
from .diagnostics import Diagnostic, VerificationError, VerifyResult
from .interval import check_intervals
from .wellformed import bad_op_indices, check_pipeline_interfaces, check_wellformed


class PassFn(Protocol):
    def __call__(
        self, comb: CombLogic, stage: int | None, skip_ops: frozenset[int], opts: dict
    ) -> list[Diagnostic]: ...  # pragma: no cover - typing only


def _conformance_pass(comb, stage, skip_ops, opts):
    from .conformance import conformance_pass

    return conformance_pass(comb, stage, skip_ops, **opts)


#: name -> pass; order is execution order ('wellformed' must stay first)
PASSES: dict[str, Callable] = {
    'wellformed': lambda comb, stage, skip_ops, opts: check_wellformed(comb, stage=stage),
    'qinterval': lambda comb, stage, skip_ops, opts: check_intervals(comb, stage=stage, skip_ops=skip_ops),
    'deadcode': lambda comb, stage, skip_ops, opts: check_deadcode(comb, stage=stage, skip_ops=skip_ops),
    'conformance': _conformance_pass,
}

#: passes excluded from the default selection (expensive: the conformance
#: pass runs the program through every runtime backend, the CUDA kernel on
#: the card among them) — opt in explicitly via ``passes=(...,
#: 'conformance')`` or the CLI's ``--conformance`` flag
OPT_IN_PASSES = frozenset({'conformance'})


def _resolve_passes(passes) -> list[str]:
    if passes is None:
        return [p for p in PASSES if p not in OPT_IN_PASSES]
    unknown = [p for p in passes if p not in PASSES]
    if unknown:
        raise ValueError(f'unknown analysis pass(es) {unknown}; available: {list(PASSES)}')
    return [p for p in PASSES if p in passes]  # registry order


def verify_comb(comb: CombLogic, passes=None, stage: int | None = None, **conformance) -> list[Diagnostic]:
    """Run the selected passes over one CombLogic block (``conformance``:
    the ``conformance`` pass's options)."""
    selected = _resolve_passes(passes)
    diags: list[Diagnostic] = []
    skip: frozenset[int] = frozenset()
    if 'wellformed' in selected:
        wf = check_wellformed(comb, stage=stage)
        diags.extend(wf)
        skip = bad_op_indices(wf)
        selected = [p for p in selected if p != 'wellformed']
    for name in selected:
        diags.extend(PASSES[name](comb, stage, skip, conformance))
    return diags


def verify(program: CombLogic | Pipeline, passes=None, target: str = '', **conformance) -> VerifyResult:
    """Verify a CombLogic or Pipeline; returns the full diagnostic set.
    ``conformance`` takes the opt-in ``conformance`` pass's options
    (``check_conformance``'s ``device``, where the ``'torch'`` executor runs,
    the card when None, ``modes``, ``n_samples`` and ``seed``)."""
    if isinstance(program, Pipeline):
        _resolve_passes(passes)
        diags = list(check_pipeline_interfaces(program)) if passes is None or 'wellformed' in passes else []
        for si, stage in enumerate(program.stages):
            diags.extend(verify_comb(stage, passes=passes, stage=si, **conformance))
        kind = f'Pipeline[{len(program.stages)} stages]'
    elif isinstance(program, CombLogic):
        diags = verify_comb(program, passes=passes, **conformance)
        kind = 'CombLogic'
    else:
        raise TypeError(f'expected CombLogic or Pipeline, got {type(program).__name__}')
    return VerifyResult(diags, target=target or kind)


def verify_or_raise(program: CombLogic | Pipeline, context: str = '', passes=None) -> VerifyResult:
    """Fail-fast form: raise :class:`VerificationError` when errors exist."""
    result = verify(program, passes=passes)
    if not result.ok:
        raise VerificationError(result, context=context)
    return result


# ---------------------------------------------------------------------------
# environment gating
# ---------------------------------------------------------------------------

_ENV_VAR = 'DA4ML_VERIFY'


def post_solve_verify_enabled() -> bool:
    """Opt-in: the post-solve hook only runs with ``DA4ML_VERIFY=1``."""
    return os.environ.get(_ENV_VAR, '0') in ('1', 'true', 'on')


def codegen_verify_enabled() -> bool:
    """Opt-out: codegen preconditions run unless ``DA4ML_VERIFY=0``."""
    return os.environ.get(_ENV_VAR, '1') not in ('0', 'false', 'off')


__all__ = [
    'PASSES',
    'OPT_IN_PASSES',
    'PassFn',
    'verify',
    'verify_comb',
    'verify_or_raise',
    'post_solve_verify_enabled',
    'codegen_verify_enabled',
]
