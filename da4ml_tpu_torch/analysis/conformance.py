"""Cross-backend conformance checker: differential execution against the
table-generated reference interpreter.

Every runtime backend of the port promises bit-exactness with the DAIS v1
semantics: the vectorized numpy interpreter (``'numpy'``), the native host
interpreter (``'cpp'``) and ``DaisExecutor`` (``'torch'``: the CUDA kernel on
the card, its plain torch version with ``device='cpu'``). This pass makes
that promise checkable: it executes a program through each backend and
compares outputs bit-wise against ``runtime.reference`` — the interpreter
generated from the declarative opcode table (``ir/optable.py``). A
divergence is reported as a structured **C401 backend-mismatch** diagnostic
anchored to the earliest divergent op (numpy exposes its execution buffer;
the other modes are attributed through the output binding), carrying the
opcode so ``--json`` output groups per-opcode.

No mode is skipped: a backend that fails to build, load or launch on a
program the reference executes is a C401 diagnostic too.

Two entry points:

- :func:`check_conformance` — one program (CombLogic or decoded
  DaisProgram); runs as the opt-in ``conformance`` pass of
  ``da4ml-tpu-torch verify --conformance``;
- :func:`run_conformance_corpus` — the fuzz-corpus sweep over ``ir.synth``
  programs (``da4ml-tpu-torch verify --fuzz N``), which additionally audits
  per-opcode corpus coverage (**C402**) and returns a JSON-ready report with
  per-opcode op/mismatch counts.

Counterpart of ``da4ml_tpu/analysis/conformance.py``, whose jax
``unroll``/``scan``/``level``/``pallas`` modes are ``'torch'`` here.
"""

from __future__ import annotations

import numpy as np

from ..ir.comb import CombLogic
from ..ir.dais_binary import DaisProgram, decode, encode
from ..ir.optable import DAIS_V1_OPCODES, OPCODE_TO_SPEC, family_of
from ..ir.synth import random_inputs, random_program
from .diagnostics import Diagnostic

#: execution targets differentially checked against the reference; 'torch'
#: runs on the caller's device (the CUDA kernel on the card)
CONFORMANCE_MODES = ('numpy', 'cpp', 'torch')


def _as_prog(program) -> DaisProgram:
    if isinstance(program, CombLogic):
        return decode(program.to_binary())
    return program


def _first_divergent_op(prog: DaisProgram, ref_buf: np.ndarray, got_buf: np.ndarray) -> int:
    diff = np.any(ref_buf != got_buf, axis=1)
    return int(np.argmax(diff)) if diff.any() else -1


def _run_mode(prog: DaisProgram, mode: str, data: np.ndarray, device=None):
    """Execute one backend; returns (outputs, buffer | None)."""
    if mode == 'numpy':
        from ..runtime.numpy_backend import run_program

        return run_program(prog, data, return_buf=True)
    if mode == 'cpp':
        from ..native import run_binary

        return run_binary(encode(prog), data), None
    if mode == 'torch':
        from ..runtime.torch_backend import DaisExecutor

        return DaisExecutor(prog, device=device)(data), None
    raise ValueError(f'unknown conformance mode {mode!r}; available: {CONFORMANCE_MODES}')


def check_conformance(
    program,
    modes: tuple[str, ...] = CONFORMANCE_MODES,
    n_samples: int = 64,
    seed: int = 0,
    stage: int | None = None,
    data: np.ndarray | None = None,
    device=None,
) -> list[Diagnostic]:
    """Differentially execute ``program`` through each backend vs the
    reference interpreter; bit-mismatches become C401 diagnostics.

    ``data`` overrides the synthetic input batch — for programs whose input
    lanes carry narrower-than-declared upstream values, the caller supplies
    realistic carries instead of the full-width random sweep. ``device`` is
    where the ``'torch'`` mode runs (the card when None).
    """
    from ..runtime import reference

    prog = _as_prog(program)
    if data is None:
        rng = np.random.default_rng(seed)
        data = random_inputs(rng, prog, n_samples)
    else:
        data = np.asarray(data, dtype=np.float64)
        n_samples = len(data)
    ref, ref_buf = reference.run_program(prog, data, return_buf=True)

    diags: list[Diagnostic] = []
    for mode in modes:
        try:
            got, got_buf = _run_mode(prog, mode, data, device)
        except Exception as e:  # a backend crash on a valid program is a divergence
            diags.append(
                Diagnostic(
                    'C401',
                    f"backend '{mode}' raised {type(e).__name__} on a program the reference executes: {e}",
                    stage=stage,
                )
            )
            continue
        if np.array_equal(np.asarray(got), ref):
            continue
        if got_buf is not None:
            op = _first_divergent_op(prog, ref_buf, got_buf)
            oc = int(prog.opcode[op]) if op >= 0 else None
            where = f'first divergent op {op}'
        else:
            bad_cols = np.flatnonzero(np.any(np.asarray(got) != ref, axis=0))
            j = int(bad_cols[0]) if len(bad_cols) else 0
            op = int(prog.out_idxs[j])
            oc = int(prog.opcode[op]) if op >= 0 else None
            where = f'first divergent output {j} (bound to op {op})'
        n_bad = int(np.count_nonzero(np.any(np.asarray(got) != ref, axis=1)))
        diags.append(
            Diagnostic(
                'C401',
                f"backend '{mode}' diverges bit-wise from the table reference on "
                f'{n_bad}/{n_samples} samples; {where}',
                op_index=op if op >= 0 else None,
                stage=stage,
                opcode=oc,
            )
        )
    return diags


def conformance_pass(comb, stage, skip_ops, **opts) -> list[Diagnostic]:
    """Registry adapter: skip programs with structural errors (backends
    would crash on them for the right reasons); ``opts`` are
    :func:`check_conformance`'s ``device``, ``modes``, ``n_samples`` and
    ``seed``."""
    if skip_ops:
        return []
    return check_conformance(comb, stage=stage, **opts)


def run_conformance_corpus(
    n_programs: int = 12,
    n_ops: int = 180,
    n_samples: int = 64,
    seed: int = 0,
    modes: tuple[str, ...] = CONFORMANCE_MODES,
    device=None,
) -> tuple[dict, list[Diagnostic]]:
    """Differential fuzz over the ``ir.synth`` corpus.

    Every 4th program is wide (int64 device path); per-opcode op counts are
    accumulated so a table row the generator never emits is flagged as a
    C402 coverage gap. Returns ``(report, diagnostics)`` where the report
    is JSON-ready.
    """
    per_opcode: dict[int, dict] = {
        oc: {'family': spec.family, 'ops': 0, 'mismatches': 0} for oc, spec in OPCODE_TO_SPEC.items()
    }
    diags: list[Diagnostic] = []

    for pi in range(n_programs):
        rng = np.random.default_rng(seed * 100_003 + pi)
        prog = random_program(rng, n_ops=n_ops, n_in=6, n_out=5, wide=(pi % 4 == 3))
        for oc in prog.opcode.tolist():
            per_opcode[int(oc)]['ops'] += 1
        found = check_conformance(prog, modes=modes, n_samples=n_samples, seed=seed * 7 + pi, device=device)
        for d in found:
            if d.opcode is not None:
                per_opcode[int(d.opcode)]['mismatches'] += 1
        diags.extend(found)

    for oc in sorted(DAIS_V1_OPCODES):
        if per_opcode[oc]['ops'] == 0:
            diags.append(
                Diagnostic(
                    'C402',
                    f'opcode {oc} ({family_of(oc)}) was never emitted by the {n_programs}-program fuzz corpus; '
                    f'grow ir/synth.py coverage or the corpus size',
                    opcode=oc,
                )
            )

    report = {
        'ok': not diags,
        'n_programs': n_programs,
        'n_ops_per_program': n_ops,
        'n_samples': n_samples,
        'modes': list(modes),
        'seed': seed,
        'per_opcode': {str(oc): info for oc, info in sorted(per_opcode.items())},
        'diagnostics': [d.to_dict() for d in diags],
    }
    return report, diags


__all__ = ['CONFORMANCE_MODES', 'check_conformance', 'conformance_pass', 'run_conformance_corpus']
