"""``da4ml-tpu-torch verify`` — static analysis of saved DAIS programs.

Runs the verifier passes (docs/analysis.md) over one or more saved programs:
a ``CombLogic``/``Pipeline`` ``.json`` file, or a generated project directory
(the embedded ``model/comb.json`` / ``model/pipeline.json`` is used). Exits
non-zero when any program has errors (or warnings, with ``--strict``), so it
slots directly into CI::

    da4ml-tpu-torch verify examples/kernels/*.json
    da4ml-tpu-torch verify build/my_project --json
    da4ml-tpu-torch verify prog.json --conformance     # + differential backends
    da4ml-tpu-torch verify --fuzz 12 --out report.json # corpus conformance +
                                                       # transfer-soundness sweep

``--conformance`` adds the opt-in cross-backend conformance pass per
program; ``--fuzz N`` needs no paths — it sweeps N randomized ``ir.synth``
programs through every runtime mode against the table-generated reference
interpreter and fuzz-proves the per-opcode interval transfers. Both run the
``'torch'`` mode (the DAIS executor) on ``--device``: the CUDA kernel on the
card by default, its plain torch version with ``--device cpu``.

Counterpart of ``da4ml_tpu/_cli/verify.py``; its ``--concurrency`` plane
(lock/thread lint, catalog drift gates, locktrace) is not ported yet and
exits 2.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from . import UsageError, add_device_arg, cli_device


def add_verify_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('paths', nargs='*', type=Path, help='saved program .json files or project directories')
    parser.add_argument('--json', action='store_true', dest='as_json', help='emit machine-readable JSON diagnostics')
    parser.add_argument('--strict', action='store_true', help='exit non-zero on warnings as well as errors')
    parser.add_argument('--no-warnings', action='store_true', help='hide warnings from the text output')
    parser.add_argument(
        '--passes',
        default=None,
        help='comma-separated pass subset to run (default: all non-opt-in); '
        'available: wellformed,qinterval,deadcode,conformance',
    )
    parser.add_argument(
        '--conformance',
        action='store_true',
        help='also run the cross-backend conformance pass per program (differential execution '
        'of numpy/cpp/torch vs the table-generated reference interpreter)',
    )
    parser.add_argument(
        '--fuzz',
        type=int,
        default=0,
        metavar='N',
        help='no paths needed: run the N-program ir.synth differential conformance corpus plus '
        'the per-opcode transfer-soundness fuzz, and exit non-zero on any finding',
    )
    parser.add_argument(
        '--concurrency',
        action='store_true',
        help='the concurrency soundness plane; not ported yet (ROADMAP Queue 1, items 7 and 10): exits 2',
    )
    parser.add_argument('--seed', type=int, default=0, help='base seed for --fuzz / --conformance inputs')
    parser.add_argument(
        '--samples', type=int, default=64, help='input samples per program for conformance runs (--fuzz and --conformance)'
    )
    parser.add_argument(
        '--modes', default=None, help='comma-separated backend modes for conformance (default: numpy,cpp,torch)'
    )
    add_device_arg(parser)
    parser.add_argument(
        '--out', type=Path, default=None, help="write the JSON report (--fuzz, or the paths' diagnostics) to this path"
    )


def _resolve_program_file(path: Path) -> Path:
    if path.is_dir():
        for candidate in (path / 'model' / 'pipeline.json', path / 'model' / 'comb.json'):
            if candidate.is_file():
                return candidate
        raise FileNotFoundError(f'{path} contains no model/pipeline.json or model/comb.json')
    return path


def _load_program(path: Path):
    """Load without the on-load verification — the point is to report
    structured diagnostics, not to crash in ``from_dict``."""
    from ..ir import CombLogic, Pipeline

    blob = json.loads(path.read_text())
    if isinstance(blob, dict) and 'stages' in blob:
        return Pipeline.from_dict(blob, verify=False)
    return CombLogic.from_dict(blob, verify=False)


def _schedule_stats(program) -> list[dict]:
    """ASAP level-schedule stats per stage (ir.schedule): depth is the
    dependency critical path in ops; mean level width is how many ops are
    executable together — the parallelism the level-packed runtime exploits."""
    from ..ir.schedule import levelize_comb

    stages = program.stages if hasattr(program, 'stages') else [program]
    per = []
    for st in stages:
        s = levelize_comb(st)
        per.append(
            {
                'n_ops': len(st.ops),
                'depth': s.depth,
                'width_max': s.width_max,
                'width_mean': round(s.width_mean, 1),
                'peak_live': s.peak_live,
            }
        )
    return per


def _fused_stats(program) -> dict | None:
    """Level-schedule stats of the IR-fused whole-model program
    (docs/runtime.md#ir-fusion), for multi-stage Pipelines: what the
    ``run_pipeline(fused='ir')`` runtime actually executes."""
    if len(getattr(program, 'stages', ())) < 2:
        return None
    from ..ir.fuse import fuse_pipeline
    from ..ir.schedule import levelize_comb

    fused, rep = fuse_pipeline(program, report=True)
    s = levelize_comb(fused)
    return {
        'n_ops': len(fused.ops),
        'seam_ops': rep.seam_ops,
        'depth': s.depth,
        'depth_chained': rep.depth_before,
        'width_max': s.width_max,
        'width_mean': round(s.width_mean, 1),
        'peak_live': s.peak_live,
    }


def _fuzz_main(args: argparse.Namespace) -> int:
    """Corpus mode: differential conformance + transfer-soundness fuzz."""
    from ..analysis.conformance import CONFORMANCE_MODES, run_conformance_corpus
    from ..analysis.soundness import check_transfer_soundness

    modes = tuple(m.strip() for m in args.modes.split(',') if m.strip()) if args.modes else CONFORMANCE_MODES
    conf_report, conf_diags = run_conformance_corpus(
        n_programs=args.fuzz, n_samples=args.samples, seed=args.seed, modes=modes, device=cli_device(args.device)
    )
    sound_report, sound_diags = check_transfer_soundness(seed=args.seed)
    report = {
        'ok': conf_report['ok'] and sound_report['ok'],
        'conformance': conf_report,
        'transfer_soundness': sound_report,
    }
    if args.out:
        args.out.write_text(json.dumps(report, indent=2))
    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        print(f'conformance: {args.fuzz} programs x {len(modes)} modes ({",".join(modes)}), {args.samples} samples each')
        for oc, info in conf_report['per_opcode'].items():
            print(f'  opcode {oc:>3} [{info["family"]}]: {info["ops"]} ops, {info["mismatches"]} mismatches')
        for d in conf_diags:
            print(f'  {d}')
        print('transfer-soundness:')
        for key, info in sound_report['per_family'].items():
            print(
                f'  {key} {tuple(info["opcodes"])}: {info["cases"]} cases x {info["samples_per_case"]} samples, '
                f'{info["counterexamples"]} counterexamples'
            )
        for d in sound_diags:
            print(f'  {d}')
        print('opcode conformance: ' + ('ok' if report['ok'] else 'FAILED'))
    return 0 if report['ok'] else 1


def verify_main(args: argparse.Namespace) -> int:
    from ..analysis import verify

    if args.concurrency:
        raise UsageError(
            '--concurrency needs the lint catalogs, the concurrency lint and the lock tracer, which are not ported '
            'yet (ROADMAP Queue 1, items 7 and 10)'
        )
    if args.fuzz:
        return _fuzz_main(args)
    if not args.paths:
        print('verify: provide program paths, or --fuzz N for the corpus sweep')
        return 2

    passes = None
    if args.passes:
        passes = tuple(p.strip() for p in args.passes.split(',') if p.strip())
    if args.conformance:
        from ..analysis import OPT_IN_PASSES, PASSES

        base = passes if passes is not None else tuple(p for p in PASSES if p not in OPT_IN_PASSES)
        passes = tuple(dict.fromkeys(base + ('conformance',)))
    conformance = {}
    if passes is not None and 'conformance' in passes:
        conformance = {'device': cli_device(args.device), 'n_samples': args.samples, 'seed': args.seed}
        if args.modes:
            conformance['modes'] = tuple(m.strip() for m in args.modes.split(',') if m.strip())

    results = []
    rc = 0
    for raw_path in args.paths:
        try:
            path = _resolve_program_file(raw_path)
            program = _load_program(path)
        except Exception as e:  # unreadable/corrupt beyond parsing
            results.append({'target': str(raw_path), 'ok': False, 'load_error': f'{type(e).__name__}: {e}'})
            rc = max(rc, 2)
            if not args.as_json:
                print(f'{raw_path}: LOAD FAILED ({type(e).__name__}: {e})')
            continue

        result = verify(program, passes=passes, target=str(raw_path), **conformance)
        entry = result.to_dict()
        try:
            entry['schedule'] = _schedule_stats(program)
        except Exception:  # stats are informational; never fail the verify
            pass
        try:
            fused_stats = _fused_stats(program)
            if fused_stats is not None:
                entry['schedule_fused'] = fused_stats
        except Exception:
            fused_stats = None
        if fused_stats is not None:
            # the fused whole-model program must pass the same verifier
            # passes as the staged one (incl. --conformance when requested)
            fres = verify(program.fuse(), passes=passes, target=f'{raw_path}#fused', **conformance)
            entry['fused'] = fres.to_dict()
            if not fres.ok or (args.strict and fres.warnings):
                rc = max(rc, 1)
        results.append(entry)
        if not result.ok or (args.strict and result.warnings):
            rc = max(rc, 1)
        if not args.as_json:
            print(result.format_text(show_warnings=not args.no_warnings))
            for i, s in enumerate(entry.get('schedule', [])):
                print(
                    f'  stage {i}: {s["n_ops"]} ops, schedule depth {s["depth"]}, '
                    f'mean level width {s["width_mean"]}, peak live window {s["peak_live"]}'
                )
            if fused_stats is not None:
                f = fused_stats
                fd = entry['fused']
                suffix = '' if fd['ok'] else ' [VERIFY FAILED]'
                if fd['ok'] and fd['n_warnings']:
                    suffix = f' [{fd["n_warnings"]} warning(s)]'
                print(
                    f'  fused: {f["n_ops"]} ops ({f["seam_ops"]} seam), schedule depth {f["depth"]} '
                    f'(chained {f["depth_chained"]}), mean level width {f["width_mean"]}' + suffix
                )

    payload = results if len(results) > 1 else results[0]
    if args.out:
        args.out.write_text(json.dumps(payload, indent=2))
    if args.as_json:
        print(json.dumps(payload, indent=2))
    return rc
