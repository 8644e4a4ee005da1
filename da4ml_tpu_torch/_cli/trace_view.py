"""``da4ml-tpu-torch trace-view`` — merge per-process traces into one timeline.

Feeds N trace files (one per process; a directory stands for its
``*.jsonl`` files) through the collector (:mod:`..telemetry.obs.collect`):
per-process clock-offset alignment from each sink's clock anchor, one
Chrome/Perfetto document with ``process_name`` metadata per source process,
and a per-trace-id index so a request that crossed processes reads as one
waterfall::

    da4ml-tpu-torch trace-view traces/ --out merged.json
    da4ml-tpu-torch trace-view a.jsonl b.jsonl --min-processes 2

``--min-processes N`` turns the view into a gate: exit 1 unless at least
one trace id carries spans from >= N distinct processes.

Counterpart of ``da4ml_tpu/_cli/trace_view.py``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def add_trace_view_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('traces', nargs='+', type=Path, help='JSONL trace files, or directories of *.jsonl')
    parser.add_argument('--out', type=Path, default=Path('merged.json'), help='Merged Perfetto timeline path')
    parser.add_argument('--no-align', action='store_true', help='Skip per-process clock-offset alignment')
    parser.add_argument(
        '--min-processes',
        type=int,
        default=0,
        help='Exit 1 unless some trace id spans >= N distinct processes (0 = no gate)',
    )
    parser.add_argument('--json', action='store_true', dest='as_json', help='Print the full merge summary as JSON')


def trace_view_main(args: argparse.Namespace) -> int:
    from ..telemetry import get_logger
    from ..telemetry.obs.collect import merge_traces, write_merged

    log = get_logger('cli.trace_view')
    paths: list[Path] = []
    for p in args.traces:
        if p.is_dir():
            paths.extend(sorted(p.glob('*.jsonl')))
        elif p.exists():
            paths.append(p)
        else:
            log.warning(f'no such trace: {p}')
            return 2
    if not paths:
        log.warning('no .jsonl trace files found')
        return 2
    report = merge_traces(paths, align=not args.no_align)
    write_merged(report, args.out)
    summary = {
        'out': str(args.out),
        'n_files': len(paths),
        'n_events': report['n_events'],
        'n_traces': len(report['traces']),
        'n_traces_multiprocess': sum(1 for t in report['traces'].values() if len(t['pids']) >= 2),
        'max_processes_per_trace': report['max_processes_per_trace'],
    }
    if args.as_json:
        summary['sources'] = report['sources']
        summary['traces'] = report['traces']
    log.info(json.dumps(summary, indent=1, default=str))
    if args.min_processes and report['max_processes_per_trace'] < args.min_processes:
        log.warning(f'gate failed: no trace spans >= {args.min_processes} distinct processes')
        return 1
    return 0
