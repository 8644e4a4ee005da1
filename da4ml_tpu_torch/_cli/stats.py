"""``da4ml-tpu-torch stats`` — summarize a captured telemetry trace.

Reads a trace produced by ``DA4ML_TRACE=<path>`` / ``--trace <path>``
(either format: Chrome trace-event JSON or JSONL event log) and renders:

- a per-span-name aggregate table (count, total/mean/max wall clock) sorted
  by total time — where the conversion actually went;
- the metrics snapshot embedded in the trace (counters, gauges, histogram
  summaries).

``--json`` emits the same summary as one machine-readable JSON document.

Counterpart of ``da4ml_tpu/_cli/stats.py``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def summarize_events(events: list[dict]) -> dict:
    """Aggregate Chrome trace events: span stats by name + instant counts."""
    spans: dict[str, dict] = {}
    instants: dict[str, int] = {}
    for ev in events:
        ph = ev.get('ph')
        name = ev.get('name', '?')
        if ph == 'X':
            dur_s = float(ev.get('dur', 0.0)) / 1e6
            s = spans.setdefault(name, {'count': 0, 'total_s': 0.0, 'max_s': 0.0})
            s['count'] += 1
            s['total_s'] += dur_s
            if dur_s > s['max_s']:
                s['max_s'] = dur_s
        elif ph == 'i':
            instants[name] = instants.get(name, 0) + 1
    for s in spans.values():
        s['mean_s'] = s['total_s'] / s['count']
    return {'spans': spans, 'instants': instants}


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f'{v:.2f}s'
    if v >= 1e-3:
        return f'{v * 1e3:.1f}ms'
    return f'{v * 1e6:.0f}µs'


def render_summary(summary: dict, metrics: dict, top: int = 0) -> str:
    lines: list[str] = []
    spans = sorted(summary['spans'].items(), key=lambda kv: -kv[1]['total_s'])
    if top:
        spans = spans[:top]
    if spans:
        name_w = max(len('span'), *(len(n) for n, _ in spans))
        lines.append(f'{"span":<{name_w}}  {"count":>6}  {"total":>9}  {"mean":>9}  {"max":>9}')
        lines.append('-' * (name_w + 40))
        for name, s in spans:
            lines.append(
                f'{name:<{name_w}}  {s["count"]:>6}  {_fmt_s(s["total_s"]):>9}  '
                f'{_fmt_s(s["mean_s"]):>9}  {_fmt_s(s["max_s"]):>9}'
            )
    else:
        lines.append('(no spans recorded)')
    if summary['instants']:
        lines.append('')
        lines.append('instant events:')
        for name, n in sorted(summary['instants'].items()):
            lines.append(f'  {name}: {n}')
    if metrics:
        lines.append('')
        lines.append('metrics:')
        for name, m in sorted(metrics.items()):
            kind = m.get('type')
            if kind == 'histogram':
                # the `_s` suffix convention marks seconds-valued histograms
                fmt = _fmt_s if name.endswith('_s') else (lambda v: f'{v:g}')
                if m.get('count'):
                    lines.append(
                        f'  {name}: n={m["count"]} mean={fmt(m["mean"])} min={fmt(m["min"])} max={fmt(m["max"])}'
                    )
                else:
                    lines.append(f'  {name}: n=0')
            else:
                lines.append(f'  {name}: {m.get("value"):g}')
    return '\n'.join(lines)


def _follow(args: argparse.Namespace) -> int:
    """Tail a streaming JSONL trace: incrementally absorb new events and
    re-render the summary every ``--interval`` seconds, so a long run
    can be watched live without the HTTP endpoint. Stops after
    ``--max-updates`` renders (0 = until Ctrl-C / EOF of a finished trace)."""
    from ..telemetry import get_logger
    from ..telemetry.obs.tailer import TraceTailer

    path = Path(args.trace)
    if path.suffix != '.jsonl':
        get_logger('cli.stats').warning(f'--follow expects a streaming .jsonl trace, got {path}')
        return 1
    tailer = TraceTailer(path)
    updates = 0
    try:
        while True:
            n_new = tailer.poll()
            if n_new or updates == 0:
                updates += 1
                summary = summarize_events(tailer.events)
                print(f'--- update {updates}: {path} +{n_new} events ({len(tailer.events)} total) ---')
                print(render_summary(summary, tailer.metrics, top=args.top))
            if args.max_updates and updates >= args.max_updates:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def stats_main(args: argparse.Namespace) -> int:
    from ..telemetry import load_trace, validate_trace

    if args.follow:
        return _follow(args)
    path = Path(args.trace)
    if not path.is_file():
        from ..telemetry import get_logger

        get_logger('cli.stats').warning(f'no such trace file: {path}')
        return 1
    events, metrics = load_trace(path)
    if args.validate:
        validate_trace(events)
    summary = summarize_events(events)
    if args.json:
        print(json.dumps({'file': str(path), 'n_events': len(events), **summary, 'metrics': metrics}, indent=2))
    else:
        print(f'{path}: {len(events)} events')
        print(render_summary(summary, metrics, top=args.top))
    return 0


def add_stats_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('trace', type=Path, help='Trace file captured with --trace / DA4ML_TRACE (.json or .jsonl)')
    parser.add_argument('--json', action='store_true', help='Emit the summary as JSON instead of a table')
    parser.add_argument('--top', type=int, default=0, help='Show only the N span names with the largest total time')
    parser.add_argument(
        '--validate', action='store_true', help='Additionally check every event against the Chrome trace-event schema'
    )
    parser.add_argument(
        '--follow', action='store_true', help='Tail a growing .jsonl trace, re-rendering the summary as events stream in'
    )
    parser.add_argument('--interval', type=float, default=2.0, help='--follow: poll interval in seconds')
    parser.add_argument('--max-updates', type=int, default=0, help='--follow: stop after N renders (0 = until Ctrl-C)')
