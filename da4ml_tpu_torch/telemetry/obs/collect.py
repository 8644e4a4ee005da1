"""Fleet trace merge: N per-process trace files -> one Perfetto timeline.

Each replica (and the router process) writes its own trace with
process-local timestamps — ``ts`` is microseconds since *that process's*
telemetry import. This module merges them into a single Chrome
trace-event document whose events share one time axis:

1. **Clock alignment.** Every sink records a clock anchor at open — one
   ``(unix_time_us, ts)`` pair (:mod:`..export`). ``unix_time_us - ts`` is
   the process's offset onto the shared wall clock; the merger re-bases
   every event onto the earliest process's epoch. A file without an anchor
   (a pre-anchor trace) merges unshifted and is flagged ``aligned: False``.
2. **Trace grouping.** Spans carry ``args.trace_id`` when they ran under a
   bound trace context (:func:`...core.bind_trace`); :func:`trace_index`
   groups the merged events by trace id so callers can answer "which
   processes did request X touch".
3. **Metric aggregation.** Per-file metrics snapshots are aggregated with
   :func:`merge_metrics` — last snapshot *per pid*, then summed across
   pids — the same rule ``da4ml-tpu-torch stats`` and the ``TraceTailer`` apply,
   so a replica that mirrored its counters twice is never double-counted.

Surfaced as ``da4ml-tpu-torch trace-view``. Counterpart of
``da4ml_tpu/telemetry/obs/collect.py``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from ..export import load_trace


def _anchor_offset_us(path: 'str | os.PathLike', events: list[dict]) -> float | None:
    """The file's wall-clock offset (``unix_time_us - ts``), or None."""
    for ev in events:
        if ev.get('ph') == 'M' and ev.get('name') == 'clock_sync':
            args = ev.get('args', {})
            if 'unix_time_us' in args:
                return float(args['unix_time_us']) - float(ev.get('ts', 0.0))
    # Chrome-format traces carry the anchor in otherData instead
    try:
        doc = json.loads(Path(path).read_text())
        cs = doc.get('otherData', {}).get('clock_sync') if isinstance(doc, dict) else None
        if cs and 'unix_time_us' in cs:
            return float(cs['unix_time_us']) - float(cs.get('ts', 0.0))
    except Exception:
        pass
    return None


def merge_metrics(snapshots_by_pid: dict) -> dict:
    """Aggregate one metrics snapshot per process into a fleet view.

    Keys identify the producing process (pid or source label — only their
    uniqueness matters). Counters and histograms are additive across
    processes; gauges sum too (fleet queue depth is the sum of replica
    depths — state-valued gauges like ``breaker.state.*`` read as "count of
    replicas in a non-closed state"). The caller is responsible for keeping
    only the *latest* snapshot per process — repeated mirrors from one
    process must replace, not accumulate.
    """
    out: dict[str, dict] = {}
    for _pid, snap in sorted(snapshots_by_pid.items(), key=lambda kv: str(kv[0])):
        for name, m in snap.items():
            if not isinstance(m, dict) or 'type' not in m:
                continue
            cur = out.get(name)
            if cur is None:
                out[name] = json.loads(json.dumps(m))  # deep copy, JSON-shaped
                continue
            if cur.get('type') != m.get('type'):
                continue  # conflicting kinds across processes: keep the first
            kind = m['type']
            if kind in ('counter', 'gauge'):
                cur['value'] = cur.get('value', 0.0) + m.get('value', 0.0)
            elif kind == 'histogram':
                if cur.get('bounds') != m.get('bounds'):
                    continue  # incompatible ladders: keep the first
                cur['count'] = cur.get('count', 0) + m.get('count', 0)
                cur['sum'] = round(cur.get('sum', 0.0) + m.get('sum', 0.0), 6)
                cur['buckets'] = [a + b for a, b in zip(cur.get('buckets', []), m.get('buckets', []))]
                for k, pick in (('min', min), ('max', max)):
                    if k in m:
                        cur[k] = pick(cur[k], m[k]) if k in cur else m[k]
                if cur.get('count'):
                    cur['mean'] = round(cur['sum'] / cur['count'], 6)
                if 'exemplars' in m:
                    ex = cur.setdefault('exemplars', {})
                    for bi, triple in m['exemplars'].items():
                        # newest exemplar per bucket wins across processes
                        if bi not in ex or triple[2] >= ex[bi][2]:
                            ex[bi] = triple
    return out


def merge_traces(paths: 'list[str | os.PathLike]', *, align: bool = True) -> dict:
    """Merge trace files onto one timeline; returns a report dict.

    Keys: ``doc`` (the merged Chrome trace-event document — write it out
    and load in Perfetto), ``sources`` (per-file pids/offsets/aligned
    flags), ``traces`` (per-trace-id index from :func:`trace_index`),
    ``max_processes_per_trace``, ``n_events``, and ``metrics`` (the
    :func:`merge_metrics` aggregate).
    """
    sources: list[dict] = []
    per_file: list[tuple[str, list[dict], float | None]] = []
    snapshots_by_source: dict[str, dict] = {}
    for path in paths:
        events, metrics = load_trace(path)
        offset = _anchor_offset_us(path, events) if align else None
        label = Path(path).stem
        pids = sorted({ev.get('pid') for ev in events if 'pid' in ev})
        per_file.append((label, events, offset))
        if metrics:
            snapshots_by_source[str(path)] = metrics
        sources.append(
            {
                'path': str(path),
                'label': label,
                'pids': pids,
                'n_events': len(events),
                'offset_us': offset,
                'aligned': offset is not None,
            }
        )

    offsets = [off for _, _, off in per_file if off is not None]
    base = min(offsets) if offsets else 0.0
    merged: list[dict] = []
    seen_pids: dict[int, str] = {}
    for label, events, offset in per_file:
        shift = (offset - base) if offset is not None else 0.0
        for ev in events:
            if ev.get('ph') == 'M' and ev.get('name') == 'clock_sync':
                continue  # consumed by the alignment above
            ev = dict(ev)
            ev['ts'] = round(float(ev.get('ts', 0.0)) + shift, 1)
            merged.append(ev)
            pid = ev.get('pid')
            if isinstance(pid, int) and pid not in seen_pids:
                seen_pids[pid] = label
    merged.sort(key=lambda ev: ev.get('ts', 0.0))
    for pid, label in sorted(seen_pids.items()):
        merged.append(
            {'name': 'process_name', 'ph': 'M', 'ts': 0.0, 'pid': pid, 'tid': 0, 'args': {'name': f'{label} (pid {pid})'}}
        )

    traces = trace_index(merged)
    max_procs = max((len(t['pids']) for t in traces.values()), default=0)
    metrics = merge_metrics(snapshots_by_source)
    doc = {
        'traceEvents': merged,
        'displayTimeUnit': 'ms',
        'otherData': {
            'producer': 'da4ml_tpu_torch.telemetry.obs.collect',
            'sources': [{k: v for k, v in s.items() if k != 'pids'} for s in sources],
            'metrics': metrics,
        },
    }
    return {
        'doc': doc,
        'sources': sources,
        'traces': traces,
        'n_events': len(merged),
        'max_processes_per_trace': max_procs,
        'metrics': metrics,
    }


def trace_index(events: list[dict]) -> dict:
    """Group events by ``args.trace_id``: ``{trace_id: {n_spans, pids,
    names, t_min_us, t_max_us}}`` (span names capped at 32 per trace)."""
    traces: dict[str, dict] = {}
    for ev in events:
        trace_id = ev.get('args', {}).get('trace_id')
        if not trace_id:
            continue
        t = traces.setdefault(
            trace_id, {'n_spans': 0, 'pids': set(), 'names': set(), 't_min_us': float('inf'), 't_max_us': float('-inf')}
        )
        t['n_spans'] += 1
        if 'pid' in ev:
            t['pids'].add(ev['pid'])
        if len(t['names']) < 32:
            t['names'].add(ev.get('name', ''))
        ts = float(ev.get('ts', 0.0))
        t['t_min_us'] = min(t['t_min_us'], ts)
        t['t_max_us'] = max(t['t_max_us'], ts + float(ev.get('dur', 0.0)))
    for t in traces.values():
        t['pids'] = sorted(t['pids'])
        t['names'] = sorted(t['names'])
        t['span_ms'] = round((t['t_max_us'] - t['t_min_us']) / 1e3, 3) if t['n_spans'] else 0.0
    return traces


def write_merged(report: dict, out_path: 'str | os.PathLike') -> None:
    """Write the merged Chrome document atomically (tmp + rename)."""
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f'.tmp.{os.getpid()}')
    with open(tmp, 'w') as fh:
        json.dump(report['doc'], fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, out)
