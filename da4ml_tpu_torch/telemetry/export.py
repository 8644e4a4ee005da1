"""Trace exporters: Chrome trace-event JSON and a JSONL event log.

Both sinks receive the same event dicts from :mod:`.core` (Chrome
trace-event schema: ``name``, ``ph``, ``ts``/``dur`` in microseconds,
``pid``, ``tid``, ``args``).

- :class:`ChromeTraceSink` buffers events in memory and writes one
  ``{"traceEvents": [...], "otherData": {"metrics": ...}}`` JSON document
  at close — load it in Perfetto (https://ui.perfetto.dev) or
  chrome://tracing. The write is atomic (tmp + rename, same idiom as the
  reliability checkpoints).
- :class:`JsonlSink` streams one JSON object per line as events close, so
  a killed process still leaves a readable prefix; the metrics snapshot is
  appended as a final ``ph: "M"`` record at close.

Both sinks record a **clock anchor** at open — one ``(unix_time_us, ts)``
pair sampled back-to-back — that maps the process-local ``ts`` epoch
(``time.perf_counter`` at telemetry import) onto the shared wall clock.
The fleet trace merger (:mod:`.obs.collect`) uses it to align N replica
traces onto one timeline; JSONL traces carry it as a first
``ph: "M"``/``name: "clock_sync"`` record, Chrome traces under
``otherData.clock_sync``.

Both are fork-safe (events from a forked child are dropped — the child
inherited the parent's buffer/handle and must not corrupt its file) and
registered with ``atexit`` so an unclosed trace still flushes.

:func:`load_trace` / :func:`validate_trace` are the shared readers used by
the ``da4ml-tpu-torch stats`` renderer, the tests, and ``chip_smoke.py``.

Counterpart of ``da4ml_tpu/telemetry/export.py``: the same event schema,
key for key, so either package's reader takes the other's trace.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from pathlib import Path

#: keys every exported event must carry (the CI smoke step checks these)
REQUIRED_EVENT_KEYS = ('name', 'ph', 'ts', 'pid', 'tid')


def _json_default(obj):
    return str(obj)


def _clock_anchor() -> dict:
    """One ``(unix wall clock, process-local ts)`` pair sampled back-to-back:
    ``unix_time_us - ts`` is this process's offset onto the shared clock."""
    from .core import _now_us

    return {'unix_time_us': time.time() * 1e6, 'ts': round(_now_us(), 1)}


class ChromeTraceSink:
    def __init__(self, path: 'str | os.PathLike'):
        self.path = Path(path)
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._anchor = _clock_anchor()
        self._closed = False
        atexit.register(self.close)

    def emit(self, event: dict) -> None:
        if self._closed or os.getpid() != self._pid:
            return
        with self._lock:
            self._events.append(event)

    def close(self) -> None:
        if self._closed or os.getpid() != self._pid:
            return
        with self._lock:
            if self._closed:
                return
            self._closed = True
            events = self._events
        from .metrics import metrics_snapshot

        payload = {
            'traceEvents': events,
            'displayTimeUnit': 'ms',
            'otherData': {
                'producer': 'da4ml_tpu_torch.telemetry',
                'pid': self._pid,
                'unix_time': time.time(),
                'clock_sync': self._anchor,
                'metrics': metrics_snapshot(),
            },
        }
        tmp = self.path.with_name(self.path.name + f'.tmp.{self._pid}')
        tmp.parent.mkdir(parents=True, exist_ok=True)
        with open(tmp, 'w') as fh:
            json.dump(payload, fh, default=_json_default)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)


class JsonlSink:
    def __init__(self, path: 'str | os.PathLike'):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, 'w')
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._closed = False
        anchor = _clock_anchor()
        self._fh.write(
            json.dumps(
                {
                    'name': 'clock_sync',
                    'ph': 'M',
                    'ts': anchor['ts'],
                    'pid': self._pid,
                    'tid': 0,
                    'args': {'unix_time_us': anchor['unix_time_us']},
                }
            )
            + '\n'
        )
        self._fh.flush()
        atexit.register(self.close)

    def emit(self, event: dict) -> None:
        if self._closed or os.getpid() != self._pid:
            return
        line = json.dumps(event, default=_json_default)
        with self._lock:
            if not self._closed:
                self._fh.write(line + '\n')

    def close(self) -> None:
        if self._closed or os.getpid() != self._pid:
            return
        from .core import _PID, _now_us
        from .metrics import metrics_snapshot

        with self._lock:
            if self._closed:
                return
            self._closed = True
            snap = metrics_snapshot()
            if snap:
                self._fh.write(
                    json.dumps(
                        {
                            'name': 'metrics',
                            'ph': 'M',
                            'ts': round(_now_us(), 1),
                            'pid': _PID,
                            'tid': 0,
                            'args': {'metrics': snap},
                        },
                        default=_json_default,
                    )
                    + '\n'
                )
            self._fh.close()


def sink_for(path: 'str | os.PathLike'):
    """Pick the exporter from the file extension: ``.jsonl`` streams an
    event log, anything else buffers Chrome trace-event JSON."""
    if str(path).endswith('.jsonl'):
        return JsonlSink(path)
    return ChromeTraceSink(path)


# ---------------------------------------------------------------------------
# readers (stats CLI, tests, CI validation)
# ---------------------------------------------------------------------------


def load_trace(path: 'str | os.PathLike') -> tuple[list[dict], dict]:
    """Read a trace file in either format. Returns ``(events, metrics)``."""
    text = Path(path).read_text()
    if not text.strip():
        return [], {}
    if text.lstrip()[0] == '{' and '\n{' not in text.strip():
        doc = json.loads(text)
        if isinstance(doc, dict) and 'traceEvents' in doc:
            return doc['traceEvents'], doc.get('otherData', {}).get('metrics', {})
        if isinstance(doc, list):
            return doc, {}
    events: list[dict] = []
    metrics_by_pid: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        ev = json.loads(line)
        if ev.get('ph') == 'M' and ev.get('name') == 'metrics':
            # latest mirror per producing process: a merged multi-process
            # trace must aggregate across pids, never double-count one
            # process's repeated snapshots
            metrics_by_pid[ev.get('pid', 0)] = ev.get('args', {}).get('metrics', {})
        else:
            events.append(ev)
    if len(metrics_by_pid) > 1:
        from .obs.collect import merge_metrics

        return events, merge_metrics(metrics_by_pid)
    return events, next(iter(metrics_by_pid.values()), {})


def validate_trace(events: list[dict]) -> None:
    """Raise ``ValueError`` unless every event carries the Chrome trace-event
    required keys with sane types (``dur`` additionally for ``X`` events)."""
    if not events:
        raise ValueError('trace contains no events')
    for i, ev in enumerate(events):
        for key in REQUIRED_EVENT_KEYS:
            if key not in ev:
                raise ValueError(f'event {i} missing required key {key!r}: {ev}')
        if not isinstance(ev['name'], str) or not ev['name']:
            raise ValueError(f'event {i} has a non-string name: {ev}')
        if ev['ph'] not in ('X', 'B', 'E', 'i', 'C', 'M'):
            raise ValueError(f'event {i} has unknown phase {ev["ph"]!r}')
        for key in ('ts', 'pid', 'tid'):
            if not isinstance(ev[key], (int, float)):
                raise ValueError(f'event {i} key {key!r} is not numeric: {ev}')
        if ev['ph'] == 'X' and not isinstance(ev.get('dur'), (int, float)):
            raise ValueError(f'complete event {i} lacks a numeric dur: {ev}')
