"""Incremental reader for a growing JSONL telemetry trace.

``DA4ML_TRACE=<x>.jsonl`` streams one event per line as spans close, so a
long run can be watched from outside the process without the HTTP
endpoint: ``da4ml-tpu-torch stats --follow trace.jsonl`` re-renders the
summary as the file grows, and ``da4ml-tpu-torch monitor --follow
trace.jsonl`` serves the mirrored metrics over ``/metrics``.

:class:`TraceTailer` keeps a byte offset and a partial-line buffer, so
each :meth:`poll` parses only the newly appended complete lines; a
truncated/rotated file (size shrank) resets the reader.

Merged multi-process traces (``da4ml-tpu-torch trace-view`` output, or a file
several replicas append metrics mirrors into) are handled without
double-counting: metrics records are kept *per pid* — a process's newer
mirror replaces its older one — and :attr:`metrics` aggregates across the
distinct pids (:func:`..obs.collect.merge_metrics`).

Counterpart of ``da4ml_tpu/telemetry/obs/tailer.py``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path


class TraceTailer:
    def __init__(self, path: 'str | os.PathLike'):
        self.path = Path(path)
        self.events: list[dict] = []
        self.metrics_by_pid: dict[int, dict] = {}
        self.n_bad_lines = 0
        self._pos = 0
        self._buf = ''
        self._last_new = time.monotonic()

    def poll(self) -> int:
        """Read any newly appended complete lines; returns the number of new
        events absorbed (metrics records update :attr:`metrics` instead)."""
        try:
            size = self.path.stat().st_size
        except OSError:
            return 0
        if size < self._pos:  # truncated or rotated: start over
            self._pos = 0
            self._buf = ''
            self.events.clear()
            self.metrics_by_pid.clear()
        if size == self._pos:
            return 0
        with open(self.path) as fh:
            fh.seek(self._pos)
            chunk = fh.read()
            self._pos = fh.tell()
        self._buf += chunk
        lines = self._buf.split('\n')
        self._buf = lines.pop()  # trailing partial line (or '')
        n_new = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                self.n_bad_lines += 1
                continue
            if ev.get('ph') == 'M' and ev.get('name') == 'metrics':
                # latest mirror per producing process — merged multi-pid
                # traces must replace per pid, never accumulate blindly
                self.metrics_by_pid[ev.get('pid', 0)] = ev.get('args', {}).get('metrics', {})
            else:
                self.events.append(ev)
                n_new += 1
        if n_new:
            self._last_new = time.monotonic()
        return n_new

    @property
    def metrics(self) -> dict:
        """The latest metrics, aggregated across producing processes (one
        process: its snapshot verbatim; several: counters/histograms summed
        per distinct pid, each pid contributing only its newest mirror)."""
        if not self.metrics_by_pid:
            return {}
        if len(self.metrics_by_pid) == 1:
            return next(iter(self.metrics_by_pid.values()))
        from .collect import merge_metrics

        return merge_metrics(self.metrics_by_pid)

    @property
    def staleness_s(self) -> float:
        """Seconds since the last new event was absorbed."""
        return time.monotonic() - self._last_new
