"""Observability layer: spans, metrics, and trace export.

Counterpart of ``da4ml_tpu/telemetry/``: the same public names, event
schema, metric names and exposition, so a trace or a ``/metrics`` scrape of
the port reads like one of the reference. ``obs.profile`` maps the
reference's XLA device profile onto ``torch.profiler`` and NVTX ranges.

Activation (disabled by default, near-zero overhead when off):

- ``DA4ML_TRACE=<path>`` in the environment — opens a trace sink at import
  (``.jsonl`` → streaming event log, else Chrome trace-event JSON for
  Perfetto / chrome://tracing) and enables the metrics registry;
- programmatically: ``telemetry.enable(path)`` / ``telemetry.disable()``;
- ``da4ml-tpu-torch convert --trace <path>`` on the CLI, and
  ``da4ml-tpu-torch stats <path>`` to summarize a captured trace;
- ``DA4ML_PROFILE=<dir>`` arms the device profile (``obs.profile``).

Instrumentation API (all safe to call when disabled)::

    from da4ml_tpu_torch import telemetry

    with telemetry.span('cmvm.solve', backend='torch') as sp:
        ...
        sp.set(cost=result.cost)

    telemetry.counter('sched.rungs').inc()
    telemetry.histogram('solve.duration_s').observe(dt)
    telemetry.gauge('fuse.depth_after').set(d)
    telemetry.instant('cmvm.progress', done=i, total=n)
    log = telemetry.get_logger('cmvm.torch')
"""

from .core import (
    Span,
    active_spans,
    add_sink,
    beat,
    beat_age_s,
    bind_trace,
    collect_phases,
    current_span,
    current_trace,
    current_trace_id,
    disable,
    emit_span,
    enable,
    format_traceparent,
    instant,
    new_span_id,
    new_trace_id,
    parse_traceparent,
    remove_sink,
    reset,
    span,
    tracing_active,
)
from .export import (
    REQUIRED_EVENT_KEYS,
    ChromeTraceSink,
    JsonlSink,
    load_trace,
    sink_for,
    validate_trace,
)
from .log import get_logger, warn_once
from .metrics import (
    BYTES_BUCKETS,
    COUNT_BUCKETS,
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    counter,
    gauge,
    histogram,
    metrics_on,
    metrics_snapshot,
    timer,
)

def serve(port: int | None = None, host: str = '127.0.0.1'):
    """Start the live observability endpoint (``/metrics`` OpenMetrics,
    ``/healthz``, ``/statusz``) on a daemon thread and return the server
    Idempotent; also reachable via ``DA4ML_METRICS_PORT=<port>`` or
    ``da4ml-tpu-torch monitor``. Enables the
    metrics registry so scrapes see data."""
    from .obs.server import serve as _serve

    return _serve(port=port, host=host)


__all__ = [
    'Span',
    'span',
    'instant',
    'emit_span',
    'collect_phases',
    'current_span',
    'active_spans',
    'bind_trace',
    'current_trace',
    'current_trace_id',
    'new_trace_id',
    'new_span_id',
    'format_traceparent',
    'parse_traceparent',
    'beat',
    'beat_age_s',
    'serve',
    'enable',
    'disable',
    'reset',
    'add_sink',
    'remove_sink',
    'tracing_active',
    'sink_for',
    'ChromeTraceSink',
    'JsonlSink',
    'load_trace',
    'validate_trace',
    'REQUIRED_EVENT_KEYS',
    'counter',
    'gauge',
    'histogram',
    'metrics_on',
    'metrics_snapshot',
    'timer',
    'Counter',
    'Gauge',
    'Histogram',
    'DEFAULT_BUCKETS',
    'COUNT_BUCKETS',
    'BYTES_BUCKETS',
    'get_logger',
    'warn_once',
]

from .core import _init_from_env

_init_from_env()
