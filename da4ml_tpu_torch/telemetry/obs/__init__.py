"""Live observability plane.

Spans and metrics land in a trace file read after the process exits; this
package adds *live* introspection of a running process and the device
profile:

- **Exposition** — :mod:`.openmetrics` renders the metrics registry in
  OpenMetrics/Prometheus text format; :mod:`.server` serves it over a
  stdlib ``http.server`` endpoint (``/metrics``, ``/healthz``,
  ``/statusz``) started via ``telemetry.serve(port)``,
  ``DA4ML_METRICS_PORT``, or ``da4ml-tpu-torch monitor``. Off by default
  and fork-safe like the rest of telemetry.
- **Device-profile correlation** — :mod:`.profile` arms ``torch.profiler``
  around the CMVM device rungs and runtime batch calls when
  ``DA4ML_PROFILE=<dir>`` is set, tagging the regions that launch the CUDA
  kernels with the owning telemetry span id.
- **Trace tools** — :mod:`.collect` merges per-process traces onto one
  timeline, :mod:`.tailer` follows a growing JSONL trace.

Everything here imports lazily from ``da4ml_tpu_torch.telemetry`` —
importing the telemetry package never pulls in the HTTP server or torch.

Counterpart of ``da4ml_tpu/telemetry/obs/``, without ``bench_diff`` (the
port has no benchmark yet).
"""

from .collect import merge_metrics, merge_traces, trace_index, write_merged
from .health import health_snapshot, status_snapshot
from .openmetrics import render_openmetrics, validate_openmetrics
from .server import serve, server_port, stop_server
from .tailer import TraceTailer

__all__ = [
    'render_openmetrics',
    'validate_openmetrics',
    'merge_traces',
    'merge_metrics',
    'trace_index',
    'write_merged',
    'health_snapshot',
    'status_snapshot',
    'serve',
    'server_port',
    'stop_server',
    'TraceTailer',
]
