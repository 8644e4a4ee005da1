"""``da4ml-tpu-torch monitor`` — serve the live observability endpoints.

Two shapes:

- ``da4ml-tpu-torch monitor --port 9100`` — serve *this* process's
  registry. Mostly useful programmatically (``telemetry.serve``) or via
  ``DA4ML_METRICS_PORT`` inside a solve process; standalone it shows an
  empty registry.
- ``da4ml-tpu-torch monitor --follow trace.jsonl --port 9100`` — tail a
  *running* process's streaming JSONL trace and serve its mirrored
  metrics snapshot over ``/metrics`` (plus follow health on ``/healthz``:
  a trace that stops growing reads degraded).

``--duration`` bounds the serve loop; default runs until interrupted.

Counterpart of ``da4ml_tpu/_cli/monitor.py``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def add_monitor_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('--port', type=int, default=None, help='Bind port (default: DA4ML_METRICS_PORT or ephemeral)')
    parser.add_argument('--host', default='127.0.0.1', help='Bind host (default 127.0.0.1)')
    parser.add_argument('--follow', type=Path, default=None, help='Streaming .jsonl trace of the process to monitor')
    parser.add_argument('--interval', type=float, default=1.0, help='Trace poll interval in seconds')
    parser.add_argument('--duration', type=float, default=0.0, help='Serve for N seconds then exit (0 = until Ctrl-C)')
    parser.add_argument(
        '--stall-after', type=float, default=60.0, help='--follow: seconds without new events before health degrades'
    )


def monitor_main(args: argparse.Namespace) -> int:
    from ..telemetry import get_logger
    from ..telemetry.obs.server import serve

    log = get_logger('cli.monitor')
    tailer = None
    if args.follow is not None:
        if args.follow.suffix != '.jsonl':
            log.warning(f'--follow expects a streaming .jsonl trace, got {args.follow}')
            return 2
        from ..telemetry.obs.openmetrics import render_openmetrics
        from ..telemetry.obs.tailer import TraceTailer

        tailer = TraceTailer(args.follow)
        tailer.poll()

        def _metrics() -> str:
            return render_openmetrics(tailer.metrics)

        def _health() -> dict:
            stale = tailer.staleness_s > args.stall_after
            return {
                'status': 'degraded' if stale else 'ok',
                'checks': {
                    'follow': {
                        'status': 'degraded' if stale else 'ok',
                        'trace': str(args.follow),
                        'n_events': len(tailer.events),
                        'staleness_s': round(tailer.staleness_s, 3),
                        'stall_after_s': args.stall_after,
                    }
                },
            }

        def _status() -> dict:
            from .stats import summarize_events

            return {
                'follow': str(args.follow),
                'n_events': len(tailer.events),
                'n_bad_lines': tailer.n_bad_lines,
                'staleness_s': round(tailer.staleness_s, 3),
                'summary': summarize_events(tailer.events),
                'metrics': tailer.metrics,
            }

        server = serve(
            port=args.port, host=args.host, metrics_provider=_metrics, health_provider=_health, status_provider=_status
        )
    else:
        server = serve(port=args.port, host=args.host)

    log.info(json.dumps({'serving': server.url, 'endpoints': ['/metrics', '/healthz', '/statusz']}))
    deadline = time.monotonic() + args.duration if args.duration > 0 else None
    try:
        while deadline is None or time.monotonic() < deadline:
            if tailer is not None:
                tailer.poll()
            time.sleep(min(args.interval, 0.5))
    except KeyboardInterrupt:
        pass
    return 0
