"""Health and status snapshots for the live endpoints.

``/healthz`` aggregates these signals into ``ok`` / ``degraded``:

- **circuit breakers**: always ``ok`` and empty until the port carries a
  reliability layer;
- **campaign heartbeat**: a campaign beats ``telemetry.beat('campaign')``
  per kernel; an in-progress campaign whose last beat is older than
  ``DA4ML_HEALTH_STALL_S`` (default 120 s) indicates a stalled worker;
- **compile-cache hit ratio** (informational, never degrades health).

``/statusz`` is the wide-angle JSON: scheduler bucket occupancy, deadline
workers, active spans, device inventory. Snapshots must be scrape-safe: they
never initialize CUDA or import modules that are not already loaded.

Counterpart of ``da4ml_tpu/telemetry/obs/health.py``. The port carries no
breaker, serve engine, router, fleet, solution store, campaign driver, lock
tracer or run-mode autotuner yet, so their sections hold what the reference
reports when those modules are not loaded: no breakers, no campaign workers,
and ``None`` or ``{}`` in ``/statusz``.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from .. import core
from ..metrics import metrics_on, metrics_snapshot

_T0 = time.monotonic()

#: campaign heartbeat older than this (while a campaign is in progress)
#: flips health to degraded
DEFAULT_STALL_S = 120.0


def _stall_threshold_s() -> float:
    try:
        return float(os.environ.get('DA4ML_HEALTH_STALL_S', '') or DEFAULT_STALL_S)
    except ValueError:
        return DEFAULT_STALL_S


def _metric_value(snap: dict, name: str) -> float | None:
    m = snap.get(name)
    return None if m is None else m.get('value')


def _campaign_check(snap: dict) -> dict:
    done = _metric_value(snap, 'campaign.done')
    total = _metric_value(snap, 'campaign.total')
    age = core.beat_age_s('campaign')
    in_progress = total is not None and total > 0 and (done is None or done < total)
    stalled = bool(in_progress and age is not None and age > _stall_threshold_s())
    return {
        'status': 'degraded' if stalled else 'ok',
        'in_progress': bool(in_progress),
        'done': done,
        'total': total,
        'heartbeat_age_s': None if age is None else round(age, 3),
        'stall_threshold_s': _stall_threshold_s(),
    }


def _cache_check(snap: dict) -> dict:
    compiles = _metric_value(snap, 'jit.compile') or 0.0
    loads = _metric_value(snap, 'jit.cache_load') or 0.0
    first_calls = compiles + loads
    return {
        'status': 'ok',  # informational: a cold cache is not ill health
        'compiles': compiles,
        'cache_loads': loads,
        'hit_ratio': round(loads / first_calls, 4) if first_calls else None,
    }


def refresh_computed_gauges() -> None:
    """Materialize scrape-time values into the registry so ``/metrics`` and
    ``metrics_snapshot()`` carry them: the aggregate health bit. No-op while
    metrics are disabled."""
    if not metrics_on():
        return
    from ..metrics import gauge

    gauge('health.status').set(0.0 if health_snapshot()['status'] == 'ok' else 1.0)


def health_snapshot(snap: dict | None = None) -> dict:
    """The ``/healthz`` document. ``status`` is ``ok`` or ``degraded``."""
    if snap is None:
        snap = metrics_snapshot()
    checks = {
        'breakers': {'status': 'ok', 'open': [], 'states': {}},
        'campaign': _campaign_check(snap),
        'compile_cache': _cache_check(snap),
    }
    status = 'degraded' if any(c['status'] == 'degraded' for c in checks.values()) else 'ok'
    return {
        'status': status,
        'checks': checks,
        'pid': os.getpid(),
        'uptime_s': round(time.monotonic() - _T0, 3),
        'metrics_enabled': metrics_on(),
    }


def _device_inventory() -> dict | None:
    """Local CUDA device info — only when CUDA is already initialized in this
    process (a scrape must never pay, or trigger, its startup)."""
    torch = sys.modules.get('torch')
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        devices = []
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            devices.append({'index': i, 'name': torch.cuda.get_device_name(i), 'memory_free': int(free),
                            'memory_total': int(total), 'memory_allocated': int(torch.cuda.memory_allocated(i))})  # fmt: skip
        return {'platform': 'gpu', 'count': len(devices), 'devices': devices}
    except Exception:
        return None


def status_snapshot() -> dict:
    """The ``/statusz`` document: everything a person debugging a live
    process wants on one page."""
    snap = metrics_snapshot()
    sched = {k: v.get('value', v.get('count')) for k, v in snap.items() if k.startswith(('sched.', 'emit.'))}
    run = {k: v.get('value', v.get('count')) for k, v in snap.items() if k.startswith('run.')}
    serve_metrics = {k: v.get('value', v.get('count')) for k, v in snap.items() if k.startswith('serve.')}
    deadline_workers = [t.name for t in threading.enumerate() if t.name.startswith('da4ml-deadline-')]
    return {
        'pid': os.getpid(),
        'uptime_s': round(time.monotonic() - _T0, 3),
        'telemetry': {
            'metrics_enabled': metrics_on(),
            'tracing_active': core.tracing_active(),
            'n_metrics': len(snap),
        },
        'health': health_snapshot(snap),
        'active_spans': core.active_spans(),
        'run_modes': {},
        'scheduler': sched,
        'runtime': run,
        'serve': None,
        'serve_metrics': serve_metrics,
        'store': None,
        'router': None,
        'fleet': None,
        'locktrace': None,
        'deadline_workers': deadline_workers,
        'devices': _device_inventory(),
    }
