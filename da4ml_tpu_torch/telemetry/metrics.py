"""Metrics registry: counters, gauges, and fixed-bucket histograms.

Process-global, thread-safe, and disabled by default: the accessor
functions (:func:`counter` / :func:`gauge` / :func:`histogram`) return a
shared no-op metric until :func:`enable_metrics` runs (directly, via
``telemetry.enable()``, or via ``DA4ML_TRACE``), so instrumentation sites
cost one function call + one flag read when telemetry is off.

Names follow a dotted ``subsystem.metric`` convention — the catalog lives
in :mod:`.catalog`. :func:`metrics_snapshot` returns the whole registry as
a JSON-serializable dict; the Chrome trace exporter embeds it in the trace
file's ``otherData``.

Device-scheduler metrics: the CMVM device search reports its canonical
shape buckets (``sched.bucket_groups`` / ``sched.bucket_lanes`` /
``sched.dedup_lanes``), its rung ladder (``sched.rungs``,
``cse.device_rounds``, ``sched.device_s``) and its host<->device traffic
(``sched.upload_bytes`` / ``sched.fetch_bytes``).

Counterpart of ``da4ml_tpu/telemetry/metrics.py``.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

#: default histogram bucket upper bounds (seconds-oriented, exponential):
#: spans 100µs .. 100s, which covers everything from a single no-op solve to
#: a full-model conversion. Counts above the last bound land in +Inf.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
)  # fmt: skip

#: count-valued histograms (adder counts, batch sizes, substitutions):
#: 1 .. 1M in a 1/2.5/5 ladder — the seconds buckets put every such sample
#: in +Inf, which made the distributions invisible
COUNT_BUCKETS: tuple[float, ...] = (
    1, 2, 5, 10, 25, 50, 100, 250, 500, 1_000, 2_500, 5_000,
    10_000, 25_000, 50_000, 100_000, 250_000, 500_000, 1_000_000,
)  # fmt: skip

#: byte-valued histograms (transfer sizes, HBM-resident estimates):
#: 1KiB .. 16GiB in powers of four
BYTES_BUCKETS: tuple[float, ...] = tuple(float(1024 * 4**k) for k in range(13))

_registry: dict[str, 'Counter | Gauge | Histogram'] = {}
_lock = threading.Lock()
_enabled = False


class Counter:
    """Monotonically increasing count."""

    __slots__ = ('name', '_value', '_lock')

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def to_dict(self) -> dict:
        return {'type': 'counter', 'value': self._value}


class Gauge:
    """Last-written value (breaker state, campaign progress)."""

    __slots__ = ('name', '_value', '_lock')

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def to_dict(self) -> dict:
        return {'type': 'gauge', 'value': self._value}


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus-style).

    ``observe(v, trace_id=...)`` additionally retains the most recent
    ``(trace_id, value, unix time)`` triple per bucket as an OpenMetrics
    **exemplar**, so a bad latency bucket on ``/metrics`` links straight to
    the trace that landed in it.
    """

    __slots__ = ('name', 'bounds', '_counts', '_sum', '_count', '_min', '_max', '_exemplars', '_lock')

    def __init__(self, name: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.bounds = tuple(sorted(buckets))
        self._counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._min = float('inf')
        self._max = float('-inf')
        self._exemplars: dict[int, tuple[str, float, float]] = {}
        self._lock = threading.Lock()

    def observe(self, v: float, trace_id: 'str | None' = None) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for bound in self.bounds:
                if v <= bound:
                    break
                i += 1
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if trace_id is not None:
                self._exemplars[i] = (trace_id, v, time.time())

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def to_dict(self) -> dict:
        with self._lock:
            d = {
                'type': 'histogram',
                'count': self._count,
                'sum': round(self._sum, 6),
                'bounds': list(self.bounds),
                'buckets': list(self._counts),
            }
            if self._count:
                d['min'] = round(self._min, 6)
                d['max'] = round(self._max, 6)
                d['mean'] = round(self._sum / self._count, 6)
            if self._exemplars:
                d['exemplars'] = {str(i): [t, v, round(ts, 3)] for i, (t, v, ts) in sorted(self._exemplars.items())}
            return d


class _NoopMetric:
    """Disabled-path metric: every mutator is a no-op."""

    __slots__ = ()
    name = ''
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float, trace_id: 'str | None' = None) -> None:
        pass

    def to_dict(self) -> dict:
        return {}


_NOOP_METRIC = _NoopMetric()


def _get(name: str, cls, **kwargs):
    m = _registry.get(name)
    if m is None:
        with _lock:
            m = _registry.get(name)
            if m is None:
                _registry[name] = m = cls(name, **kwargs)
    if not isinstance(m, cls):
        raise TypeError(f'metric {name!r} already registered as {type(m).__name__}, not {cls.__name__}')
    return m


def counter(name: str) -> Counter:
    if not _enabled:
        return _NOOP_METRIC  # type: ignore[return-value]
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    if not _enabled:
        return _NOOP_METRIC  # type: ignore[return-value]
    return _get(name, Gauge)


def histogram(name: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    if not _enabled:
        return _NOOP_METRIC  # type: ignore[return-value]
    return _get(name, Histogram, buckets=buckets)


def metrics_on() -> bool:
    return _enabled


def enable_metrics() -> None:
    global _enabled
    _enabled = True


def disable_metrics() -> None:
    global _enabled
    _enabled = False


def reset_metrics() -> None:
    with _lock:
        _registry.clear()


@contextmanager
def timer(name: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS):
    """Observe a code block's wall clock into histogram ``name``.

    No-op when metrics are disabled — the clock is never read on the
    disabled path, matching the zero-cost contract of the accessors.
    """
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        histogram(name, buckets).observe(time.perf_counter() - t0)


def metrics_snapshot() -> dict:
    """The whole registry as ``{name: {type, value | count/sum/buckets...}}``."""
    with _lock:
        items = sorted(_registry.items())
    return {name: m.to_dict() for name, m in items}
