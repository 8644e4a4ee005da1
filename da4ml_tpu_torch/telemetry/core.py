"""Telemetry core: hierarchical spans, event sinks, and phase collectors.

Counterpart of ``da4ml_tpu/telemetry/core.py``. Design constraints:

- **Near-zero overhead when disabled.** ``span()`` checks one module-level
  flag and returns a shared no-op singleton — no object allocation, no
  clock read — so the hot solve path costs one function call + one
  attribute read per instrumentation site when nothing is listening.
- **Thread-safe.** Each thread owns its span stack (parentage never crosses
  threads); sinks are appended under a lock but read lock-free as an
  immutable tuple; span ids come from ``itertools.count`` (atomic under the
  GIL).
- **Fork-safe.** Sinks record their creating pid and drop events from
  forked children (a caller may fork worker processes), so a child's atexit
  can never corrupt the parent's trace file. Span ids are re-seeded in
  forked children (``os.register_at_fork``) so a merged fleet timeline
  never aliases two spans from different processes.
- **Fleet-unique identity.** Span ids carry a per-process random epoch in
  their high bits; requests crossing process boundaries share a 128-bit
  trace id propagated via a W3C ``traceparent``-style header
  (:func:`bind_trace` / :func:`parse_traceparent` /
  :func:`format_traceparent`).

Spans deliver Chrome trace-event ``"X"`` (complete) events to every
registered sink; :func:`instant` delivers ``"i"`` events. Phase collectors
(:func:`collect_phases`) aggregate closed-span durations per name on the
calling thread — the reliability orchestrator uses one to attach phase
timings to a report without requiring a trace file.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

_T0 = time.perf_counter()
_PID = os.getpid()


def _span_id_source() -> 'itertools.count[int]':
    """Per-process-seeded span ids: a 31-bit pid+random epoch in the high
    bits over a 32-bit in-process counter. Two processes (or a parent and
    its forked child) can then never mint the same span id, so merged
    multi-replica timelines keep span/parent links unambiguous."""
    epoch = (os.getpid() ^ int.from_bytes(os.urandom(4), 'big')) & 0x7FFFFFFF
    return itertools.count((epoch << 32) | 1)


_ids = _span_id_source()


def _after_fork_child() -> None:
    global _PID, _ids
    _PID = os.getpid()
    _ids = _span_id_source()


if hasattr(os, 'register_at_fork'):  # pragma: no branch
    os.register_at_fork(after_in_child=_after_fork_child)


def _now_us() -> float:
    """Microseconds since the telemetry epoch (module import)."""
    return (time.perf_counter() - _T0) * 1e6


def monotonic_ts_us(t_mono: float) -> float:
    """Map a ``time.monotonic`` stamp onto the trace ``ts`` epoch — for
    emitting spans (:func:`emit_span`) whose brackets were recorded with the
    monotonic clock (the serve queue's waterfall timestamps)."""
    return (time.perf_counter() - _T0 - (time.monotonic() - t_mono)) * 1e6


class _State:
    __slots__ = ('sinks', 'collectors', 'watchers', 'active', 'lock')

    def __init__(self):
        self.sinks: tuple = ()  # immutable tuple -> lock-free reads on the hot path
        self.collectors = 0  # process-wide count of open collect_phases() blocks
        self.watchers = 0  # live span observers (the /statusz endpoint)
        self.active = False  # sinks, collectors, or watchers present
        self.lock = threading.Lock()

    def refresh(self) -> None:
        self.active = bool(self.sinks) or self.collectors > 0 or self.watchers > 0


_state = _State()
_tls = threading.local()

#: spans currently open anywhere in the process (span_id -> Span); only
#: populated while telemetry is active (disabled spans are the shared no-op
#: singleton and never registered). /statusz renders this live.
_active_spans: dict[int, 'Span'] = {}

#: liveness heartbeats: name -> last-beat monotonic clock. Written by
#: long-running drivers (solve_many campaigns), read by the /healthz
#: endpoint to detect stalled workers. Plain dict ops are atomic under the
#: GIL; no lock needed.
_heartbeats: dict[str, float] = {}


def beat(name: str) -> None:
    """Record a liveness heartbeat for ``name`` (monotonic clock). Unlike
    metrics this is always on — it is one dict store, and health checks
    must work even when the metrics registry is disabled."""
    _heartbeats[name] = time.monotonic()


def beat_age_s(name: str) -> float | None:
    """Seconds since the last :func:`beat` for ``name``, or None if never."""
    t = _heartbeats.get(name)
    return None if t is None else time.monotonic() - t


def current_span() -> 'Span | None':
    """The innermost open span of the calling thread, or None."""
    st = getattr(_tls, 'stack', None)
    return st[-1] if st else None


# ---------------------------------------------------------------------------
# trace context: fleet-unique identity + traceparent-style propagation
# ---------------------------------------------------------------------------


def new_trace_id() -> str:
    """A fresh 128-bit trace id as 32 lowercase hex chars."""
    return os.urandom(16).hex()


def new_span_id() -> int:
    """Mint a fleet-unique span id without opening a span — used by callers
    that must hand a child span id to a remote party (the router's hedge
    legs) before the span's duration is known."""
    return next(_ids)


def format_traceparent(trace_id: str, span_id: int | None = None) -> str:
    """Render a W3C ``traceparent``-style header value:
    ``00-<32 hex trace id>-<16 hex parent span id>-01``."""
    return f'00-{trace_id}-{(span_id or 0) & 0xFFFFFFFFFFFFFFFF:016x}-01'


def parse_traceparent(header: 'str | None') -> 'tuple[str, int | None] | None':
    """Parse a ``traceparent`` header into ``(trace_id, parent_span_id)``.
    Returns None for anything malformed (wrong version, lengths, non-hex,
    all-zero trace id); an all-zero parent id maps to ``None`` parent."""
    if not header:
        return None
    parts = header.strip().lower().split('-')
    if len(parts) < 4 or parts[0] != '00' or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        t_val = int(parts[1], 16)
        s_val = int(parts[2], 16)
    except ValueError:
        return None
    if t_val == 0:
        return None
    return parts[1], (s_val or None)


class bind_trace:
    """Bind a trace context to the calling thread for the ``with`` block.

    Spans opened inside the block carry ``trace_id`` in their emitted args,
    and a root span (no in-thread parent) adopts ``parent_span_id`` as its
    parent — stitching this process's subtree under the remote caller's
    span in a merged timeline. Mints a fresh 128-bit trace id when none is
    given. Bindings nest; the previous context is restored on exit.
    """

    __slots__ = ('trace_id', 'parent_span_id', '_prev')

    def __init__(self, trace_id: 'str | None' = None, parent_span_id: 'int | None' = None):
        self.trace_id = trace_id or new_trace_id()
        self.parent_span_id = parent_span_id

    def __enter__(self) -> 'bind_trace':
        self._prev = getattr(_tls, 'trace', None)
        _tls.trace = (self.trace_id, self.parent_span_id)
        return self

    def __exit__(self, exc_type, exc, tb):
        _tls.trace = self._prev
        return False


def current_trace() -> 'tuple[str, int | None] | None':
    """The calling thread's bound ``(trace_id, parent_span_id)``, or None."""
    return getattr(_tls, 'trace', None)


def current_trace_id() -> 'str | None':
    """The calling thread's bound trace id, or None."""
    tb = getattr(_tls, 'trace', None)
    return tb[0] if tb is not None else None


def active_spans() -> list[dict]:
    """Snapshot of every span currently open in the process (any thread),
    oldest first: ``{span_id, parent_id, name, age_s, attrs}``."""
    now = time.perf_counter()
    out = []
    for sp in sorted(_active_spans.values(), key=lambda s: s.t0):
        out.append(
            {
                'span_id': sp.span_id,
                'parent_id': sp.parent_id,
                'name': sp.name,
                'age_s': round(now - sp.t0, 6) if sp.t0 else 0.0,
                'attrs': {k: v for k, v in sp.attrs.items()},
            }
        )
    return out


def _stack() -> list:
    st = getattr(_tls, 'stack', None)
    if st is None:
        st = _tls.stack = []
    return st


def _collectors() -> list:
    pc = getattr(_tls, 'phases', None)
    if pc is None:
        pc = _tls.phases = []
    return pc


def _tid() -> int:
    return threading.get_ident() & 0x7FFFFFFF


def _emit(event: dict) -> None:
    for sink in _state.sinks:
        try:
            sink.emit(event)
        except Exception:
            pass  # a broken sink must never fail the instrumented call


class Span:
    """One timed region. Context manager; nests via the per-thread stack."""

    __slots__ = ('name', 'attrs', 'span_id', 'parent_id', 'trace_id', 't0', 'ts_us', 'duration_s')

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.span_id = next(_ids)
        self.parent_id: int | None = None
        self.trace_id: str | None = None
        self.t0 = 0.0
        self.ts_us = 0.0
        self.duration_s = 0.0

    def set(self, **attrs) -> 'Span':
        """Attach attributes after entry (e.g. a result count known at exit)."""
        self.attrs.update(attrs)
        return self

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> 'Span':
        st = _stack()
        self.parent_id = st[-1].span_id if st else None
        tb = getattr(_tls, 'trace', None)
        if tb is not None:
            self.trace_id = tb[0]
            if self.parent_id is None:
                self.parent_id = tb[1]
        st.append(self)
        self.t0 = time.perf_counter()
        self.ts_us = (self.t0 - _T0) * 1e6
        _active_spans[self.span_id] = self
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration_s = time.perf_counter() - self.t0
        _active_spans.pop(self.span_id, None)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # unbalanced exit: drop self and everything above it
            del st[st.index(self) :]
        if exc_type is not None:
            self.attrs['error'] = exc_type.__name__
        if _state.sinks:
            args = dict(self.attrs)
            args['span_id'] = self.span_id
            if self.parent_id is not None:
                args['parent_id'] = self.parent_id
            if self.trace_id is not None:
                args['trace_id'] = self.trace_id
            _emit(
                {
                    'name': self.name,
                    'ph': 'X',
                    'ts': round(self.ts_us, 1),
                    'dur': round(self.duration_s * 1e6, 1),
                    'pid': _PID,
                    'tid': _tid(),
                    'args': args,
                }
            )
        for phases in _collectors():
            phases[self.name] = phases.get(self.name, 0.0) + self.duration_s
        return False


class _NoopSpan:
    """Shared disabled-path span: reusable, reentrant, allocation-free."""

    __slots__ = ()
    span_id = None
    parent_id = None
    trace_id = None
    duration_s = 0.0

    def set(self, **attrs) -> '_NoopSpan':
        return self

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> '_NoopSpan':
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_SPAN = _NoopSpan()


def span(name: str, /, **attrs):
    """A timed region. Returns the no-op singleton when telemetry is off.

    ``name`` is positional-only so an attribute may also be called "name"
    (e.g. ``span('codegen.rtl.write', name=model.name)``)."""
    if not _state.active:
        return _NOOP_SPAN
    return Span(name, attrs)


def instant(name: str, /, **attrs) -> None:
    """A point-in-time event (campaign heartbeats, breaker transitions).
    Carries the thread's bound trace id (:class:`bind_trace`) so log
    mirrors and access-log records correlate with their request trace."""
    if not _state.sinks:
        return
    tb = getattr(_tls, 'trace', None)
    if tb is not None and 'trace_id' not in attrs:
        attrs['trace_id'] = tb[0]
    _emit(
        {
            'name': name,
            'ph': 'i',
            's': 't',
            'ts': round(_now_us(), 1),
            'pid': _PID,
            'tid': _tid(),
            'args': attrs,
        }
    )


def emit_span(
    name: str,
    ts_us: float,
    duration_s: float,
    *,
    trace_id: 'str | None' = None,
    parent_id: 'int | None' = None,
    span_id: 'int | None' = None,
    **attrs,
) -> int:
    """Emit a completed span event directly, bypassing the thread stack.

    For cross-thread waterfall segments whose begin and end are observed on
    a different thread than the owning request (the serve engine's batcher
    recording per-request queue/execute/serialize segments, the router's
    hedge legs): the caller supplies explicit timing and parentage instead
    of inheriting the emitting thread's stack. Returns the span id used
    (minted when not supplied), or 0 when no sink is registered.
    """
    if not _state.sinks:
        return 0
    sid = span_id if span_id is not None else next(_ids)
    args = dict(attrs)
    args['span_id'] = sid
    if parent_id is not None:
        args['parent_id'] = parent_id
    if trace_id is not None:
        args['trace_id'] = trace_id
    _emit(
        {
            'name': name,
            'ph': 'X',
            'ts': round(ts_us, 1),
            'dur': round(duration_s * 1e6, 1),
            'pid': _PID,
            'tid': _tid(),
            'args': args,
        }
    )
    return sid


class _PhaseCollector:
    """Aggregates closed-span durations by name on the entering thread."""

    __slots__ = ('phases',)

    def __enter__(self) -> dict:
        self.phases: dict[str, float] = {}
        _collectors().append(self.phases)
        with _state.lock:
            _state.collectors += 1
            _state.refresh()
        return self.phases

    def __exit__(self, exc_type, exc, tb):
        pcs = _collectors()
        if self.phases in pcs:
            pcs.remove(self.phases)
        with _state.lock:
            _state.collectors -= 1
            _state.refresh()
        return False


def collect_phases() -> _PhaseCollector:
    """Context manager yielding a ``{span name: cumulative seconds}`` dict
    of every span closed on this thread while the block is open. Activates
    the span machinery even without a trace sink."""
    return _PhaseCollector()


# ---------------------------------------------------------------------------
# sink management / activation
# ---------------------------------------------------------------------------


def add_sink(sink) -> None:
    with _state.lock:
        _state.sinks = _state.sinks + (sink,)
        _state.refresh()


def remove_sink(sink) -> None:
    with _state.lock:
        _state.sinks = tuple(s for s in _state.sinks if s is not sink)
        _state.refresh()


def tracing_active() -> bool:
    """True when at least one event sink is registered."""
    return bool(_state.sinks)


def add_span_watcher() -> None:
    """Arm real (registered) spans without a trace sink, so ``active_spans``
    reflects live work — held by the /statusz endpoint for its lifetime.
    Spans still emit nothing; the only cost over the no-op path is the
    per-span object and stack bookkeeping."""
    with _state.lock:
        _state.watchers += 1
        _state.refresh()


def remove_span_watcher() -> None:
    with _state.lock:
        _state.watchers = max(0, _state.watchers - 1)
        _state.refresh()


def enable(path: 'str | os.PathLike | None' = None, metrics: bool = True):
    """Turn telemetry on: enable the metrics registry and (optionally) open a
    trace sink at ``path`` (``.jsonl`` → JSONL event log, anything else →
    Chrome trace-event JSON for Perfetto / chrome://tracing).

    Returns the created sink (or None when no path was given). Equivalent to
    setting ``DA4ML_TRACE=<path>`` in the environment before import.
    """
    if metrics:
        from .metrics import enable_metrics

        enable_metrics()
    if path:
        from .export import sink_for

        sink = sink_for(path)
        add_sink(sink)
        return sink
    return None


def disable() -> None:
    """Close and unregister every sink (flushing trace files) and freeze the
    metrics registry. Recorded metric values are kept until :func:`reset`."""
    with _state.lock:
        sinks, _state.sinks = _state.sinks, ()
        _state.refresh()
    for sink in sinks:
        try:
            sink.close()
        except Exception:
            pass
    from .metrics import disable_metrics

    disable_metrics()


def reset() -> None:
    """Full teardown for test isolation: close sinks, drop all metric values."""
    disable()
    from .metrics import reset_metrics

    reset_metrics()
    _heartbeats.clear()
    _active_spans.clear()


def _init_from_env() -> None:
    path = os.environ.get('DA4ML_TRACE')
    if path:
        enable(path)
    port = os.environ.get('DA4ML_METRICS_PORT')
    if port:
        # opt-in live endpoint; a bad port value or bind failure must never
        # break the instrumented process at import time
        try:
            from .obs.server import serve

            serve(port=int(port))
        except Exception as e:
            from .log import get_logger

            get_logger('telemetry.obs').warning(f'DA4ML_METRICS_PORT={port!r}: could not start endpoint: {e}')
