"""Device-profile correlation (``DA4ML_PROFILE=<dir>``).

Setting ``DA4ML_PROFILE`` arms ``torch.profiler`` (CPU activities, and
CUDA's where a CUDA device is present): the first annotated region starts
the profiler, and :func:`stop` — registered ``atexit`` — stops it and
writes a Chrome trace, ``<dir>/da4ml_profile.<pid>.json``. Every CMVM device rung (K2), beam fork
step and prune, and runtime batch call (K1) is wrapped in
:func:`annotate`: a ``torch.profiler.record_function`` and a
``torch.cuda.nvtx.range``, both named ``da4ml:<span name>#span=<id>`` —
the owning telemetry span id — so Perfetto shows the host telemetry spans
and the CUDA kernels they launched on one correlated timeline (load the
profile next to the ``DA4ML_TRACE`` Chrome trace).

Disabled (no env var): :func:`annotate` costs one dict lookup and returns a
shared ``nullcontext`` — the hot paths stay clean.

The profiler start is best-effort: a profiler that cannot start logs one
warning and disarms for the process instead of failing the work. It never
changes which kernel runs or where.

Counterpart of ``da4ml_tpu/telemetry/obs/profile.py`` (``jax.profiler``
and ``TraceAnnotation`` there).
"""

from __future__ import annotations

import atexit
import os
import threading
from contextlib import ExitStack, nullcontext

_NULL = nullcontext()
_lock = threading.Lock()
_prof = None
_dir: str | None = None
_failed = False


def profile_dir() -> str | None:
    """The armed profile output directory, or None when profiling is off."""
    return os.environ.get('DA4ML_PROFILE') or None


def trace_path(d: str) -> str:
    """The Chrome trace file :func:`stop` writes into directory ``d``."""
    return os.path.join(d, f'da4ml_profile.{os.getpid()}.json')


def stop() -> str | None:
    """Stop the process-wide profiler and export its Chrome trace; returns the
    file written, or None when no profiler was running in this process."""
    global _prof
    with _lock:
        prof, _prof = _prof, None
    if prof is None:
        return None
    try:
        prof.stop()
        path = trace_path(_dir)
        prof.export_chrome_trace(path)
        return path
    except Exception as e:
        from ..log import warn_once

        warn_once('obs.profile.stop_failed', f'DA4ML_PROFILE={_dir!r}: profile export failed: {e}', logger='telemetry.obs')
        return None


def _ensure_started(d: str) -> bool:
    """Start the process-wide profiler once; False if unavailable."""
    global _prof, _dir, _failed
    if _prof is not None:
        return True
    if _failed:
        return False
    with _lock:
        if _prof is not None:
            return True
        if _failed:
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(d, exist_ok=True)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
            prof = profile(activities=acts)
            prof.start()
            _prof, _dir = prof, d
            atexit.register(stop)
        except Exception as e:
            _failed = True
            from ..log import warn_once

            warn_once(
                'obs.profile.start_failed',
                f'DA4ML_PROFILE={d!r}: torch profiler unavailable, device profiling disabled: {e}',
                logger='telemetry.obs',
            )
            return False
    return True


def annotate(name: str, span_id: 'int | None' = None):
    """Context manager bracketing a device dispatch/fetch region.

    When profiling is armed, returns a ``record_function`` plus an NVTX range
    tagged with the owning telemetry span id; otherwise a shared no-op
    context. ``span_id=None`` falls back to the innermost open span of the
    calling thread."""
    d = profile_dir()
    if not d or not _ensure_started(d):
        return _NULL
    if span_id is None:
        from ..core import current_span

        sp = current_span()
        span_id = sp.span_id if sp is not None else None
    try:
        import torch

        tag = f'da4ml:{name}' if span_id is None else f'da4ml:{name}#span={span_id}'
        stack = ExitStack()
        stack.enter_context(torch.profiler.record_function(tag))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(tag))
        return stack
    except Exception:
        return _NULL


def profiling_active() -> bool:
    """True while the process-wide profiler runs."""
    return _prof is not None
