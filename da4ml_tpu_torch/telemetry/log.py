"""Telemetry-aware stdlib logging for the whole package.

:func:`get_logger` hands out loggers under the ``da4ml_tpu_torch`` hierarchy,
lazily configuring the base logger exactly once:

- INFO and below render as the bare message on the *current* ``sys.stdout``
  (dynamic lookup, so pytest's capsys and stream redirection keep working) —
  byte-identical with the ``print()`` calls this replaced;
- WARNING and above render as ``[LEVEL] message`` on the current
  ``sys.stderr``;
- every record is additionally mirrored into the active trace sinks as an
  instant event (``log.<level>``), so warnings land in the Perfetto
  timeline next to the spans they interrupted;
- ``DA4ML_LOG_LEVEL`` overrides the default INFO threshold;
- nothing is touched if the application already configured handlers on the
  ``da4ml_tpu_torch`` logger.
"""

from __future__ import annotations

import logging
import os
import sys
import threading

from . import core

_configure_lock = threading.Lock()
_configured = False


class _DynamicStreamHandler(logging.StreamHandler):
    """Routes INFO-and-below to sys.stdout and WARNING+ to sys.stderr,
    resolving the stream at emit time (not handler creation time)."""

    def __init__(self):
        super().__init__(stream=sys.stdout)

    def emit(self, record: logging.LogRecord) -> None:
        self.stream = sys.stderr if record.levelno >= logging.WARNING else sys.stdout
        super().emit(record)


class _Formatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = record.getMessage()
        if record.levelno >= logging.WARNING:
            return f'[{record.levelname}] {msg}'
        return msg


class _TelemetryHandler(logging.Handler):
    """Mirrors log records into the trace as instant events."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            core.instant(
                f'log.{record.levelname.lower()}',
                message=record.getMessage(),
                logger=record.name,
            )
        except Exception:
            pass


def _configure_base() -> None:
    global _configured
    with _configure_lock:
        if _configured:
            return
        base = logging.getLogger('da4ml_tpu_torch')
        if not base.handlers:  # respect an application-provided config
            stream = _DynamicStreamHandler()
            stream.setFormatter(_Formatter())
            base.addHandler(stream)
            base.addHandler(_TelemetryHandler())
            level = os.environ.get('DA4ML_LOG_LEVEL', 'INFO').upper()
            base.setLevel(getattr(logging, level, logging.INFO))
            base.propagate = False
        _configured = True


_warned_once: set[str] = set()
_warn_once_lock = threading.Lock()


def warn_once(key: str, message: str, logger: str = '') -> bool:
    """Emit ``message`` as a warning exactly once per process per ``key``.

    For conditions that are worth surfacing but would otherwise repeat on a
    hot path (e.g. a process-global config flag being flipped as a fallback).
    Returns True when the warning was actually emitted.
    """
    with _warn_once_lock:
        if key in _warned_once:
            return False
        _warned_once.add(key)
    get_logger(logger).warning(message)
    return True


def get_logger(name: str = '') -> logging.Logger:
    """A logger under the ``da4ml_tpu_torch`` hierarchy (``name`` may be a bare
    suffix like ``'cmvm.torch'`` or a full ``da4ml_tpu_torch.*`` module path)."""
    _configure_base()
    if not name or name == 'da4ml_tpu_torch':
        return logging.getLogger('da4ml_tpu_torch')
    if name.startswith('da4ml_tpu_torch.'):
        return logging.getLogger(name)
    return logging.getLogger(f'da4ml_tpu_torch.{name}')
