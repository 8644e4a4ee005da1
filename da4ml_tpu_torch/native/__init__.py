"""Native (C++) host components: the DAIS interpreter, the CMVM solver, and
the device search's batched decomposition and emission.

The shared library is built with g++ from ``native/src`` at first use (see
:mod:`.build`) and bound with ctypes (:mod:`.bindings`, re-exported here);
it imports neither torch nor anything outside numpy. When it cannot be built,
``is_available()`` is False and the entry points raise with the compiler's
message (``load_error()``).

Counterpart of ``da4ml_tpu/native/``.
"""

from __future__ import annotations

from .bindings import decompose_batch, emit_batch, has_emit, load_error, load_lib, run_binary, solve_native


def is_available() -> bool:
    return load_lib() is not None


def has_solver() -> bool:
    """True when the native CMVM solver (the ``cmvm_solve`` symbol) is built."""
    lib = load_lib()
    return lib is not None and hasattr(lib, 'cmvm_solve')


__all__ = [
    'decompose_batch',
    'emit_batch',
    'has_emit',
    'has_solver',
    'is_available',
    'load_error',
    'load_lib',
    'run_binary',
    'solve_native',
]
