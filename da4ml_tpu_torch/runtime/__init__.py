"""Runtime: bit-exact execution of DAIS programs.

- ``torch`` (the default): :class:`~.torch_backend.DaisExecutor` — the
  hand-written CUDA kernel on a CUDA device (``cuda_backend``), its plain
  torch version on ``device='cpu'``; ``mode`` forces one of its modes
  (``'unroll'``, ``'scan'``, ``'level'``, ``'pallas'``), and ``'auto'`` (the
  default) takes the static answer or the measured race, its decisions in
  ``mode_decisions()``;
- ``numpy``: the vectorized int64 host interpreter (``numpy_backend``);
- ``cpp``: the native C++ host interpreter, OpenMP over sample chunks
  (``da4ml_tpu_torch.native``; ``n_threads <= 0`` leaves the count to OpenMP).

The table-driven interpreter ``reference`` is the oracle all three are held
to. No backend is picked on the caller's behalf: the host runtimes run only
when named.

Pipelines: ``run_pipeline`` (``fused=True``, and ``False``, the same path
here: the stages chained on the device behind one call boundary; ``'ir'``:
the stages fused into one DAIS program first),
``PipelineExecutor`` and ``fused_executor_for_binaries``, from
``torch_backend`` (imported on first use: this package imports no torch
until an executor is asked for).
"""

from __future__ import annotations

import time

import numpy as np
from numpy.typing import NDArray

from .. import telemetry

BACKENDS = ('torch', 'numpy', 'cpp')
#: the torch backend's executor modes (``'auto'`` resolves to one of these)
MODES = ('unroll', 'scan', 'level', 'pallas')
#: op-count ceiling of ``mode='unroll'`` (one Python step per op)
UNROLL_LIMIT = 20_000


def run_comb(
    comb, data: NDArray[np.float64], backend: str = 'torch', device=None, n_threads: int = 0, mode: str | None = None
) -> NDArray[np.float64]:
    """Execute a CombLogic over a (n_samples, n_in) batch with the given
    backend; ``device`` and ``mode`` are the torch backend's (``mode`` one
    of ``MODES``, None for ``'auto'``), ``n_threads`` the cpp
    one's. One ``runtime.run_comb`` span and ``runtime.*`` sample per call."""
    if mode is not None and backend != 'torch':
        raise ValueError(f"execution mode selection requires backend='torch', got {backend!r}")
    _metrics = telemetry.metrics_on()
    _t0 = time.perf_counter() if _metrics else 0.0
    with telemetry.span('runtime.run_comb', backend=backend, n_samples=len(data)):
        result = _run_comb_backend(comb.to_binary(), data, backend, device, n_threads, mode)
    if _metrics:
        telemetry.histogram('runtime.run_s').observe(time.perf_counter() - _t0)
        telemetry.counter('runtime.samples').inc(len(data))
    return result


def _run_comb_backend(binary, data, backend: str, device, n_threads: int, mode: str | None = None) -> NDArray[np.float64]:
    if backend == 'torch':
        from .torch_backend import run_binary

        return run_binary(binary, data, device=device, mode=mode or 'auto')
    if backend == 'numpy':
        from .numpy_backend import run_binary

        return run_binary(binary, data)
    if backend == 'cpp':
        from ..native import run_binary

        return run_binary(binary, data, n_threads=n_threads)
    raise ValueError(f'Unknown backend {backend!r} (expected one of {BACKENDS})')


def program_from_binary(binary: NDArray[np.int32], device=None):
    """The executor of a flat int32 DAIS binary — as ``da4ml_tpu``'s
    ``CombLogic.to_binary()`` writes it — on ``device`` (the card when None)."""
    from ..ir.dais_binary import decode
    from .torch_backend import DaisExecutor

    return DaisExecutor(decode(binary), device=device)


#: names served from ``torch_backend`` on first use
_TORCH_BACKEND = ('PipelineExecutor', 'fused_executor_for_binaries', 'run_pipeline', 'mode_decisions')


def __getattr__(name: str):
    if name in _TORCH_BACKEND:
        from . import torch_backend

        return getattr(torch_backend, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


__all__ = ['run_comb', 'program_from_binary', 'BACKENDS', 'MODES', *_TORCH_BACKEND]
