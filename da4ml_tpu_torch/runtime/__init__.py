"""Runtime: bit-exact execution of DAIS programs.

- ``torch`` (the default): :class:`~.torch_backend.DaisExecutor` — the
  hand-written CUDA kernel on a CUDA device (``cuda_backend``), its plain
  torch version on ``device='cpu'``;
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

import numpy as np
from numpy.typing import NDArray

BACKENDS = ('torch', 'numpy', 'cpp')


def run_comb(
    comb, data: NDArray[np.float64], backend: str = 'torch', device=None, n_threads: int = 0
) -> NDArray[np.float64]:
    """Execute a CombLogic over a (n_samples, n_in) batch with the given
    backend; ``device`` is the torch backend's, ``n_threads`` the cpp one's."""
    binary = comb.to_binary()
    if backend == 'torch':
        from .torch_backend import run_binary

        return run_binary(binary, data, device=device)
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
_TORCH_BACKEND = ('PipelineExecutor', 'fused_executor_for_binaries', 'run_pipeline')


def __getattr__(name: str):
    if name in _TORCH_BACKEND:
        from . import torch_backend

        return getattr(torch_backend, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


__all__ = ['run_comb', 'program_from_binary', 'BACKENDS', *_TORCH_BACKEND]
