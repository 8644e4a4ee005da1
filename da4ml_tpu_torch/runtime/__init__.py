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


__all__ = ['run_comb', 'program_from_binary', 'BACKENDS']
