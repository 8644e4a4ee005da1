"""Runtime: bit-exact execution of DAIS programs.

- ``torch``: :class:`~.torch_backend.DaisExecutor` — the hand-written CUDA
  kernel on a CUDA device (``cuda_backend``), its plain torch version on
  ``device='cpu'``;
- ``numpy``: the table-generated host reference interpreter (``reference``).
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray

BACKENDS = ('torch', 'numpy')


def run_comb(comb, data: NDArray[np.float64], backend: str = 'torch', device=None) -> NDArray[np.float64]:
    """Execute a CombLogic over a (n_samples, n_in) batch with the given backend."""
    binary = comb.to_binary()
    if backend == 'numpy':
        from .reference import run_binary

        return run_binary(binary, data)
    if backend == 'torch':
        from .torch_backend import run_binary

        return run_binary(binary, data, device=device)
    raise ValueError(f'Unknown backend {backend!r} (expected one of {BACKENDS})')


def program_from_binary(binary: NDArray[np.int32], device=None):
    """The executor of a flat int32 DAIS binary — as ``da4ml_tpu``'s
    ``CombLogic.to_binary()`` writes it — on ``device`` (the card when None)."""
    from ..ir.dais_binary import decode
    from .torch_backend import DaisExecutor

    return DaisExecutor(decode(binary), device=device)


__all__ = ['run_comb', 'program_from_binary', 'BACKENDS']
