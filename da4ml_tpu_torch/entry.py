"""The flagship forward step on the card.

Counterpart of ``__graft_entry__.py``'s ``_flagship_comb`` and ``entry``: a
JEDI-linear-style quantized MLP is traced, its matrices are CMVM-solved into
one DAIS program — on the host (``backend='auto'``, the reference's
default: the native solver when it builds, else the Python one; or either
by name, ``'cpp'`` or ``'cpu'``) or by the device search (``backend='torch'``,
whose greedy loop is the CUDA kernel ``csrc/fused_cse.cu``) — and the
program runs through the hand-written CUDA kernel ``csrc/dais_exec.cu``.
Every backend gives the same program, byte for byte.
"""

from __future__ import annotations

import numpy as np

from .ir.comb import CombLogic

_FLAGSHIP: dict[tuple, CombLogic] = {}


def flagship_comb(n_in=16, hidden=(32, 32), n_out=5, backend='auto', n_workers=0, device=None, quality=None) -> CombLogic:
    """Trace the JEDI-linear-style MLP to a CombLogic: 4-bit integer weights,
    ``relu(i=5, f=2)`` between layers, inputs quantized to (1, 3, 2).

    The trace is deterministic, so it is kept per (shape, backend, device);
    ``n_workers`` host processes share each layer's decompose-depth sweep of
    the ``'cpu'`` solver (threads of the ``'cpp'`` one) without changing the
    result; ``device`` is where the ``'torch'`` backend searches (the card
    when None); ``quality`` is the solver's search strategy (a preset name).
    """
    key = (n_in, tuple(hidden), n_out, backend, None if device is None else str(device), quality)
    if key in _FLAGSHIP:
        return _FLAGSHIP[key]
    from .trace import FixedVariableArrayInput, HWConfig, comb_trace

    rng = np.random.default_rng(20260729)
    opts = {'backend': backend}
    if n_workers:
        opts['n_workers'] = n_workers
    if device is not None:
        opts['device'] = device
    if quality is not None:
        opts['quality'] = quality
    inp = FixedVariableArrayInput(n_in, hwconf=HWConfig(1, -1, -1), solver_options=opts)
    x = inp.quantize(np.ones(n_in), np.full(n_in, 3), np.full(n_in, 2))
    dims = [n_in, *hidden, n_out]
    for li in range(len(dims) - 1):
        w = rng.integers(-8, 8, (dims[li], dims[li + 1])).astype(np.float64)
        x = x @ w
        if li < len(dims) - 2:
            x = x.relu(i=np.full(dims[li + 1], 5), f=np.full(dims[li + 1], 2))
    _FLAGSHIP[key] = comb = comb_trace(inp, x)
    return comb


def entry(device=None):
    """``(fn, (x,))`` — the flagship forward step: ``fn`` launches the DAIS
    kernel on the (64, 16) integer input ``x``, which lies on the card unless
    ``device`` says otherwise."""
    from .ir.dais_binary import decode
    from .runtime.torch_backend import DaisExecutor

    comb = flagship_comb()
    ex = DaisExecutor(decode(comb.to_binary()), device=device)
    x = ex.int_inputs(np.random.default_rng(0).uniform(-8, 8, (64, comb.shape[0])))
    return ex.fn_int, (x,)
