"""Fixed-point quantization/relu over arrays — the golden numeric semantics.

``fixed_quantize`` implements the full overflow (WRAP / SAT / SAT_SYM) ×
rounding (TRN / RND) matrix natively. Counterpart of
``da4ml_tpu/trace/ops/quantization.py``.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray


def fixed_quantize(
    x: NDArray[np.floating],
    k,
    i,
    f,
    overflow_mode: str = 'WRAP',
    round_mode: str = 'TRN',
) -> NDArray[np.floating]:
    overflow_mode, round_mode = overflow_mode.upper(), round_mode.upper()
    x = np.asarray(x, dtype=np.float64)
    k = np.asarray(k, dtype=np.int64)
    i = np.asarray(i, dtype=np.int64)
    f = np.asarray(f, dtype=np.int64)

    eps = 2.0**-f.astype(np.float64)
    if round_mode == 'RND':
        q = np.floor(x / eps + 0.5) * eps
    elif round_mode == 'TRN':
        q = np.floor(x / eps) * eps
    else:
        raise ValueError(f'Unknown round_mode {round_mode}')

    hi = 2.0**i.astype(np.float64) - eps
    lo = -(2.0**i.astype(np.float64)) * k
    if overflow_mode == 'WRAP':
        b = k + i + f
        bias = 2.0 ** (b - 1).astype(np.float64) * k
        q = eps * ((np.round(q / eps) + bias) % np.exp2(b.astype(np.float64)) - bias)
    elif overflow_mode == 'SAT':
        q = np.clip(q, lo, hi)
    elif overflow_mode == 'SAT_SYM':
        q = np.clip(q, -hi * k, hi)
    else:
        raise ValueError(f'Unknown overflow_mode {overflow_mode}')
    return np.where(k + i + f <= 0, 0.0, q)


def relu(x, i=None, f=None, round_mode: str = 'TRN'):
    from ..fixed_variable_array import FixedVariableArray

    if isinstance(x, FixedVariableArray):
        return x.relu(i=i, f=f, round_mode=round_mode)
    if isinstance(x, list):
        return [xx.relu(i=ii, f=ff, round_mode=round_mode) for xx, ii, ff in zip(x, i, f)]
    round_mode = round_mode.upper()
    assert round_mode in ('TRN', 'RND')
    x = np.maximum(x, 0)
    if f is not None:
        if round_mode == 'RND':
            x = x + 2.0 ** (-np.asarray(f, np.float64) - 1)
        sf = 2.0 ** np.asarray(f, np.float64)
        x = np.floor(x * sf) / sf
    if i is not None:
        x = x % 2.0 ** np.asarray(i, np.float64)
    return x


def leaky_relu(x, alpha):
    """``relu(x) - alpha * relu(-x)`` — exact for symbolic arrays: ``alpha``
    is a trace-time constant, so the negative branch lowers to a CSD
    constant multiply (shared lowering for the LeakyReLU/PReLU front-end
    layers and ReLU ``negative_slope``)."""
    return relu(x) - relu(-x) * alpha


def relu6(x):
    """``min(relu(x), 6)`` — shared exact lowering for the MobileNet-style
    activation in both front-ends."""
    return np.minimum(relu(x), 6.0)


def quantize(x, k, i, f, overflow_mode: str = 'WRAP', round_mode: str = 'TRN'):
    from ..fixed_variable import FixedVariable
    from ..fixed_variable_array import FixedVariableArray

    if isinstance(x, (FixedVariableArray, FixedVariable)):
        return x.quantize(k=k, i=i, f=f, overflow_mode=overflow_mode, round_mode=round_mode)
    if isinstance(x, list):
        out = []
        for n, v in enumerate(x):
            out.append(
                v.quantize(
                    k=int(k[n] if isinstance(k, (list, np.ndarray)) else k),
                    i=int(i[n] if isinstance(i, (list, np.ndarray)) else i),
                    f=int(f[n] if isinstance(f, (list, np.ndarray)) else f),
                    overflow_mode=overflow_mode,
                    round_mode=round_mode,
                )
            )
        return out
    return fixed_quantize(x, k, i, f, overflow_mode, round_mode)
