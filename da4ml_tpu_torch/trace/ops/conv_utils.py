"""Convolution and pooling over symbolic fixed-point arrays.

Convolutions lower to im2col + one constant matmul: every output pixel's
receptive field becomes a row of a patch matrix, and the whole convolution is
a single ``patches @ kernel_2d`` — which routes through the CMVM optimizer
(one lane batch of the device search on the torch backend, with
identical-metadata rows deduplicated so a conv solves only its handful of
distinct border patterns). Depthwise convolutions send every channel's job
to ``cmvm_multi`` at once. Layout is channels-last.

Pooling uses the same patch extraction with window-axis reductions
(heap-balanced max trees / constant-scaled sums).

Counterpart of ``da4ml_tpu/trace/ops/conv_utils.py``; the traces are the same.
"""

from __future__ import annotations

from math import ceil
from typing import TYPE_CHECKING

import numpy as np

from ..fixed_variable import FixedVariable

if TYPE_CHECKING:
    from ..fixed_variable_array import FixedVariableArray


def _fva():
    from ..fixed_variable_array import FixedVariableArray

    return FixedVariableArray


def _as_pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        a, b = v
        return int(a), int(b)
    return int(v), int(v)


def _pad_amounts(size: int, k: int, stride: int, dilation: int, padding: str) -> tuple[int, int]:
    keff = (k - 1) * dilation + 1
    if padding == 'valid':
        return 0, 0
    if padding == 'same':
        out = ceil(size / stride)
        total = max((out - 1) * stride + keff - size, 0)
        return total // 2, total - total // 2
    raise ValueError(f"padding must be 'valid' or 'same', got {padding!r}")


def _zero_like(x: FixedVariableArray) -> FixedVariable:
    proto = x._vars.ravel()[0]
    return FixedVariable(0.0, 0.0, 1.0, hwconf=proto.hwconf)


def _pad_spatial(x: FixedVariableArray, pads: list[tuple[int, int]]) -> np.ndarray:
    """Zero-pad the leading spatial axes of the object array (constant-zero
    variables; the solver zeroes their kernel columns)."""
    v = x._vars
    if all(p == (0, 0) for p in pads):
        return v
    zero = _zero_like(x)
    full_pads = pads + [(0, 0)] * (v.ndim - len(pads))
    return np.pad(v, full_pads, mode='constant', constant_values=zero)


def _patches_2d(
    x: FixedVariableArray,
    kh: int,
    kw: int,
    strides: tuple[int, int],
    dilation: tuple[int, int],
    padding: str,
) -> np.ndarray:
    """[H, W, C] -> object array [Ho, Wo, kh, kw, C] of receptive fields."""
    assert x.ndim == 3, f'conv2d/pool2d expects [H, W, C] input, got shape {x.shape}'
    H, W, _ = x.shape
    sh, sw = strides
    dh, dw = dilation
    ph = _pad_amounts(H, kh, sh, dh, padding)
    pw = _pad_amounts(W, kw, sw, dw, padding)
    v = _pad_spatial(x, [ph, pw])
    Hp, Wp = v.shape[0], v.shape[1]
    Ho = (Hp - (kh - 1) * dh - 1) // sh + 1
    Wo = (Wp - (kw - 1) * dw - 1) // sw + 1
    assert Ho > 0 and Wo > 0, f'kernel ({kh}x{kw}) larger than padded input ({Hp}x{Wp})'
    I = (np.arange(Ho) * sh)[:, None, None, None] + (np.arange(kh) * dh)[None, None, :, None]
    J = (np.arange(Wo) * sw)[None, :, None, None] + (np.arange(kw) * dw)[None, None, None, :]
    return v[I, J]  # [Ho, Wo, kh, kw, C]


def _patches_1d(x, k, stride, dilation, padding) -> np.ndarray:
    assert x.ndim == 2, f'conv1d/pool1d expects [L, C] input, got shape {x.shape}'
    L, _ = x.shape
    p = _pad_amounts(L, k, stride, dilation, padding)
    v = _pad_spatial(x, [p])
    Lp = v.shape[0]
    Lo = (Lp - (k - 1) * dilation - 1) // stride + 1
    assert Lo > 0, f'kernel ({k}) larger than padded input ({Lp})'
    I = (np.arange(Lo) * stride)[:, None, None] + (np.arange(k) * dilation)[None, :, None]
    return v[I]  # [Lo, k, C]


def conv2d(
    x: FixedVariableArray,
    kernel: np.ndarray,
    strides=(1, 1),
    padding: str = 'valid',
    dilation=(1, 1),
) -> FixedVariableArray:
    """2-d convolution: [H, W, Cin] * [kh, kw, Cin, Cout] -> [Ho, Wo, Cout]."""
    kernel = np.asarray(kernel, dtype=np.float64)
    assert kernel.ndim == 4, f'kernel must be [kh, kw, cin, cout], got shape {kernel.shape}'
    kh, kw, cin, cout = kernel.shape
    assert x.shape[-1] == cin, f'channel mismatch: input {x.shape[-1]}, kernel {cin}'
    P = _patches_2d(x, kh, kw, _as_pair(strides), _as_pair(dilation), padding)
    Ho, Wo = P.shape[0], P.shape[1]
    patches = _fva()(P.reshape(Ho * Wo, kh * kw * cin), x.solver_options, hwconf=x.hwconf)
    out = patches @ kernel.reshape(kh * kw * cin, cout)
    return out.reshape(Ho, Wo, cout)


def conv1d(
    x: FixedVariableArray,
    kernel: np.ndarray,
    stride: int = 1,
    padding: str = 'valid',
    dilation: int = 1,
) -> FixedVariableArray:
    """1-d convolution: [L, Cin] * [k, Cin, Cout] -> [Lo, Cout]."""
    kernel = np.asarray(kernel, dtype=np.float64)
    assert kernel.ndim == 3, f'kernel must be [k, cin, cout], got shape {kernel.shape}'
    k, cin, cout = kernel.shape
    assert x.shape[-1] == cin, f'channel mismatch: input {x.shape[-1]}, kernel {cin}'
    P = _patches_1d(x, k, int(stride), int(dilation), padding)
    Lo = P.shape[0]
    patches = _fva()(P.reshape(Lo, k * cin), x.solver_options, hwconf=x.hwconf)
    out = patches @ kernel.reshape(k * cin, cout)
    return out.reshape(Lo, cout)


def max_pool2d(x: FixedVariableArray, pool_size=(2, 2), strides=None, padding: str = 'valid') -> FixedVariableArray:
    """[H, W, C] -> [Ho, Wo, C] window maximum (msb_mux trees).

    'same' padding requires the true maximum, so padded windows reduce only
    over in-bounds elements (zeros from padding must not clamp negatives).
    """
    kh, kw = _as_pair(pool_size)
    strides = _as_pair(strides) if strides is not None else (kh, kw)
    if padding == 'same':
        return _pool2d_masked(x, kh, kw, strides, reduce_max=True)
    P = _patches_2d(x, kh, kw, strides, (1, 1), 'valid')
    Ho, Wo, _, _, C = P.shape
    arr = _fva()(P.reshape(Ho, Wo, kh * kw, C), x.solver_options, hwconf=x.hwconf)
    return np.amax(arr, axis=2)  # type: ignore[return-value]


def _pool2d_masked(x, kh, kw, strides, reduce_max: bool):
    """'same'-padded pooling reducing only over in-bounds window elements
    (matching Keras/TF: padding never clamps a max nor dilutes an average)."""
    from functools import reduce as _reduce

    H, W, C = x.shape
    sh, sw = strides
    ph = _pad_amounts(H, kh, sh, 1, 'same')
    pw = _pad_amounts(W, kw, sw, 1, 'same')
    v = x._vars
    Ho = ceil(H / sh)
    Wo = ceil(W / sw)
    out = np.empty((Ho, Wo, C), dtype=object)
    for ho in range(Ho):
        for wo in range(Wo):
            i0, j0 = ho * sh - ph[0], wo * sw - pw[0]
            els = [
                v[i, j]  # object array [C]
                for i in range(max(i0, 0), min(i0 + kh, H))
                for j in range(max(j0, 0), min(j0 + kw, W))
            ]
            for c in range(C):
                if reduce_max:
                    out[ho, wo, c] = _reduce(lambda a, b: a.max_of(b), [e[c] for e in els])
                else:
                    out[ho, wo, c] = _reduce(lambda a, b: a + b, [e[c] for e in els]) * (1.0 / len(els))
    return _fva()(out, x.solver_options, hwconf=x.hwconf)


def avg_pool2d(x: FixedVariableArray, pool_size=(2, 2), strides=None, padding: str = 'valid') -> FixedVariableArray:
    """[H, W, C] -> [Ho, Wo, C] window mean (sum scaled by 1/n; 'same'
    windows average only their in-bounds elements)."""
    kh, kw = _as_pair(pool_size)
    strides = _as_pair(strides) if strides is not None else (kh, kw)
    if padding == 'same':
        return _pool2d_masked(x, kh, kw, strides, reduce_max=False)
    P = _patches_2d(x, kh, kw, strides, (1, 1), padding)
    Ho, Wo, _, _, C = P.shape
    arr = _fva()(P.reshape(Ho, Wo, kh * kw, C), x.solver_options, hwconf=x.hwconf)
    return np.sum(arr, axis=2) * (1.0 / (kh * kw))  # type: ignore[return-value]


def _pool1d(x: FixedVariableArray, pool_size, strides, padding: str, reduce_max: bool) -> FixedVariableArray:
    """[L, C] 1-d pooling via the 2-d kernels on a width-1 spatial axis."""
    k = int(pool_size[0] if isinstance(pool_size, (tuple, list)) else pool_size)
    s = k if strides is None else int(strides[0] if isinstance(strides, (tuple, list)) else strides)
    v = _fva()(x._vars[:, None, :], x.solver_options, hwconf=x.hwconf)  # [L, 1, C]
    fn = max_pool2d if reduce_max else avg_pool2d
    out = fn(v, (k, 1), (s, 1), padding)
    return _fva()(out._vars[:, 0, :], x.solver_options, hwconf=x.hwconf)


def max_pool1d(x: FixedVariableArray, pool_size=2, strides=None, padding: str = 'valid') -> FixedVariableArray:
    """[L, C] -> [Lo, C] window maximum."""
    return _pool1d(x, pool_size, strides, padding, reduce_max=True)


def avg_pool1d(x: FixedVariableArray, pool_size=2, strides=None, padding: str = 'valid') -> FixedVariableArray:
    """[L, C] -> [Lo, C] window mean."""
    return _pool1d(x, pool_size, strides, padding, reduce_max=False)


def zero_pad(x: FixedVariableArray, pads: list[tuple[int, int]]) -> FixedVariableArray:
    """Pad the leading spatial axes with exact zeros; channels untouched.

    ``pads`` is [(before, after), ...] for the first len(pads) axes.
    """
    arr = _pad_spatial(x, list(pads))
    return _fva()(arr, x.solver_options, hwconf=x.hwconf)


def upsample_nearest(x: FixedVariableArray, size) -> FixedVariableArray:
    """Nearest-neighbor upsampling over the leading spatial axes: pure
    fan-out of existing variables (no new hardware ops)."""
    sizes = size if isinstance(size, (tuple, list)) else (size,)
    v = x._vars
    for ax, s in enumerate(sizes):
        v = np.repeat(v, int(s), axis=ax)
    return _fva()(v, x.solver_options, hwconf=x.hwconf)


def depthwise_conv1d(
    x: FixedVariableArray,
    kernel: np.ndarray,
    stride: int = 1,
    padding: str = 'valid',
    dilation: int = 1,
) -> FixedVariableArray:
    """Depthwise 1-d convolution: [L, C] * [k, C, M] -> [Lo, C*M].

    Lifted onto a width-1 spatial axis of the 2-d kernel (same pattern as
    ``_pool1d``)."""
    kernel = np.asarray(kernel, dtype=np.float64)
    assert kernel.ndim == 3, f'kernel must be [k, c, mult], got shape {kernel.shape}'
    v2 = _fva()(x._vars[:, None, :], x.solver_options, hwconf=x.hwconf)
    y = depthwise_conv2d(v2, kernel[:, None], strides=(int(stride), 1), padding=padding, dilation=(int(dilation), 1))
    return _fva()(y._vars[:, 0, :], x.solver_options, hwconf=x.hwconf)


def depthwise_conv2d(
    x: FixedVariableArray,
    kernel: np.ndarray,
    strides=(1, 1),
    padding: str = 'valid',
    dilation=(1, 1),
) -> FixedVariableArray:
    """Depthwise 2-d convolution: [H, W, C] * [kh, kw, C, M] -> [Ho, Wo, C*M].

    Each input channel convolves with its own [kh, kw, M] filter bank — one
    small CMVM per channel; output channel order matches Keras
    (c * depth_multiplier + m).
    """
    kernel = np.asarray(kernel, dtype=np.float64)
    assert kernel.ndim == 4, f'kernel must be [kh, kw, c, mult], got shape {kernel.shape}'
    kh, kw, cin, mult = kernel.shape
    assert x.shape[-1] == cin, f'channel mismatch: input {x.shape[-1]}, kernel {cin}'
    P = _patches_2d(x, kh, kw, _as_pair(strides), _as_pair(dilation), padding)  # [Ho, Wo, kh, kw, C]
    Ho, Wo = P.shape[0], P.shape[1]
    from ..fixed_variable_array import cmvm_multi

    # one batched solve across channels: every (channel, patch-metadata)
    # instance becomes a device lane on the torch backend. Fully-constant
    # channels (degenerate) short-circuit to a plain numeric matmul.
    jobs, job_cols, outs = [], [], [None] * cin
    for c in range(cin):
        k_c = kernel[:, :, c, :].reshape(kh * kw, mult)
        patches = _fva()(P[..., c].reshape(Ho * Wo, kh * kw), x.solver_options, hwconf=x.hwconf)
        if patches.collapsed:
            outs[c] = (patches @ k_c)._vars
        else:
            jobs.append((k_c, patches))
            job_cols.append(c)
    for c, rows in zip(job_cols, cmvm_multi(jobs, x.solver_options)):
        outs[c] = np.stack(rows, axis=0)
    stacked = np.stack(outs, axis=1)  # [Ho*Wo, C, M]
    return _fva()(stacked.reshape(Ho, Wo, cin * mult), x.solver_options, hwconf=x.hwconf)
