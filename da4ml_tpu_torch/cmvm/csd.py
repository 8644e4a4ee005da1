"""Canonical Signed Digit (CSD) decomposition of constant matrices.

CSD rewrites each integer as a minimal set of ±2^n terms; the number of
non-zero digits equals the adders needed without sharing, so all solver cost
metrics start here.

Behavioral parity: reference src/da4ml/_binary/cmvm/bit_decompose.{hh,cc}.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray



def int_arr_to_csd(x: NDArray) -> NDArray[np.int8]:
    """CSD-decompose an integer array along a new trailing bit axis.

    Returns int8 digits in {-1, 0, 1} with ``(digits * 2**arange(N)).sum(-1) == x``.
    Digit selection threshold per bit plane is 2/3·2^n (bit_decompose.cc:22-42).
    """
    x = np.array(x, dtype=np.int64)
    max_val = int(np.abs(x).max()) if x.size else 0
    n = max(int(np.ceil(np.log2(max(max_val, 1) * 1.5))), 1)
    out = np.zeros(x.shape + (n,), dtype=np.int8)
    for b in range(n - 1, -1, -1):
        p = np.int64(1) << b
        thres = p * 2 // 3
        digit = (x > thres).astype(np.int8) - (x < -thres).astype(np.int8)
        out[..., b] = digit
        x = x - p * digit.astype(np.int64)
    return out


def lsb_loc_arr(x: NDArray) -> NDArray[np.int8]:
    """Vectorized lsb_loc: exponent of the lowest set bit of each float32 value."""
    x32 = np.abs(np.asarray(x, dtype=np.float32)).astype(np.float64)
    m, ex = np.frexp(x32)
    mi = (m * (1 << 24)).astype(np.int64)
    tz = np.zeros_like(mi)
    nz = mi != 0
    low = mi[nz] & -mi[nz]
    # bit_length - 1 via float log2 is exact for powers of two < 2**53
    tz[nz] = np.log2(low.astype(np.float64)).astype(np.int64)
    out = (ex - 24 + tz).astype(np.int8)
    out[~nz] = 127  # zero sentinel
    return out


def shift_amount(arr: NDArray, axis: int) -> NDArray[np.int8]:
    """Per-row/col min power-of-2 exponent (for factoring out shifts)."""
    return lsb_loc_arr(arr).min(axis=axis).astype(np.int8)


def center(arr: NDArray) -> tuple[NDArray, NDArray[np.int8], NDArray[np.int8]]:
    """Factor out per-column then per-row power-of-2 shifts so entries are odd ints.

    Returns (centered, shift0[rows], shift1[cols]) with
    ``arr == centered * 2**shift0[:, None] * 2**shift1[None, :]``.
    Parity: reference bit_decompose.hh:25-34 (``_center``).
    """
    arr = np.array(arr, dtype=np.float64)
    assert arr.ndim == 2, 'center only supports 2D arrays'
    shift1 = shift_amount(arr, axis=0)
    arr = arr * 2.0 ** (-shift1.astype(np.float64))
    shift0 = shift_amount(arr, axis=1)
    arr = arr * 2.0 ** (-shift0.astype(np.float64))[:, None]
    return arr, shift0, shift1


def csd_decompose(arr: NDArray, do_center: bool = True) -> tuple[NDArray[np.int8], NDArray[np.int8], NDArray[np.int8]]:
    """(csd[in, out, bit], shift0[in], shift1[out]) for a 2D constant matrix."""
    arr = np.array(arr, dtype=np.float64)
    assert arr.ndim == 2, 'csd_decompose only supports 2D arrays'
    if do_center:
        arr, shift0, shift1 = center(arr)
    else:
        shift0 = np.zeros(arr.shape[0], dtype=np.int8)
        shift1 = np.zeros(arr.shape[1], dtype=np.int8)
    return int_arr_to_csd(np.round(arr).astype(np.int64)), shift0, shift1
