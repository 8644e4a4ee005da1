"""Lookup tables shared by the IR, interpreters and replay.

A table stores integer entries at a fixed output quantization (``out_qint``);
numeric lookup maps the input value to a table index via the input's
QInterval. Counterpart of ``da4ml_tpu/ir/lut.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from hashlib import sha256
from math import ceil, floor, log2

import numpy as np
from numpy.typing import NDArray

from .types import Precision, QInterval, minimal_kif


def lsb_loc(x: float) -> int:
    """Location of the least-significant set bit of a float (power-of-2 exponent).

    Returns 127 for zero (sentinel).
    """
    if x == 0.0:
        return 127
    x = abs(float(np.float32(x)))
    # m in [0.5, 1); x = m * 2**ex. Lowest set bit of m*2**24 gives lsb.
    m, ex = np.frexp(np.float64(x))
    mi = int(m * (1 << 24))
    tz = (mi & -mi).bit_length() - 1
    return int(ex - 24 + tz)


def interpret_as(x, k: int | bool, i: int, f: int):
    """Reinterpret integer value(s) ``x`` as fixed-point (k, i, f) with wrap."""
    b = int(k) + i + f
    bias = 2.0 ** (b - 1) * int(k)
    eps = 2.0**-f
    floor_fn = np.floor if isinstance(x, np.ndarray) else floor
    return eps * (floor_fn(x + bias) % 2.0**b - bias)


@dataclass
class TableSpec:
    hash: str
    out_qint: QInterval
    inp_width: int

    @property
    def out_kif(self) -> Precision:
        return minimal_kif(self.out_qint)


def table_spec(values: NDArray[np.floating]) -> tuple[TableSpec, NDArray[np.int32]]:
    """Quantize a float table to integers at its minimal fractional precision."""
    f_out = max(-lsb_loc(float(v)) for v in values.ravel())
    int_table = np.asarray(np.round(values * 2.0**f_out), dtype=np.int32)
    h = sha256(int_table.tobytes())
    h.update(f'{f_out}'.encode())
    out_qint = QInterval(float(np.min(values)), float(np.max(values)), float(2.0**-f_out))
    return TableSpec(hash=h.hexdigest(), out_qint=out_qint, inp_width=ceil(log2(values.size))), int_table


class LookupTable:
    """An integer-valued lookup table with fixed output quantization."""

    def __init__(self, values: NDArray, spec: TableSpec | None = None):
        assert values.ndim == 1, 'Lookup table values must be 1-dimensional'
        if spec is not None:
            assert values.dtype == np.int32
            self.spec, self.table = spec, values
        else:
            self.spec, self.table = table_spec(np.asarray(values, dtype=np.float64))

    def lookup(self, value, qint_in: QInterval | tuple[float, float, float]):
        """Numeric lookup: map a float value to its table entry (as float).

        Symbolic values (anything exposing ``.lookup``) are routed back to the
        tracer so the op lands in the graph.
        """
        if hasattr(value, 'lookup') and not isinstance(value, (float, int, np.floating, np.integer)):
            return value.lookup(self, original_qint=qint_in)
        lo, hi, step = qint_in
        assert lo <= value <= hi, f'Value {value} out of range [{lo}, {hi}]'
        index = round((value - lo) / step)
        k, i, f = self.spec.out_kif
        return interpret_as(int(self.table[index]), k, i, f)

    @property
    def float_table(self) -> NDArray[np.floating]:
        k, i, f = self.spec.out_kif
        return interpret_as(self.table, k, i, f)

    def pads(self, key_qint: QInterval) -> tuple[int, int]:
        """Left/right padding aligning the table to the key's binary index space."""
        k, i, f = minimal_kif(key_qint)
        if k:
            pad_left = round((key_qint.min + 2**i) / key_qint.step)
        else:
            pad_left = round(key_qint.min / key_qint.step)
        size = 2 ** (int(k) + i + f)
        return pad_left, size - len(self.table) - pad_left

    def padded_table(self, key_qint: QInterval) -> NDArray[np.float64]:
        """Table indexed directly by the key's raw binary representation.

        Unreachable entries are NaN; for signed keys the array is rolled so
        negative two's-complement codes index the upper half.
        """
        pad_left, pad_right = self.pads(key_qint)
        data = np.pad(self.table.astype(np.float64), (pad_left, pad_right), constant_values=np.nan)
        if key_qint.min < 0:
            data = np.roll(data, len(data) // 2)
        return data

    def to_dict(self) -> dict:
        return {
            'spec': {
                'hash': self.spec.hash,
                'out_qint': list(self.spec.out_qint),
                'inp_width': self.spec.inp_width,
            },
            'table': self.table.tolist(),
        }

    @classmethod
    def from_dict(cls, data: dict) -> 'LookupTable':
        sd = data['spec']
        qint = sd['out_qint']
        if isinstance(qint, dict):
            qint = [qint['min'], qint['max'], qint['step']]
        spec = TableSpec(hash=sd['hash'], out_qint=QInterval(*qint), inp_width=sd['inp_width'])
        return cls(np.array(data['table'], dtype=np.int32), spec=spec)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, LookupTable) and self.spec == other.spec and np.array_equal(self.table, other.table)
        )

    def __len__(self) -> int:
        return len(self.table)
