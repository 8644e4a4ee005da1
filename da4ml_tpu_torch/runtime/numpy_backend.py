"""Batch-vectorized NumPy interpreter for DAIS programs.

Executes the op list over an int64 buffer of shape (batch, n_ops), one column
per SSA slot — the whole batch advances through each op at once, so the
throughput axis is the sample batch (the reference parallelizes the same axis
with OpenMP threads, dais/bindings.cc:58-96).

Integer semantics are bit-exact with the reference C++ interpreter
(src/da4ml/_binary/dais/DAISInterpreter.cc): two's-complement int64,
arithmetic shifts, modular wrap.

Counterpart of ``da4ml_tpu/runtime/numpy_backend.py``; ``run_comb``'s
``'numpy'`` backend. The table-driven ``reference`` interpreter stays the
oracle it is held to.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray

from ..ir.dais_binary import DaisProgram, decode


def _shl(v: NDArray, s: int) -> NDArray:
    """Shift left by s (arithmetic right shift for negative s)."""
    return v << s if s >= 0 else v >> (-s)


def _wrap(v: NDArray, signed: int, width: int) -> NDArray:
    """Two's-complement wrap of v into `width` bits (DAISInterpreter.cc:139-152)."""
    mod = np.int64(1) << width
    int_min = -(np.int64(1) << (width - 1)) if signed else np.int64(0)
    return ((v - int_min) % mod) + int_min


def _quantize(v: NDArray, f_from: int, signed_to: int, width_to: int, f_to: int) -> NDArray:
    shift = f_from - f_to
    v = _shl(v, -shift)
    return _wrap(v, signed_to, width_to)


def _msb(v: NDArray, signed: int, width: int) -> NDArray:
    """MSB of the two's-complement representation.

    signed: sign bit set <=> v < 0; unsigned: top bit set <=> v >= 2**(w-1).
    (The reference C++ uses ``v > 1 << (w-2)``, DAISInterpreter.cc:177-181,
    which is UB for w == 1 and misclassifies part of the unsigned range; this
    implementation matches the IR replay semantics, comb.py opcode 6.)
    """
    if signed:
        return v < 0
    return v >= (np.int64(1) << (width - 1))


def run_program(prog: DaisProgram, data: NDArray[np.float64], return_buf: bool = False):
    """Run a decoded DAIS program over a (n_samples, n_in) float batch.

    ``return_buf`` additionally returns the (n_ops, n_samples) int64
    execution buffer (the conformance checker compares it slot-by-slot
    against the table-generated reference interpreter's)."""
    prog.validate()
    data = np.asarray(data, dtype=np.float64).reshape(len(data), -1)
    if data.shape[1] != prog.n_in:
        raise ValueError(f'Input size mismatch: expected {prog.n_in}, got {data.shape[1]}')
    n = data.shape[0]
    buf = np.zeros((prog.n_ops, n), dtype=np.int64)
    width = prog.width

    for i in range(prog.n_ops):
        oc = int(prog.opcode[i])
        i0, i1 = int(prog.id0[i]), int(prog.id1[i])
        dlo, dhi = int(prog.data_lo[i]), int(prog.data_hi[i])
        sg, f = int(prog.signed[i]), int(prog.fractionals[i])
        w = int(width[i])

        if oc == -1:
            v = np.floor(data[:, i0] * 2.0 ** (int(prog.inp_shifts[i0]) + f)).astype(np.int64)
            buf[i] = _wrap(v, sg, w)
        elif oc in (0, 1):
            f0, f1 = int(prog.fractionals[i0]), int(prog.fractionals[i1])
            actual_shift = dlo + f0 - f1
            v1 = buf[i0]
            v2 = -buf[i1] if oc == 1 else buf[i1]
            if actual_shift > 0:
                r = v1 + (v2 << actual_shift)
            else:
                r = (v1 << -actual_shift) + v2
            global_shift = max(f0, f1 - dlo) - f
            if global_shift > 0:
                r = r >> global_shift
            buf[i] = r
        elif oc in (2, -2):
            v = -buf[i0] if oc == -2 else buf[i0]
            q = _quantize(v, int(prog.fractionals[i0]), sg, w, f)
            buf[i] = np.where(v < 0, 0, q)
        elif oc in (3, -3):
            v = -buf[i0] if oc == -3 else buf[i0]
            buf[i] = _quantize(v, int(prog.fractionals[i0]), sg, w, f)
        elif oc == 4:
            shift = f - int(prog.fractionals[i0])
            const = (np.int64(dhi) << 32) | np.int64(dlo & 0xFFFFFFFF)
            buf[i] = _shl(buf[i0], shift) + const
        elif oc == 5:
            buf[i] = (np.int64(dhi) << 32) | np.int64(dlo & 0xFFFFFFFF)
        elif oc in (6, -6):
            ic = dlo
            f0, f1 = int(prog.fractionals[i0]), int(prog.fractionals[i1])
            shift1 = f - f1 + dhi
            shift0 = f - f0
            if shift1 != 0 and shift0 != 0:
                raise ValueError(f'Unsupported msb_mux shifts: shift0={shift0}, shift1={shift1}')
            cond = _msb(buf[ic], int(prog.signed[ic]), int(width[ic]))
            v1 = -buf[i1] if oc == -6 else buf[i1]
            # branch values are shifted to the output fractional position, then wrapped
            r0 = _wrap(_shl(buf[i0], shift0), sg, w)
            r1 = _wrap(_shl(v1, shift1), sg, w)
            buf[i] = np.where(cond, r0, r1)
        elif oc == 7:
            buf[i] = buf[i0] * buf[i1]
        elif oc == 8:
            table = prog.tables[dlo & 0xFFFFFFFF] if dlo >= 0 else None
            assert table is not None
            sg0, w0 = int(prog.signed[i0]), int(width[i0])
            zero = -sg0 * (np.int64(1) << (w0 - 1))
            index = buf[i0] - zero - dhi
            if (index < 0).any() or (index >= len(table)).any():
                raise ValueError('Logic lookup index out of bounds')
            buf[i] = table[index].astype(np.int64)
        elif oc in (9, -9):
            v = -buf[i0] if oc == -9 else buf[i0]
            mask = (np.int64(1) << int(width[i0])) - 1
            if dlo == 0:
                buf[i] = ~v if sg else (~v) & mask
            elif dlo == 1:
                buf[i] = (v != 0).astype(np.int64)
            elif dlo == 2:
                buf[i] = ((v & mask) == mask).astype(np.int64)
            else:
                raise ValueError(f'Unknown bit unary op data={dlo}')
        elif oc == 10:
            f0, f1 = int(prog.fractionals[i0]), int(prog.fractionals[i1])
            actual_shift = dlo + f0 - f1
            v1, v2 = buf[i0], buf[i1]
            if dhi & 1:
                v1 = -v1
            if dhi & 2:
                v2 = -v2
            if actual_shift > 0:
                v2 = v2 << actual_shift
            else:
                v1 = v1 << -actual_shift
            subop = dhi >> 24
            if subop == 0:
                buf[i] = v1 & v2
            elif subop == 1:
                buf[i] = v1 | v2
            elif subop == 2:
                buf[i] = v1 ^ v2
            else:
                raise ValueError(f'Unknown bit binary op {subop}')
        else:
            raise ValueError(f'Unknown opcode {oc} at index {i}')

    out = np.zeros((n, prog.n_out), dtype=np.float64)
    for j in range(prog.n_out):
        idx = int(prog.out_idxs[j])
        if idx < 0:
            continue
        v = buf[idx]
        if prog.out_negs[j]:
            v = -v
        out[:, j] = v.astype(np.float64) * 2.0 ** (int(prog.out_shifts[j]) - int(prog.fractionals[idx]))
    if return_buf:
        return out, buf
    return out


def run_binary(binary: NDArray[np.int32], data: NDArray[np.float64]) -> NDArray[np.float64]:
    return run_program(decode(binary), data)


__all__ = ['run_program', 'run_binary']
