"""Decoder for the flat int32 DAIS v1 binary stream.

Layout: header [spec_ver, fw_ver, n_in, n_out, n_ops, n_tables], then
inp_shifts, out_idxs, out_shifts, out_negs, then n_ops×8 int32 op records
[opcode, id0, id1, data_lo, data_hi, signed, integers, fractionals], then
table sizes and table data. The stream is the one ``da4ml_tpu``'s
``CombLogic.to_binary`` writes, so a program carries across unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from numpy.typing import NDArray

DAIS_SPEC_VERSION = 1


class DaisProgram(NamedTuple):
    """A decoded DAIS program in struct-of-arrays form (interpreter-friendly)."""

    n_in: int
    n_out: int
    inp_shifts: NDArray[np.int32]  # (n_in,)
    out_idxs: NDArray[np.int32]  # (n_out,)
    out_shifts: NDArray[np.int32]  # (n_out,)
    out_negs: NDArray[np.int32]  # (n_out,)
    opcode: NDArray[np.int32]  # (n_ops,)
    id0: NDArray[np.int32]
    id1: NDArray[np.int32]
    data_lo: NDArray[np.int32]
    data_hi: NDArray[np.int32]
    signed: NDArray[np.int32]
    integers: NDArray[np.int32]
    fractionals: NDArray[np.int32]
    tables: tuple[NDArray[np.int32], ...]

    @property
    def n_ops(self) -> int:
        return len(self.opcode)

    @property
    def width(self) -> NDArray[np.int32]:
        return self.signed + self.integers + self.fractionals

    @property
    def max_width(self) -> int:
        return int(self.width.max()) if self.n_ops else 0

    def validate(self) -> None:
        idx = np.arange(self.n_ops)
        bad0 = (self.id0 >= idx) & (self.opcode != -1)
        if bad0.any():
            raise ValueError(f'Causality violation on id0 at op {int(np.argmax(bad0))}')
        if (self.id1 >= idx).any():
            raise ValueError(f'Causality violation on id1 at op {int(np.argmax(self.id1 >= idx))}')
        mux = np.abs(self.opcode) == 6
        if (mux & (self.data_lo >= idx)).any():
            raise ValueError('Causality violation on mux condition index')


def encode(prog: DaisProgram, version: int = 0) -> NDArray[np.int32]:
    """Serialize a decoded program back to the flat int32 DAIS v1 stream
    (exact inverse of :func:`decode` up to the firmware-version word)."""
    parts = [
        np.asarray([DAIS_SPEC_VERSION, version, prog.n_in, prog.n_out, prog.n_ops, len(prog.tables)]),
        prog.inp_shifts,
        prog.out_idxs,
        prog.out_shifts,
        prog.out_negs,
        np.stack(
            [
                prog.opcode,
                prog.id0,
                prog.id1,
                prog.data_lo,
                prog.data_hi,
                prog.signed,
                prog.integers,
                prog.fractionals,
            ],
            axis=1,
        ).reshape(-1)
        if prog.n_ops
        else np.empty(0, np.int32),
    ]
    if prog.tables:
        parts.append(np.asarray([len(t) for t in prog.tables]))
        parts.extend(prog.tables)
    return np.concatenate([np.asarray(p, dtype=np.int32) for p in parts], dtype=np.int32)


def decode(binary: NDArray[np.int32]) -> DaisProgram:
    binary = np.asarray(binary, dtype=np.int32)
    if binary.size < 6:
        raise ValueError('Binary data too small to contain a DAIS program')
    if binary[0] != DAIS_SPEC_VERSION:
        raise ValueError(f'DAIS version mismatch: expected {DAIS_SPEC_VERSION}, got {int(binary[0])}')
    n_in, n_out, n_ops, n_tables = (int(v) for v in binary[2:6])
    off = 6
    inp_shifts = binary[off : off + n_in]
    off += n_in
    out_idxs = binary[off : off + n_out]
    off += n_out
    out_shifts = binary[off : off + n_out]
    off += n_out
    out_negs = binary[off : off + n_out]
    off += n_out
    code = binary[off : off + 8 * n_ops].reshape(n_ops, 8)
    off += 8 * n_ops

    tables = []
    if n_tables:
        sizes = binary[off : off + n_tables]
        off += n_tables
        for s in sizes:
            tables.append(binary[off : off + int(s)].copy())
            off += int(s)
    if off != binary.size:
        raise ValueError(f'Binary size mismatch: consumed {off} of {binary.size} int32 words')

    return DaisProgram(
        n_in=n_in,
        n_out=n_out,
        inp_shifts=inp_shifts.copy(),
        out_idxs=out_idxs.copy(),
        out_shifts=out_shifts.copy(),
        out_negs=out_negs.copy(),
        opcode=code[:, 0].copy(),
        id0=code[:, 1].copy(),
        id1=code[:, 2].copy(),
        data_lo=code[:, 3].copy(),
        data_hi=code[:, 4].copy(),
        signed=code[:, 5].copy(),
        integers=code[:, 6].copy(),
        fractionals=code[:, 7].copy(),
        tables=tuple(tables),
    )
