"""Table-generated reference interpreter for DAIS programs — the port's oracle.

The execution loop owns only input scaling, the int64 execution buffer and
output read-out; every op executes through its opcode-table row's ``kernel``
(``ir/optable.py``). It is the slowest and most direct expression of the
DAIS v1 semantics, and the torch executor and the CUDA kernel are held
against it bit for bit. Counterpart of ``da4ml_tpu/runtime/reference.py``.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray

from ..ir.dais_binary import DaisProgram, decode
from ..ir.optable import OPCODE_TO_SPEC, RefState


def run_program(
    prog: DaisProgram, data: NDArray[np.float64], return_buf: bool = False
) -> NDArray[np.float64] | tuple[NDArray[np.float64], NDArray[np.int64]]:
    """Run a decoded DAIS program over a (n_samples, n_in) float batch.

    ``return_buf`` additionally returns the full (n_ops, n_samples) int64
    execution buffer.
    """
    prog.validate()
    data = np.asarray(data, dtype=np.float64).reshape(len(data), -1)
    if data.shape[1] != prog.n_in:
        raise ValueError(f'Input size mismatch: expected {prog.n_in}, got {data.shape[1]}')
    st = RefState(prog, data)

    for i in range(prog.n_ops):
        oc = int(prog.opcode[i])
        spec = OPCODE_TO_SPEC.get(oc)
        if spec is None:
            raise ValueError(f'Unknown opcode {oc} at index {i}')
        st.buf[i] = spec.kernel(st, i)

    n = data.shape[0]
    out = np.zeros((n, prog.n_out), dtype=np.float64)
    for j in range(prog.n_out):
        idx = int(prog.out_idxs[j])
        if idx < 0:
            continue
        v = st.buf[idx]
        if prog.out_negs[j]:
            v = -v
        out[:, j] = v.astype(np.float64) * 2.0 ** (int(prog.out_shifts[j]) - int(prog.fractionals[idx]))
    if return_buf:
        return out, st.buf
    return out


def run_binary(binary: NDArray[np.int32], data: NDArray[np.float64]) -> NDArray[np.float64]:
    return run_program(decode(binary), data)


__all__ = ['run_program', 'run_binary']
