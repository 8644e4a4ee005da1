"""Dependency-level (ASAP) scheduling of DAIS SSA op lists.

A DAIS program is a static dataflow graph: every op depends only on earlier
slots, so ops at equal dependency depth are mutually independent and can
execute together. ``levelize`` assigns each op its ASAP level (inputs and
constants at level 0, every other op one past its deepest operand) and
returns a :class:`LevelSchedule` — a packed execution order in which each
level (optionally each (level, key) group) is a contiguous run.

Consumers in the port: the plain ``level`` lowering
(``runtime.torch_backend``) executes each (level, family) group as a few
vectorized torch ops, and the CUDA kernel (``runtime.cuda_backend``) walks the
same packed order op by op, assigning buffer slots by operand liveness.

Counterpart of ``da4ml_tpu/ir/schedule.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from numpy.typing import NDArray

#: opcodes whose id1 slot is a live dependency
USES_ID1 = frozenset((0, 1, 6, -6, 7, 10))


class LevelSchedule(NamedTuple):
    """ASAP schedule of an SSA op list.

    ``order`` is a permutation of op indices sorted by (level, sort_key,
    index); ``starts`` bounds each level within ``order`` so level ``l``
    occupies ``order[starts[l]:starts[l+1]]``.

    ``first_use`` / ``last_use`` carry per-slot operand liveness: the
    earliest / latest op index that *reads* slot ``i`` (-1 when no op reads
    it — dead code, or a slot only consumed by the program's outputs, which
    the runtime keeps live to the end regardless).
    """

    level: NDArray[np.int32]  # (n_ops,) dependency depth per op
    order: NDArray[np.int32]  # (n_ops,) packed execution order
    starts: NDArray[np.int64]  # (depth+1,) level boundaries within `order`
    first_use: NDArray[np.int32]  # (n_ops,) first consumer op index (-1: none)
    last_use: NDArray[np.int32]  # (n_ops,) last consumer op index (-1: none)

    @property
    def depth(self) -> int:
        """Number of levels (0 for an empty program)."""
        return len(self.starts) - 1

    def ops_at(self, lvl: int) -> NDArray[np.int32]:
        """Op indices (original numbering) scheduled at level ``lvl``."""
        return self.order[int(self.starts[lvl]) : int(self.starts[lvl + 1])]

    @property
    def width_max(self) -> int:
        return int(np.diff(self.starts).max()) if self.depth else 0

    @property
    def peak_live(self) -> int:
        """Peak operand-liveness window: the most slots simultaneously live
        across any level — slot ``i`` is live from its defining level through
        the level of its last consumer (its own level when never read)."""
        if not self.depth:
            return 0
        lvl = self.level.astype(np.int64)
        end = np.where(self.last_use >= 0, lvl[np.maximum(self.last_use, 0)], lvl)
        delta = np.zeros(self.depth + 1, dtype=np.int64)
        np.add.at(delta, lvl, 1)
        np.add.at(delta, end + 1, -1)
        return int(np.cumsum(delta[:-1]).max())


def operand_edges(opcode: NDArray, id0: NDArray, id1: NDArray, cond: NDArray) -> tuple[NDArray, NDArray]:
    """Every (reader op, operand slot) edge of an op list, as two int64
    arrays: id0 where the op reads a slot, id1 for the binary opcodes, and
    the mux condition slot."""
    oc = np.asarray(opcode, dtype=np.int64)
    uses0 = (oc != -1) & (oc != 5)
    uses1 = np.isin(oc, tuple(USES_ID1))
    usesc = np.abs(oc) == 6
    readers = np.concatenate([np.flatnonzero(uses0), np.flatnonzero(uses1), np.flatnonzero(usesc)])
    operands = np.concatenate(
        [
            np.asarray(id0, dtype=np.int64)[uses0],
            np.asarray(id1, dtype=np.int64)[uses1],
            np.asarray(cond, dtype=np.int64)[usesc],
        ]
    )
    return readers, operands


def levelize(opcode: NDArray, id0: NDArray, id1: NDArray, cond: NDArray, sort_key: NDArray | None = None) -> LevelSchedule:
    """Compute the ASAP level schedule of an SSA op list.

    ``cond`` carries the MSB-mux condition slot per op (only read where
    ``|opcode| == 6``); ``sort_key`` orders ops *within* a level (the runtime
    passes the opcode family so each (level, family) group is contiguous in
    ``order``). Causality (deps < op index) is assumed, as guaranteed by
    ``DaisProgram.validate``.
    """
    n = len(opcode)
    oc = np.asarray(opcode, dtype=np.int64)
    # plain-int lists: much faster than scalar ndarray indexing in the loop
    u0 = ((oc != -1) & (oc != 5)).tolist()
    u1 = np.isin(oc, tuple(USES_ID1)).tolist()
    uc = (np.abs(oc) == 6).tolist()
    d0 = np.asarray(id0, dtype=np.int64).tolist()
    d1 = np.asarray(id1, dtype=np.int64).tolist()
    dc = np.asarray(cond, dtype=np.int64).tolist()

    lvl: list[int] = [0] * n
    for i in range(n):
        m = -1
        if u0[i]:
            m = lvl[d0[i]]
        if u1[i]:
            m = max(m, lvl[d1[i]])
        if uc[i]:
            m = max(m, lvl[dc[i]])
        lvl[i] = m + 1

    level = np.asarray(lvl, dtype=np.int32)
    if sort_key is not None:
        order = np.lexsort((np.arange(n), np.asarray(sort_key), level)).astype(np.int32)
    else:
        order = np.argsort(level, kind='stable').astype(np.int32)
    depth = int(level.max()) + 1 if n else 0
    counts = np.bincount(level, minlength=depth) if n else np.zeros(0, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    readers, operands = operand_edges(opcode, id0, id1, cond)
    first_use = np.full(n, n, dtype=np.int64)
    last_use = np.full(n, -1, dtype=np.int64)
    if len(operands):
        np.minimum.at(first_use, operands, readers)
        np.maximum.at(last_use, operands, readers)
    first_use[first_use == n] = -1
    return LevelSchedule(
        level=level,
        order=order,
        starts=starts,
        first_use=first_use.astype(np.int32),
        last_use=last_use.astype(np.int32),
    )


def levelize_program(prog, sort_key: NDArray | None = None) -> LevelSchedule:
    """Level schedule of a decoded :class:`~.dais_binary.DaisProgram`."""
    return levelize(prog.opcode, prog.id0, prog.id1, cond=prog.data_lo, sort_key=sort_key)


def levelize_comb(comb) -> LevelSchedule:
    """Level schedule of a :class:`~.comb.CombLogic` op list (the mux
    condition slot lives in the low half of ``op.data``)."""
    ops = comb.ops
    opcode = np.fromiter((op.opcode for op in ops), dtype=np.int64, count=len(ops))
    id0 = np.fromiter((op.id0 for op in ops), dtype=np.int64, count=len(ops))
    id1 = np.fromiter((op.id1 for op in ops), dtype=np.int64, count=len(ops))
    cond = np.fromiter(
        ((op.data & 0xFFFFFFFF) if abs(op.opcode) == 6 else 0 for op in ops), dtype=np.int64, count=len(ops)
    )
    return levelize(opcode, id0, id1, cond=cond)
