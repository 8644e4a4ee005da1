"""Cross-stage pipeline fusion: one level-packed DAIS program per model.

:func:`fuse_pipeline` merges a :class:`~.comb.Pipeline`'s register-separated
stages into ONE well-formed :class:`~.comb.CombLogic`. The runtime's chained
path (``runtime.torch_backend.PipelineExecutor``) relies on stage boundary
``j`` being exactly an arithmetic shift of the previous stage's output code:

    s[j] = out_shift_prev[j] - f_prev[out_idx_j] + inp_shift_next[j] + f_next[j]

Fusion makes that seam explicit at the IR level instead of leaving it to a
runtime boundary kernel. Each next-stage input-copy op is lowered to:

- nothing, when the copy is a bit-identical pass-through (same fixed-point
  container, no boundary scaling) — the consumer is re-pointed at the
  producing slot directly;
- a single ``quantize`` op (``±3``) into the copy's container, when only the
  fractional bookkeeping changes — its arithmetic-shift-then-wrap semantics
  are exactly the chained boundary's floor-then-wrap;
- a ``const 0`` + ``add`` pair first, when the boundary carries a net
  power-of-two *value* scaling (``out_shift + inp_shift != 0``): quantize
  preserves value, so the scaling is expressed as ``0 + src * 2**t`` with an
  exactly-scaled annotation, then quantized into the copy's container.

SSA ids are re-based stage by stage, mux condition slots (packed in ``data``)
and lookup-table indices are remapped, and the merged program flows through
``ir.schedule`` levelization unchanged — formerly-separate stages' ops pack
into shared (level, family) groups, so the DAIS kernel runs the whole model
as one program, with no boundary shift between launches.

:func:`fuse_binaries` is the runtime entry point: it reconstructs
container-typed stage programs from DAIS binaries (``comb_from_program``) and
re-encodes the fused result, so ``run_pipeline(..., fused='ir')`` can fuse
without the traced IR in hand.

Counterpart of ``da4ml_tpu/ir/fuse.py``: the same fused binaries, byte for
byte, and the same :class:`FusionReport`; what the reference records as
telemetry spans and counters is logged here.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Sequence

import numpy as np
from numpy.typing import NDArray

from .comb import CombLogic, Pipeline
from .dais_binary import DaisProgram, decode
from .optable import OP_TABLE, OPCODE_TO_SPEC, i32
from .schedule import levelize_comb
from .types import Op, QInterval, minimal_kif, qint_add

_logger = logging.getLogger(__name__)

# fusion coverage audit: the rebase
# logic below is driven by the declarative opcode table's operand-kind fields,
# so an opcode is fusable exactly when its row uses the structures the table
# defines today. A new row with an unknown id0 kind would silently mis-rebase;
# fail at import instead.
_ID0_KINDS = ('slot', 'lane', 'none')
_unfusable = sorted(spec.key for spec in OP_TABLE if spec.id0 not in _ID0_KINDS)
if _unfusable:
    raise RuntimeError(
        f'ir.fuse cannot rebase opcode-table rows {_unfusable}: unknown id0 kind; '
        f'teach fuse_pipeline about the new operand structure before shipping the opcode'
    )

#: every opcode the fuse pass can carry across a stage boundary
FUSABLE_OPCODES = frozenset(oc for spec in OP_TABLE if spec.id0 in _ID0_KINDS for oc in spec.opcodes)


class FusionReport(NamedTuple):
    """What fusion did to one pipeline."""

    stages: int
    ops_before: int
    ops_after: int
    seam_ops: int
    depth_before: int  # sum of per-stage level-schedule depths (chained critical path)
    depth_after: int  # fused level-schedule depth


def _zero_slot(ops: list[Op], zero_cache: dict[float, int], step: float) -> int:
    """Slot of a shared ``const 0`` at the given step, emitting it on first use.

    Constants sit at latency 0.0: they have no operands, so the monotone
    check never constrains them from below, and seam adds of *different*
    boundary latencies can share one zero without tripping D303."""
    slot = zero_cache.get(step)
    if slot is None:
        ops.append(Op(-1, -1, 5, 0, QInterval(0.0, 0.0, step), 0.0, 0.0))
        zero_cache[step] = slot = len(ops) - 1
    return slot


def _lower_seam(
    ops: list[Op],
    zero_cache: dict[float, int],
    src_slot: int,
    q_copy: QInterval,
    t: int,
    neg: bool,
    latency: float,
) -> tuple[int, int]:
    """Lower one stage-boundary lane to explicit ops.

    ``src_slot`` holds the previous stage's output code; the staged runtime
    would scale it by ``2**t`` (out_shift + inp_shift), negate it if ``neg``,
    then floor-and-wrap into the copy's container ``q_copy``. Seam ops carry
    the replaced copy op's ``latency`` (the register-boundary time), keeping
    the fused program latency-monotone. Returns the fused slot carrying the
    copy's value and how many seam ops were emitted.
    """
    q_src = ops[src_slot].qint
    if t == 0 and not neg and minimal_kif(q_copy) == minimal_kif(q_src):
        return src_slot, 0  # bit-identical pass-through: re-point the consumers
    n_before = len(ops)
    if t != 0:
        # value scaling: 0 + src * 2**t with an exactly-scaled annotation —
        # the kernel's operand alignment is a no-op (same integer code, new
        # fractional bookkeeping), so no precision is created or lost here
        step_z = q_src.step * 2.0**t
        z = _zero_slot(ops, zero_cache, step_z)
        q_add = qint_add(QInterval(0.0, 0.0, step_z), q_src, t, False, False)
        ops.append(Op(z, src_slot, 0, t, q_add, latency, 0.0))
        src_slot = len(ops) - 1
    # floor + modular wrap into the copy's container: exactly the chained
    # boundary's arithmetic shift followed by the next stage's input cast
    ops.append(Op(src_slot, -1, -3 if neg else 3, 0, q_copy, latency, 0.0))
    return len(ops) - 1, len(ops) - n_before


def _lower_dead_lane(ops: list[Op], zero_cache: dict[float, int], q_copy: QInterval, latency: float) -> tuple[int, int]:
    """A dead previous-stage output lane feeds this copy: the value is 0."""
    z = _zero_slot(ops, zero_cache, q_copy.step)
    ops.append(Op(z, -1, 3, 0, q_copy, latency, 0.0))
    return len(ops) - 1, 2


def fuse_pipeline(pipe: Pipeline, report: bool = False) -> CombLogic | tuple[CombLogic, FusionReport]:
    """Merge every stage of ``pipe`` into one well-formed CombLogic.

    Bit-exact with the staged execution on every backend: the fused program's
    seam ops reproduce the chained runtime's boundary arithmetic op for op.
    With ``report=True`` also returns the :class:`FusionReport`.
    """
    stages = pipe.stages
    if not stages:
        raise ValueError('cannot fuse an empty pipeline')
    fused, rep = _fuse_impl(stages)
    _logger.debug('fused %d stages: %d -> %d ops (%d seam ops), depth %d -> %d', rep.stages, rep.ops_before,
                  rep.ops_after, rep.seam_ops, rep.depth_before, rep.depth_after)  # fmt: skip
    return (fused, rep) if report else fused


def _fuse_impl(stages: Sequence[CombLogic]) -> tuple[CombLogic, FusionReport]:
    fused_ops: list[Op] = []
    fused_tables: list = []
    seam_ops = 0
    prev_map: list[int] = []
    prev_stage: CombLogic | None = None

    for si, st in enumerate(stages):
        table_off = len(fused_tables)
        if st.lookup_tables:
            fused_tables.extend(st.lookup_tables)
        cur_map: list[int] = []
        zero_cache: dict[float, int] = {}
        for op in st.ops:
            if op.opcode == -1:
                if si == 0:
                    fused_ops.append(op)  # external input: stays a copy op
                    cur_map.append(len(fused_ops) - 1)
                    continue
                assert prev_stage is not None
                lane = int(op.id0)
                src_idx = int(prev_stage.out_idxs[lane])
                t = int(prev_stage.out_shifts[lane]) + int(st.inp_shifts[lane])
                neg = bool(prev_stage.out_negs[lane])
                if src_idx < 0:
                    slot, n = _lower_dead_lane(fused_ops, zero_cache, op.qint, op.latency)
                else:
                    slot, n = _lower_seam(fused_ops, zero_cache, prev_map[src_idx], op.qint, t, neg, op.latency)
                seam_ops += n
                cur_map.append(slot)
                continue
            spec = OPCODE_TO_SPEC.get(op.opcode)
            if spec is None or op.opcode not in FUSABLE_OPCODES:
                raise ValueError(f'cannot fuse unknown opcode {op.opcode} in stage {si}')
            id0 = cur_map[op.id0] if spec.id0 == 'slot' else op.id0
            id1 = cur_map[op.id1] if spec.reads_id1 else op.id1
            data = op.data
            if spec.cond_in_data:
                data = (i32(int(data) >> 32) << 32) | cur_map[int(data) & 0xFFFFFFFF]
            elif spec.key == 'lookup':
                data = int(data) + table_off
            fused_ops.append(op._replace(id0=id0, id1=id1, data=data))
            cur_map.append(len(fused_ops) - 1)
        prev_map, prev_stage = cur_map, st

    last = stages[-1]
    fused = CombLogic(
        shape=(stages[0].shape[0], last.shape[1]),
        inp_shifts=list(stages[0].inp_shifts),
        out_idxs=[prev_map[int(i)] if int(i) >= 0 else -1 for i in last.out_idxs],
        out_shifts=list(last.out_shifts),
        out_negs=list(last.out_negs),
        ops=fused_ops,
        carry_size=stages[0].carry_size,
        adder_size=stages[0].adder_size,
        lookup_tables=tuple(fused_tables) if fused_tables else None,
    )
    rep = FusionReport(
        stages=len(stages),
        ops_before=sum(len(st.ops) for st in stages),
        ops_after=len(fused_ops),
        seam_ops=seam_ops,
        depth_before=_chained_depth(stages),
        depth_after=_fused_depth(fused),
    )
    return fused, rep


def _chained_depth(stages: Sequence[CombLogic]) -> int:
    return int(sum(levelize_comb(st).depth for st in stages))


def _fused_depth(comb: CombLogic) -> int:
    return int(levelize_comb(comb).depth)


# ---------------------------------------------------------------------------
# binary-level entry points: reconstruct container-typed stage CombLogics
# from DAIS binaries so the runtime / serve plane can fuse without the
# traced IR (only opcode + operand + container fields matter for bit-exact
# integer execution; latency/cost metadata is not stored in the binary).
# ---------------------------------------------------------------------------


def _container_qint(signed: int, integers: int, fractionals: int) -> QInterval:
    """Full representable interval of a (signed, integers, fractionals) slot."""
    if not signed and integers + fractionals <= 0:
        return QInterval(0.0, 0.0, 1.0)
    step = 2.0 ** -int(fractionals)
    hi = 2.0 ** int(integers) - step
    lo = -(2.0 ** int(integers)) if signed else 0.0
    return QInterval(lo, hi, step)


class _RawTable:
    """Stand-in for :class:`~.lut.LookupTable` carrying only what
    ``CombLogic.to_binary`` reads: the int table and its precomputed pad."""

    __slots__ = ('table', '_pad_left')

    def __init__(self, table: NDArray[np.int32], pad_left: int):
        self.table = np.asarray(table, dtype=np.int32)
        self._pad_left = int(pad_left)

    def pads(self, qint: QInterval) -> tuple[int, int]:
        return self._pad_left, 0


def comb_from_program(prog: DaisProgram) -> CombLogic:
    """Container-typed CombLogic view of a decoded DAIS binary.

    The reconstructed qints are the slots' full representable containers, so
    re-encoding via ``to_binary`` reproduces the original (signed, integers,
    fractionals) fields exactly — integer semantics are preserved bit for
    bit. Lookup tables keep their encoded ``pad_left``, deduplicated per
    (table, pad) pair since the pad is a property of the referencing op's
    operand container.
    """
    ops: list[Op] = []
    tables: list[_RawTable] = []
    table_key: dict[tuple[int, int], int] = {}
    for i in range(prog.n_ops):
        oc = int(prog.opcode[i])
        lo, hi = int(prog.data_lo[i]), int(prog.data_hi[i])
        if oc == 8:
            src_idx, pad = lo & 0xFFFFFFFF, hi
            key = (src_idx, pad)
            if key not in table_key:
                table_key[key] = len(tables)
                tables.append(_RawTable(prog.tables[src_idx], pad))
            data = table_key[key]
        else:
            data = (hi << 32) | (lo & 0xFFFFFFFF)
        q = _container_qint(int(prog.signed[i]), int(prog.integers[i]), int(prog.fractionals[i]))
        ops.append(Op(int(prog.id0[i]), int(prog.id1[i]), oc, data, q, 0.0, 0.0))
    return CombLogic(
        shape=(int(prog.n_in), int(prog.n_out)),
        inp_shifts=[int(v) for v in prog.inp_shifts],
        out_idxs=[int(v) for v in prog.out_idxs],
        out_shifts=[int(v) for v in prog.out_shifts],
        out_negs=[bool(v) for v in prog.out_negs],
        ops=ops,
        carry_size=3,
        adder_size=8,
        lookup_tables=tuple(tables) if tables else None,
    )


def fuse_programs(progs: Sequence[DaisProgram], report: bool = False):
    """Fuse decoded per-stage DAIS programs into one decoded program."""
    res = fuse_pipeline(Pipeline(tuple(comb_from_program(p) for p in progs)), report=report)
    if report:
        fused, rep = res
        return decode(fused.to_binary()), rep
    return decode(res.to_binary())


def fuse_binaries(binaries: Sequence[NDArray[np.int32]]) -> NDArray[np.int32]:
    """Fuse per-stage DAIS binaries into one DAIS binary."""
    progs = [p if isinstance(p, DaisProgram) else decode(np.asarray(p, dtype=np.int32)) for p in binaries]
    fused = fuse_pipeline(Pipeline(tuple(comb_from_program(p) for p in progs)))
    return fused.to_binary()


__all__ = [
    'FUSABLE_OPCODES',
    'FusionReport',
    'comb_from_program',
    'fuse_binaries',
    'fuse_pipeline',
    'fuse_programs',
]
