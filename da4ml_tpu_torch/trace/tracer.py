"""Lowering of traced ``FixedVariable`` graphs into the DAIS Op program.

Three passes:

1. :func:`collect_graph` — walk the ancestors of every requested output with
   an explicit stack (no recursion limit), order nodes by pipeline latency
   (stable, so insertion order breaks ties), and drop nodes nothing consumes.
2. :func:`_emit_program` — translate one node per opcode family through the
   ``_ENCODERS`` registry.  The free power-of-two scale and sign each node
   carries in ``_factor`` is absorbed into the op's shift field or the
   opcode's sign at this point, so the emitted program only ever sees
   integer-aligned values.
3. :func:`dead_statement_elimination` — backward reachability over the emitted program
   followed by slot compaction.

The emitted encoding is the DAIS v1 instruction set. Counterpart of
``da4ml_tpu/trace/tracer.py``: the same program, byte for byte.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from decimal import Decimal
from math import log2

import numpy as np

from .. import telemetry
from ..ir.comb import CombLogic
from ..ir.types import Op, QInterval
from .fixed_variable import FixedVariable, const_f, table_context


# ---------------------------------------------------------------------------
# DAIS data-word packing.  Two opcodes carry packed payloads; the layout is
# fixed by the DAIS v1 binary format and shared with pipeline.py.
# ---------------------------------------------------------------------------

_LOW32 = (1 << 32) - 1


def pack_mux_payload(cond_slot: int, shift: int) -> int:
    """msb_mux payload: selector slot in the low word, shift in the high word."""
    return (shift << 32) | cond_slot


def mux_cond_slot(data: int) -> int:
    return data & _LOW32


def mux_shift(data: int) -> int:
    return (data >> 32) & _LOW32


def pack_bitbin_payload(subop: int, neg0: bool, neg1: bool, shift: int) -> int:
    """bit_binary payload: subop in bits 63:56, operand-negate flags in bits
    33:32, relative shift in the low word."""
    return (subop << 56) | (int(neg1) << 33) | (int(neg0) << 32) | (shift & _LOW32)


def _rel_shift(f_ref, f_other) -> int:
    """Power-of-two distance between two factors (how far operand two sits
    from operand one)."""
    return int(log2(abs(f_other / f_ref)))


# ---------------------------------------------------------------------------
# Pass 1: graph collection
# ---------------------------------------------------------------------------


def collect_graph(inputs: Sequence[FixedVariable], outputs: Sequence[FixedVariable]):
    """Gather every node reachable from ``outputs``, plus all ``inputs``.

    Returns the nodes in execution order (ascending latency, ties by first
    visit) together with a ``{node id: slot}`` map.  Nodes that feed nothing
    — possible when an input of the trace has ancestors of its own — are
    removed, except for the inputs themselves.
    """
    seen: dict[int, FixedVariable] = {v.id: v for v in inputs}
    input_ids = frozenset(seen)
    for root in outputs:
        stack = [root]
        while stack:
            node = stack[-1]
            if node.id in seen:
                stack.pop()
                continue
            todo = [p for p in node._from if p.id not in seen]
            if todo:
                # left-most parent must complete first: push it last
                stack.extend(reversed(todo))
            else:
                seen[node.id] = node
                stack.pop()

    nodes = sorted(seen.values(), key=lambda nd: nd.latency)  # stable

    fanout: dict[int, int] = dict.fromkeys(seen, 0)
    for nd in nodes:
        if nd.id in input_ids:
            continue
        for p in nd._from:
            fanout[p.id] += 1
    for out in outputs:
        fanout[out.id] += 1

    nodes = [nd for nd in nodes if fanout[nd.id] or nd.id in input_ids]
    slot = {nd.id: i for i, nd in enumerate(nodes)}
    return nodes, slot


# ---------------------------------------------------------------------------
# Pass 2: per-opcode encoders
# ---------------------------------------------------------------------------


class _EmitCtx:
    """Operand resolution for the node currently being emitted."""

    __slots__ = ('slot', 'pos', 'table_slot')

    def __init__(self, slot: dict[int, int], table_slot: dict[int, int]):
        self.slot = slot
        self.pos = 0
        self.table_slot = table_slot

    def ref(self, operand: FixedVariable) -> int:
        """Slot of an operand, verified to precede the consumer (causality)."""
        k = self.slot[operand.id]
        if k >= self.pos:
            raise AssertionError(f'operand v{operand.id} lives at slot {k}, after its consumer at slot {self.pos}')
        return k


_Encoder = Callable[[FixedVariable, _EmitCtx], Op]
_ENCODERS: dict[str, _Encoder] = {}


def _encodes(opr: str):
    def register(fn: _Encoder) -> _Encoder:
        _ENCODERS[opr] = fn
        return fn

    return register


@_encodes('vadd')
def _vadd(v: FixedVariable, ctx: _EmitCtx) -> Op:
    a, b = v._from
    # a + b·2^s with the sign of b's factor selecting add vs subtract
    opcode = 1 if b._factor < 0 else 0
    return Op(ctx.ref(a), ctx.ref(b), opcode, _rel_shift(a._factor, b._factor), v.unscaled.qint, v.latency, v.cost)


@_encodes('cadd')
def _cadd(v: FixedVariable, ctx: _EmitCtx) -> Op:
    (a,) = v._from
    if v._data is None:
        raise AssertionError('constant-add node lost its addend')
    qint = v.unscaled.qint
    bias = int(v._data / Decimal(qint.step))  # addend in lsb units
    return Op(ctx.ref(a), -1, 4, bias, qint, v.latency, v.cost)


@_encodes('wrap')
def _wrap(v: FixedVariable, ctx: _EmitCtx) -> Op:
    (a,) = v._from
    return Op(ctx.ref(a), -1, 3 if a._factor > 0 else -3, 0, v.unscaled.qint, v.latency, v.cost)


@_encodes('relu')
def _relu(v: FixedVariable, ctx: _EmitCtx) -> Op:
    (a,) = v._from
    return Op(ctx.ref(a), -1, 2 if a._factor > 0 else -2, 0, v.unscaled.qint, v.latency, v.cost)


@_encodes('const')
def _const(v: FixedVariable, ctx: _EmitCtx) -> Op:
    lo, hi, _ = v.unscaled.qint
    if lo != hi:
        raise AssertionError(f'constant v{v.id} spans [{lo}, {hi}]')
    step = 2.0 ** -const_f(lo)
    return Op(-1, -1, 5, int(lo / step), QInterval(lo, lo, step), v.latency, v.cost)


@_encodes('msb_mux')
def _msb_mux(v: FixedVariable, ctx: _EmitCtx) -> Op:
    cond, a, b = v._from
    if cond._factor < 0:
        raise AssertionError(f'mux selector v{cond.id} must not carry a negated factor (got {cond._factor})')
    payload = pack_mux_payload(ctx.ref(cond), _rel_shift(a._factor, b._factor))
    opcode = 6 if b._factor > 0 else -6
    return Op(ctx.ref(a), ctx.ref(b), opcode, payload, v.unscaled.qint, v.latency, v.cost)


@_encodes('vmul')
def _vmul(v: FixedVariable, ctx: _EmitCtx) -> Op:
    a, b = v._from
    return Op(ctx.ref(a), ctx.ref(b), 7, 0, v.unscaled.qint, v.latency, v.cost)


@_encodes('lookup')
def _lookup(v: FixedVariable, ctx: _EmitCtx) -> Op:
    (a,) = v._from
    if v._data is None:
        raise AssertionError('lookup node lost its table reference')
    return Op(ctx.ref(a), -1, 8, ctx.table_slot[int(v._data)], v.unscaled.qint, v.latency, v.cost)


@_encodes('bit_unary')
def _bit_unary(v: FixedVariable, ctx: _EmitCtx) -> Op:
    (a,) = v._from
    if v._data is None:
        raise AssertionError('bit_unary node lost its sub-opcode')
    return Op(ctx.ref(a), -1, 9 if v._factor > 0 else -9, int(v._data), v.unscaled.qint, v.latency, v.cost)


@_encodes('bit_binary')
def _bit_binary(v: FixedVariable, ctx: _EmitCtx) -> Op:
    a, b = v._from
    if v._data is None:
        raise AssertionError('bit_binary node lost its sub-opcode')
    payload = pack_bitbin_payload(int(v._data), a._factor < 0, b._factor < 0, _rel_shift(a._factor, b._factor))
    return Op(ctx.ref(a), ctx.ref(b), 10, payload, v.unscaled.qint, v.latency, v.cost)


def _emit_program(inputs: Sequence[FixedVariable], outputs: Sequence[FixedVariable]):
    nodes, slot = collect_graph(inputs, outputs)
    input_slot = {v.id: i for i, v in enumerate(inputs)}

    # Register each distinct lookup table once, in first-use order.
    tables: list = []
    table_slot: dict[int, int] = {}
    for nd in nodes:
        if nd.opr != 'lookup':
            continue
        if nd._data is None:
            raise AssertionError('lookup node lost its table reference')
        gid = int(nd._data)
        if gid not in table_slot:
            table_slot[gid] = len(tables)
            tables.append(table_context.get_table_from_index(gid))

    ops: list[Op] = []
    ctx = _EmitCtx(slot, table_slot)
    for pos, nd in enumerate(nodes):
        ctx.pos = pos
        if nd.id in input_slot and nd.opr != 'const':
            # external fetch: id0 is the input lane, not an op slot
            ops.append(Op(input_slot[nd.id], -1, -1, 0, nd.unscaled.qint, nd.latency, 0.0))
            continue
        encode = _ENCODERS.get(nd.opr)
        if encode is None:
            raise NotImplementedError(f'no DAIS lowering for operation {nd.opr!r}')
        ops.append(encode(nd, ctx))

    out_slots = [slot[v.id] for v in outputs]
    return ops, out_slots, tuple(tables) if tables else None


# ---------------------------------------------------------------------------
# Pass 3: dead-op pruning
# ---------------------------------------------------------------------------


def _op_reads(op: Op):
    """Slots an op reads.  Note: for external fetches (opcode -1) ``id0`` is
    an input lane, which liveness nevertheless marks — input lane j and its
    fetch op occupy the same slot j whenever inputs lead the program, which
    ``collect_graph``'s ordering guarantees."""
    if op.id0 >= 0:
        yield op.id0
    if op.id1 >= 0:
        yield op.id1
    if op.opcode in (6, -6):
        yield mux_cond_slot(op.data)


def _retarget(op: Op, remap: dict[int, int]) -> Op:
    if op.opcode == -1:
        return op
    data = op.data
    if op.opcode in (6, -6):
        data = pack_mux_payload(remap[mux_cond_slot(data)], mux_shift(data))
    return op._replace(
        id0=remap[op.id0] if op.id0 >= 0 else op.id0,
        id1=remap[op.id1] if op.id1 >= 0 else op.id1,
        data=data,
    )


def dead_statement_elimination(comb: CombLogic, keep_dead_inputs: bool = False) -> CombLogic:
    """Drop ops no output transitively reads, compacting the slot space.

    With ``keep_dead_inputs`` the external-fetch ops survive even when
    unread, so the program's input arity is preserved.
    """
    n = len(comb.ops)
    live = bytearray(n)
    for r in comb.out_idxs:
        if r >= 0:
            live[r] = 1
    # ops are in execution order, so one backward sweep reaches a fixpoint
    for i in range(n - 1, -1, -1):
        op = comb.ops[i]
        if not live[i] and not (keep_dead_inputs and op.opcode == -1):
            continue
        for r in _op_reads(op):
            live[r] = 1

    remap: dict[int, int] = {}
    kept: list[Op] = []
    for i, op in enumerate(comb.ops):
        if live[i]:
            remap[i] = len(kept)
            kept.append(op)

    return CombLogic(
        comb.shape,
        comb.inp_shifts,
        [remap[r] if r >= 0 else -1 for r in comb.out_idxs],
        comb.out_shifts,
        comb.out_negs,
        [_retarget(op, remap) for op in kept],
        comb.carry_size,
        comb.adder_size,
        comb.lookup_tables,
    )


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def comb_trace(inputs, outputs, keep_dead_inputs: bool = False) -> CombLogic:
    """Lower a traced computation (inputs → outputs) to a :class:`CombLogic`."""
    ins = [inputs] if isinstance(inputs, FixedVariable) else list(np.ravel(inputs))
    outs = [outputs] if isinstance(outputs, FixedVariable) else list(np.ravel(outputs))

    with telemetry.span('trace.comb_trace', n_in=len(ins), n_out=len(outs)) as sp:
        for v in ins:
            if v._factor <= 0:
                raise AssertionError(f'trace input v{v.id} carries a non-positive factor {v._factor}')

        if any(not isinstance(o, FixedVariable) for o in outs):
            hwconf = ins[0].hwconf
            outs = [o if isinstance(o, FixedVariable) else FixedVariable.from_const(o, hwconf, 1) for o in outs]

        ops, out_slots, tables = _emit_program(ins, outs)

        factors = [o._factor for o in outs]
        comb = CombLogic(
            (len(ins), len(outs)),
            [0] * len(ins),
            out_slots,
            [int(log2(abs(f))) for f in factors],
            [f < 0 for f in factors],
            ops,
            outs[0].hwconf.carry_size,
            outs[0].hwconf.adder_size,
            tables,
        )
        result = dead_statement_elimination(comb, keep_dead_inputs)
        telemetry.counter('trace.ops').inc(len(result.ops))
        if sp:
            sp.set(n_ops=len(result.ops))
        return result
