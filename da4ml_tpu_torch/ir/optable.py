"""Declarative DAIS v1 opcode table — the single source of truth for opcode
semantics in the port.

Each :class:`OpSpec` row describes one opcode family:

- **concrete semantics** twice, for the two value representations the stack
  executes: ``replay`` (float/symbolic, the ``CombLogic.__call__`` path) and
  ``kernel`` (bit-exact int64 over a decoded :class:`~.dais_binary.DaisProgram`
  — the table-generated *reference interpreter* in ``runtime.reference`` that
  the torch and CUDA executors are held against);
- **abstract semantics**: the QInterval ``transfer`` function the
  ``analysis.interval`` verifier pass dispatches on, producer conventions
  included (sign-flip mixing, container-defining annotations);
- **legality**: operand kinds (``id0``/``reads_id1``/``cond_in_data``),
  payload sub-field ranges (``payload_check``) and shift extraction
  (``shift_of``) read by ``analysis.wellformed``;
- **vectorization class**: the group id the level lowering
  (``runtime.torch_backend``) packs ops by;
- **lowering**: the name of the family's case in the CUDA kernel's switch
  (``runtime.cuda_backend.LOWERINGS``, audited both ways at its import);
- **soundness sampling**: ``sample`` builds a randomized honest one-op
  program for the transfer-soundness checker (``analysis.soundness``),
  which proves the abstract output interval contains every concrete replay
  result;
- **mutation catalog**: the corruptions ``analysis.mutation`` lists for the
  verifier self-test, one family per row.

Counterpart of ``da4ml_tpu/ir/optable.py``; its ``pallas_lower`` column is
``lower`` here, keyed by the same eleven names. ``da4ml-tpu-torch
lint-opcodes`` fails on opcode dispatch sites outside the allowlisted
consumers of this table.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from ..ops.numeric import apply_binary_bit_op, apply_quantize, apply_relu, apply_unary_bit_op
from .lut import LookupTable
from .types import Op, QInterval, minimal_kif, qint_add

#: largest plausible power-of-two shift in an op payload (DAIS values are
#: fixed-point with at most a few hundred bits; anything beyond is corruption
#: and would overflow float replay)
SHIFT_LIMIT = 256

_UNARY_BIT_SUBOPS = (0, 1, 2)  # NOT, OR-reduce, AND-reduce
_BINARY_BIT_SUBOPS = (0, 1, 2)  # AND, OR, XOR


def i32(x: int) -> int:
    """Interpret the low 32 bits of x as a signed int32."""
    return ((int(x) & 0xFFFFFFFF) + (1 << 31)) % (1 << 32) - (1 << 31)


# ---------------------------------------------------------------------------
# float / symbolic replay semantics (CombLogic.__call__)
# ---------------------------------------------------------------------------


def _rp_input(comb, op: Op, buf: list, inputs: list):
    return inputs[op.id0]


def _rp_shift_add(comb, op, buf, inputs):
    shifted = buf[op.id1] * 2.0**op.data
    return buf[op.id0] + shifted if op.opcode == 0 else buf[op.id0] - shifted


def _rp_relu(comb, op, buf, inputs):
    _, i, f = minimal_kif(op.qint)
    return apply_relu(buf[op.id0], i, f, inv=op.opcode < 0, round_mode='TRN')


def _rp_quantize(comb, op, buf, inputs):
    v = buf[op.id0] if op.opcode > 0 else -buf[op.id0]
    k, i, f = minimal_kif(op.qint)
    return apply_quantize(v, k, i, f, round_mode='TRN', force_wrap=True)


def _rp_const_add(comb, op, buf, inputs):
    return buf[op.id0] + op.data * op.qint.step


def _rp_const(comb, op, buf, inputs):
    return op.data * op.qint.step


def _rp_msb_mux(comb, op, buf, inputs):
    cond_slot = op.data & 0xFFFFFFFF
    shift = i32(op.data >> 32)
    key = buf[cond_slot]
    on_neg = buf[op.id0]
    on_pos = buf[op.id1] * 2.0**shift
    if op.opcode < 0:
        on_pos = -on_pos
    if hasattr(key, 'msb_mux'):  # symbolic replay
        return key.msb_mux(on_neg, on_pos, op.qint)
    q_key = comb.ops[cond_slot].qint
    if q_key.min < 0:
        return on_neg if key < 0 else on_pos
    _, i, _ = minimal_kif(q_key)  # unsigned key: MSB = top magnitude bit
    return on_neg if key >= 2.0 ** (i - 1) else on_pos


def _rp_mul(comb, op, buf, inputs):
    return buf[op.id0] * buf[op.id1]


def _rp_lookup(comb, op, buf, inputs):
    if comb.lookup_tables is None:
        raise ValueError('No lookup table for lookup op')
    return comb.lookup_tables[op.data].lookup(buf[op.id0], comb.ops[op.id0].qint)


def _rp_bit_unary(comb, op, buf, inputs):
    v = buf[op.id0] if op.opcode > 0 else -buf[op.id0]
    return apply_unary_bit_op(v, op.data, comb.ops[op.id0].qint, op.qint)


def _rp_bit_binary(comb, op, buf, inputs):
    v0 = -buf[op.id0] if (op.data >> 32) & 1 else buf[op.id0]
    v1 = -buf[op.id1] if (op.data >> 33) & 1 else buf[op.id1]
    shift = i32(op.data)
    subop = (op.data >> 56) & 0xFF
    s = 2.0**shift
    q1 = comb.ops[op.id1].qint
    return apply_binary_bit_op(
        v0, v1 * s, subop, comb.ops[op.id0].qint, QInterval(q1.min * s, q1.max * s, q1.step * s), op.qint
    )


# ---------------------------------------------------------------------------
# int64 reference kernels (struct-of-arrays DaisProgram semantics)
#
# These generate the reference interpreter (runtime/reference.py). Integer
# semantics are two's-complement int64: arithmetic shifts, modular wrap.
# ---------------------------------------------------------------------------


class RefState:
    """Execution state threaded through the per-opcode reference kernels."""

    __slots__ = ('prog', 'x', 'buf', 'width')

    def __init__(self, prog, x: np.ndarray):
        self.prog = prog
        self.x = np.asarray(x, dtype=np.float64)
        self.buf = np.zeros((prog.n_ops, len(self.x)), dtype=np.int64)
        self.width = prog.width


def ref_shl(v: np.ndarray, s: int) -> np.ndarray:
    """Shift left by s (arithmetic right shift for negative s)."""
    return v << s if s >= 0 else v >> (-s)


def ref_wrap(v: np.ndarray, signed: int, width: int) -> np.ndarray:
    """Two's-complement wrap of v into ``width`` bits."""
    mod = np.int64(1) << width
    int_min = -(np.int64(1) << (width - 1)) if signed else np.int64(0)
    return ((v - int_min) % mod) + int_min


def ref_quantize(v: np.ndarray, f_from: int, signed_to: int, width_to: int, f_to: int) -> np.ndarray:
    return ref_wrap(ref_shl(v, f_to - f_from), signed_to, width_to)


def ref_msb(v: np.ndarray, signed: int, width: int) -> np.ndarray:
    """MSB of the two's-complement representation: sign bit when signed,
    top magnitude bit when unsigned."""
    if signed:
        return v < 0
    return v >= (np.int64(1) << (width - 1))


def _rk_copy(st: RefState, i: int) -> np.ndarray:
    p = st.prog
    i0, f = int(p.id0[i]), int(p.fractionals[i])
    v = np.floor(st.x[:, i0] * 2.0 ** (int(p.inp_shifts[i0]) + f)).astype(np.int64)
    return ref_wrap(v, int(p.signed[i]), int(st.width[i]))


def _rk_shift_add(st: RefState, i: int) -> np.ndarray:
    p = st.prog
    i0, i1 = int(p.id0[i]), int(p.id1[i])
    f0, f1 = int(p.fractionals[i0]), int(p.fractionals[i1])
    dlo = int(p.data_lo[i])
    a_shift = dlo + f0 - f1
    v1 = st.buf[i0]
    v2 = -st.buf[i1] if int(p.opcode[i]) == 1 else st.buf[i1]
    r = v1 + (v2 << a_shift) if a_shift > 0 else (v1 << -a_shift) + v2
    g_shift = max(f0, f1 - dlo) - int(p.fractionals[i])
    return r >> g_shift if g_shift > 0 else r


def _rk_relu(st: RefState, i: int) -> np.ndarray:
    p = st.prog
    v = -st.buf[int(p.id0[i])] if int(p.opcode[i]) < 0 else st.buf[int(p.id0[i])]
    q = ref_quantize(v, int(p.fractionals[int(p.id0[i])]), int(p.signed[i]), int(st.width[i]), int(p.fractionals[i]))
    return np.where(v < 0, np.int64(0), q)


def _rk_quantize(st: RefState, i: int) -> np.ndarray:
    p = st.prog
    v = -st.buf[int(p.id0[i])] if int(p.opcode[i]) < 0 else st.buf[int(p.id0[i])]
    return ref_quantize(v, int(p.fractionals[int(p.id0[i])]), int(p.signed[i]), int(st.width[i]), int(p.fractionals[i]))


def _ref_const64(p, i: int) -> np.int64:
    return (np.int64(int(p.data_hi[i])) << 32) | np.int64(int(p.data_lo[i]) & 0xFFFFFFFF)


def _rk_const_add(st: RefState, i: int) -> np.ndarray:
    p = st.prog
    i0 = int(p.id0[i])
    shift = int(p.fractionals[i]) - int(p.fractionals[i0])
    return ref_shl(st.buf[i0], shift) + _ref_const64(p, i)


def _rk_const(st: RefState, i: int) -> np.ndarray:
    return np.full(st.buf.shape[1], _ref_const64(st.prog, i), dtype=np.int64)


def _rk_msb_mux(st: RefState, i: int) -> np.ndarray:
    p = st.prog
    i0, i1, ic = int(p.id0[i]), int(p.id1[i]), int(p.data_lo[i])
    f, sg, w = int(p.fractionals[i]), int(p.signed[i]), int(st.width[i])
    shift1 = f - int(p.fractionals[i1]) + int(p.data_hi[i])
    shift0 = f - int(p.fractionals[i0])
    if shift1 != 0 and shift0 != 0:
        raise ValueError(f'Unsupported msb_mux shifts: shift0={shift0}, shift1={shift1}')
    cond = ref_msb(st.buf[ic], int(p.signed[ic]), int(st.width[ic]))
    v1 = -st.buf[i1] if int(p.opcode[i]) < 0 else st.buf[i1]
    r0 = ref_wrap(ref_shl(st.buf[i0], shift0), sg, w)
    r1 = ref_wrap(ref_shl(v1, shift1), sg, w)
    return np.where(cond, r0, r1)


def _rk_mul(st: RefState, i: int) -> np.ndarray:
    p = st.prog
    return st.buf[int(p.id0[i])] * st.buf[int(p.id1[i])]


def _rk_lookup(st: RefState, i: int) -> np.ndarray:
    p = st.prog
    i0, dlo, dhi = int(p.id0[i]), int(p.data_lo[i]), int(p.data_hi[i])
    table = p.tables[dlo & 0xFFFFFFFF]
    sg0, w0 = int(p.signed[i0]), int(st.width[i0])
    zero = -sg0 * (np.int64(1) << (w0 - 1))
    index = st.buf[i0] - zero - dhi
    if (index < 0).any() or (index >= len(table)).any():
        raise ValueError('Logic lookup index out of bounds')
    return np.asarray(table)[index].astype(np.int64)


def _rk_bit_unary(st: RefState, i: int) -> np.ndarray:
    p = st.prog
    i0, dlo, sg = int(p.id0[i]), int(p.data_lo[i]), int(p.signed[i])
    v = -st.buf[i0] if int(p.opcode[i]) < 0 else st.buf[i0]
    mask = (np.int64(1) << int(st.width[i0])) - 1
    if dlo == 0:
        return ~v if sg else (~v) & mask
    if dlo == 1:
        return (v != 0).astype(np.int64)
    if dlo == 2:
        return ((v & mask) == mask).astype(np.int64)
    raise ValueError(f'Unknown bit unary op data={dlo}')


def _rk_bit_binary(st: RefState, i: int) -> np.ndarray:
    p = st.prog
    i0, i1 = int(p.id0[i]), int(p.id1[i])
    dlo, dhi = int(p.data_lo[i]), int(p.data_hi[i])
    a_shift = dlo + int(p.fractionals[i0]) - int(p.fractionals[i1])
    v1, v2 = st.buf[i0], st.buf[i1]
    if dhi & 1:
        v1 = -v1
    if dhi & 2:
        v2 = -v2
    if a_shift > 0:
        v2 = v2 << a_shift
    else:
        v1 = v1 << -a_shift
    subop = dhi >> 24
    if subop == 0:
        return v1 & v2
    if subop == 1:
        return v1 | v2
    if subop == 2:
        return v1 ^ v2
    raise ValueError(f'Unknown bit binary op {subop}')


# ---------------------------------------------------------------------------
# QInterval transfer functions (abstract interpretation, analysis/interval.py)
#
# Each returns ``(computed_interval, checks)`` where checks is a list of
# ``(rule_id, message)`` pairs. Producer conventions honored here are
# documented in analysis/interval.py.
# ---------------------------------------------------------------------------

_EPS = 1e-9


def _tol(*vals: float) -> float:
    return _EPS * max(1.0, *(abs(v) for v in vals if np.isfinite(v)))


def _contains(outer: QInterval, lo: float, hi: float, step: float) -> bool:
    t = _tol(lo, hi)
    return outer.min <= lo + t and outer.max >= hi - t and outer.step <= step * (1.0 + _EPS)


def _neg_pair(lo: float, hi: float) -> tuple[float, float]:
    return -hi, -lo


def _tf_quantize(comb, op: Op, q: QInterval, operand) -> tuple[QInterval, list]:
    # quantize family (copy / relu / quantize): the annotation defines the
    # result container; warn when it is strictly coarser than the operand's.
    checks: list[tuple[str, str]] = []
    src = operand(int(op.id0)) if op.opcode != -1 else None
    if src is not None and q.step > src.step * (1.0 + _EPS):
        checks.append(
            ('Q220', f'quantize drops precision: result step {q.step} is coarser than operand step {src.step}')
        )
    return q, checks


def _tf_add(comb, op: Op, q: QInterval, operand) -> tuple[QInterval, list]:
    q0, q1 = operand(int(op.id0)), operand(int(op.id1))
    if q0 is None or q1 is None:
        return q, []
    try:
        c = qint_add(q0, q1, int(op.data), False, op.opcode == 1)
    except OverflowError:
        return q, []
    if _contains(q, c.min, c.max, c.step):
        return c, []
    nlo, nhi = _neg_pair(c.min, c.max)
    if _contains(q, nlo, nhi, c.step):
        return c, []
    # CMVM sign-flip mixing can shift the position; span and step are
    # invariant under it, so that is the weakest sound criterion
    span_c, span_q = c.max - c.min, q.max - q.min
    if span_q + _tol(span_c) >= span_c and q.step <= c.step * (1.0 + _EPS):
        return c, []
    return c, [
        ('Q210', f'annotation [{q.min}, {q.max}] step {q.step} cannot hold computed [{c.min}, {c.max}] step {c.step}')
    ]


def _tf_const_add(comb, op: Op, q: QInterval, operand) -> tuple[QInterval, list]:
    q0 = operand(int(op.id0))
    if q0 is None:
        return q, []
    c_add = int(op.data) * q.step
    c = QInterval(q0.min + c_add, q0.max + c_add, min(q0.step, q.step))
    if _contains(q, c.min, c.max, c.step) or _contains(q, *_neg_pair(c.min, c.max), c.step):
        return c, []
    return c, [('Q210', f'annotation [{q.min}, {q.max}] cannot hold operand + {c_add} = [{c.min}, {c.max}]')]


def _tf_const(comb, op: Op, q: QInterval, operand) -> tuple[QInterval, list]:
    value = int(op.data) * q.step
    c = QInterval(value, value, q.step)
    t = _tol(value)
    if q.min - t <= value <= q.max + t or q.min - t <= -value <= q.max + t:
        return c, []
    return c, [('Q210', f'constant value {value} lies outside its annotation [{q.min}, {q.max}]')]


def _tf_trusted(comb, op: Op, q: QInterval, operand) -> tuple[QInterval, list]:
    # branch-correlated mux annotations are legitimately narrower than the
    # branch hull (e.g. ``abs``), and bitwise annotations define their
    # container — the annotation is trusted both as the result container
    # and for downstream propagation
    return q, []


def _tf_mul(comb, op: Op, q: QInterval, operand) -> tuple[QInterval, list]:
    q0, q1 = operand(int(op.id0)), operand(int(op.id1))
    if q0 is None or q1 is None:
        return q, []
    if int(op.id0) == int(op.id1):
        # squaring is bounded by the squared endpoints, not the 4-corner hull
        ends = [q0.min * q0.min, q0.max * q0.max]
        if q0.min < 0 < q0.max:
            ends.append(0.0)
    else:
        ends = [q0.min * q1.min, q0.min * q1.max, q0.max * q1.min, q0.max * q1.max]
    c = QInterval(min(ends), max(ends), q0.step * q1.step)
    if _contains(q, c.min, c.max, c.step) or _contains(q, *_neg_pair(c.min, c.max), c.step):
        return c, []
    return c, [
        ('Q210', f'annotation [{q.min}, {q.max}] step {q.step} cannot hold product [{c.min}, {c.max}] step {c.step}')
    ]


def _tf_lookup(comb, op: Op, q: QInterval, operand) -> tuple[QInterval, list]:
    tables = comb.lookup_tables
    tbl = int(op.data)
    if tables is None or not 0 <= tbl < len(tables):
        return q, []  # W110 already flagged it
    ft = tables[tbl].float_table
    lo, hi = float(ft.min()), float(ft.max())
    step = tables[tbl].spec.out_qint.step
    if _contains(q, lo, hi, step) or _contains(q, *_neg_pair(lo, hi), step):
        return q, []
    return q, [
        (
            'Q221',
            f'lookup annotation [{q.min}, {q.max}] step {q.step} disagrees with its '
            f'table range [{lo}, {hi}] step {step}',
        )
    ]


# ---------------------------------------------------------------------------
# payload legality checks (analysis/wellformed.py)
# ---------------------------------------------------------------------------


def _pc_lookup(op: Op, n_tables: int | None) -> list[tuple[str, str]]:
    tbl = int(op.data)
    if n_tables is None:
        return [('W110', f'lookup op references table {tbl} but the program carries no tables')]
    if not 0 <= tbl < n_tables:
        return [('W110', f'lookup op references table {tbl}, program has {n_tables} tables')]
    return []


def _pc_bit_unary(op: Op, n_tables: int | None) -> list[tuple[str, str]]:
    if int(op.data) not in _UNARY_BIT_SUBOPS:
        return [('W111', f'unary bitwise sub-opcode {int(op.data)} (valid: 0=NOT, 1=OR-reduce, 2=AND-reduce)')]
    return []


def _pc_bit_binary(op: Op, n_tables: int | None) -> list[tuple[str, str]]:
    subop = (int(op.data) >> 56) & 0xFF
    if subop not in _BINARY_BIT_SUBOPS:
        return [('W111', f'binary bitwise sub-opcode {subop} (valid: 0=AND, 1=OR, 2=XOR)')]
    return []


def _shift_data(op: Op) -> int:
    return int(op.data)


def _shift_hi(op: Op) -> int:
    return i32(int(op.data) >> 32)


def _shift_lo(op: Op) -> int:
    return i32(int(op.data))


# ---------------------------------------------------------------------------
# mutation catalog helpers (analysis/mutation.py)
# ---------------------------------------------------------------------------


def _find_op(comb, opcodes: tuple[int, ...]) -> int:
    for i, op in enumerate(comb.ops):
        if op.opcode in opcodes:
            return i
    raise ValueError(f'program has no op with opcode in {opcodes}; cannot apply corruption')


def mutate_op(comb, opcodes: tuple[int, ...], **fields):
    i = _find_op(comb, opcodes)
    ops = list(comb.ops)
    ops[i] = ops[i]._replace(**fields)
    return comb._replace(ops=ops)


def mutate_qint(comb, opcodes: tuple[int, ...], fn: Callable[[QInterval], QInterval]):
    i = _find_op(comb, opcodes)
    ops = list(comb.ops)
    ops[i] = ops[i]._replace(qint=fn(ops[i].qint))
    return comb._replace(ops=ops)


def _self_reference(comb, opcodes: tuple[int, ...], field: str):
    i = _find_op(comb, opcodes)
    ops = list(comb.ops)
    ops[i] = ops[i]._replace(**{field: i})
    return comb._replace(ops=ops)


def _corrupt_mux_cond(comb):
    i = _find_op(comb, (6, -6))
    ops = list(comb.ops)
    data = int(ops[i].data)
    shift = data >> 32  # keep the shift word, repoint the condition at self
    ops[i] = ops[i]._replace(data=(shift << 32) | i)
    return comb._replace(ops=ops)


def _corrupt_bitbin_subop(comb):
    i = _find_op(comb, (10,))
    ops = list(comb.ops)
    data = int(ops[i].data)
    ops[i] = ops[i]._replace(data=(9 << 56) | (data & ((1 << 56) - 1)))
    return comb._replace(ops=ops)


class MutationSpec(NamedTuple):
    """One catalogued per-opcode corruption: fault-site suffix, the verifier
    rule that must catch it, and the CombLogic -> CombLogic damage."""

    name: str
    expect_rule: str
    apply: Callable


# ---------------------------------------------------------------------------
# transfer-soundness samplers (analysis/soundness.py)
#
# Each builds an *honest* randomized one-op program: operand slots are copy
# ops carrying randomized QIntervals, the op under test is last, and its
# annotation is what a correct producer would write. The soundness checker
# replays concrete grid samples through ``replay`` and asserts each result
# lies inside the ``transfer``-computed abstract interval.
# ---------------------------------------------------------------------------


class SoundCase(NamedTuple):
    ops: list
    op_index: int
    tables: tuple | None


def _rand_qint(rng, f_max: int = 4, mag: int = 5, lo_min: int | None = None) -> QInterval:
    f = int(rng.integers(0, f_max))
    step = 2.0**-f
    span = 1 << mag
    a = int(rng.integers(0 if lo_min == 0 else -span, span))
    b = int(rng.integers(a + 1, a + span + 1))
    return QInterval(a * step, b * step, step)


def _copy_op(lane: int, qi: QInterval) -> Op:
    return Op(lane, -1, -1, 0, qi, 0.0, 0.0)


def _container_qint(rng, i_max: int = 5) -> QInterval:
    # full representable range of a random signed (i, f) container
    i = int(rng.integers(1, i_max))
    f = int(rng.integers(0, 4))
    step = 2.0**-f
    return QInterval(-(2.0**i), 2.0**i - step, step)


def _sample_copy(rng) -> SoundCase:
    return SoundCase([_copy_op(0, _rand_qint(rng))], 0, None)


def _sample_add(rng) -> SoundCase:
    q0, q1 = _rand_qint(rng), _rand_qint(rng)
    shift = int(rng.integers(-2, 3))
    opc = int(rng.integers(0, 2))
    ann = qint_add(q0, q1, shift, False, opc == 1)
    return SoundCase([_copy_op(0, q0), _copy_op(1, q1), Op(0, 1, opc, shift, ann, 0.0, 1.0)], 2, None)


def _sample_relu(rng) -> SoundCase:
    q0 = _rand_qint(rng)
    i = int(rng.integers(1, 5))
    f = int(rng.integers(0, 4))
    ann = QInterval(0.0, 2.0**i - 2.0**-f, 2.0**-f)
    opc = 2 if rng.integers(0, 2) else -2
    return SoundCase([_copy_op(0, q0), Op(0, -1, opc, 0, ann, 0.0, 1.0)], 1, None)


def _sample_quantize(rng) -> SoundCase:
    q0 = _rand_qint(rng)
    opc = 3 if rng.integers(0, 2) else -3
    return SoundCase([_copy_op(0, q0), Op(0, -1, opc, 0, _container_qint(rng), 0.0, 1.0)], 1, None)


def _sample_const_add(rng) -> SoundCase:
    q0 = _rand_qint(rng)
    c = int(rng.integers(-31, 32))
    ann = QInterval(q0.min + c * q0.step, q0.max + c * q0.step, q0.step)
    return SoundCase([_copy_op(0, q0), Op(0, -1, 4, c, ann, 0.0, 1.0)], 1, None)


def _sample_const(rng) -> SoundCase:
    f = int(rng.integers(0, 4))
    c = int(rng.integers(-100, 101))
    step = 2.0**-f
    return SoundCase([Op(-1, -1, 5, c, QInterval(c * step, c * step, step), 0.0, 0.0)], 0, None)


def _sample_mux(rng) -> SoundCase:
    qc = _rand_qint(rng, lo_min=0 if rng.integers(0, 2) else None)
    q0, q1 = _rand_qint(rng), _rand_qint(rng)
    shift = int(rng.integers(-1, 3))
    opc = 6 if rng.integers(0, 2) else -6
    s = 2.0**shift
    b1 = QInterval(q1.min * s, q1.max * s, q1.step * s)
    if opc < 0:
        b1 = QInterval(-b1.max, -b1.min, b1.step)
    hull = QInterval(min(q0.min, b1.min), max(q0.max, b1.max), min(q0.step, b1.step))
    data = ((shift & 0xFFFFFFFF) << 32) | 0  # condition at slot 0
    return SoundCase([_copy_op(0, qc), _copy_op(1, q0), _copy_op(2, q1), Op(1, 2, opc, data, hull, 0.0, 1.0)], 3, None)


def _sample_mul(rng) -> SoundCase:
    q0 = _rand_qint(rng, mag=4)
    if rng.integers(0, 3) == 0:  # squaring: both operands are the same slot
        ends = [q0.min * q0.min, q0.max * q0.max] + ([0.0] if q0.min < 0 < q0.max else [])
        ann = QInterval(min(ends), max(ends), q0.step * q0.step)
        return SoundCase([_copy_op(0, q0), Op(0, 0, 7, 0, ann, 0.0, 1.0)], 1, None)
    q1 = _rand_qint(rng, mag=4)
    ends = [q0.min * q1.min, q0.min * q1.max, q0.max * q1.min, q0.max * q1.max]
    ann = QInterval(min(ends), max(ends), q0.step * q1.step)
    return SoundCase([_copy_op(0, q0), _copy_op(1, q1), Op(0, 1, 7, 0, ann, 0.0, 1.0)], 2, None)


def _sample_lookup(rng) -> SoundCase:
    q0 = _rand_qint(rng, f_max=2, mag=3)
    size = round((q0.max - q0.min) / q0.step) + 1
    values = rng.integers(-16, 16, size).astype(np.float64) * 0.25
    table = LookupTable(values)
    ft = table.float_table
    ann = QInterval(float(ft.min()), float(ft.max()), table.spec.out_qint.step)
    return SoundCase([_copy_op(0, q0), Op(0, -1, 8, 0, ann, 0.0, 1.0)], 1, (table,))


def _sample_bit_unary(rng) -> SoundCase:
    q0 = _rand_qint(rng)
    sub = int(rng.integers(0, 3))
    opc = 9 if rng.integers(0, 2) else -9
    ann = _container_qint(rng) if sub == 0 else QInterval(0.0, 1.0, 1.0)
    return SoundCase([_copy_op(0, q0), Op(0, -1, opc, sub, ann, 0.0, 1.0)], 1, None)


def _sample_bit_binary(rng) -> SoundCase:
    q0, q1 = _rand_qint(rng), _rand_qint(rng)
    shift = int(rng.integers(-2, 3))
    subop = int(rng.integers(0, 3))
    neg0, neg1 = int(rng.integers(0, 2)), int(rng.integers(0, 2))
    data = (subop << 56) | (neg1 << 33) | (neg0 << 32) | (shift & 0xFFFFFFFF)
    return SoundCase([_copy_op(0, q0), _copy_op(1, q1), Op(0, 1, 10, data, _container_qint(rng, 7), 0.0, 1.0)], 2, None)


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------


class OpSpec(NamedTuple):
    """One DAIS v1 opcode family (module docstring)."""

    key: str  # short identifier ('add', 'mux', ...)
    family: str  # family label ('add/sub', 'msb-mux', ...)
    opcodes: tuple[int, ...]
    id0: str  # 'slot' | 'lane' | 'none'
    reads_id1: bool
    cond_in_data: bool  # low 32 bits of ``data`` name an earlier slot
    vector_class: int  # level-lowering group id (dense row index)
    lower: str  # runtime/cuda_backend.LOWERINGS case name for this row
    synth_family: str | None  # ir/synth.py generator family (None: implicit)
    semantics: str
    replay: Callable  # float/symbolic semantics (CombLogic.__call__)
    kernel: Callable  # int64 reference semantics (RefState, i) -> row
    defines_container: bool  # annotation is trusted as the result interval
    shift_of: Callable[[Op], int] | None  # payload shift extraction (W106)
    payload_check: Callable | None  # (op, n_tables) -> [(rule, msg)]
    transfer: Callable  # QInterval transfer -> (computed, checks)
    sample: Callable  # rng -> SoundCase (transfer-soundness fuzz)
    mutations: tuple[MutationSpec, ...]


OP_TABLE: tuple[OpSpec, ...] = (
    OpSpec('copy', 'copy', (-1,), 'lane', False, False, 0, 'copy', None,
           'copy from input lane `id0` (implies quantization to the slot kif)', _rp_input, _rk_copy,
           True, None, None, _tf_quantize,
           _sample_copy,
           (MutationSpec('copy.bad_lane', 'W104', lambda c: mutate_op(c, (-1,), id0=c.shape[0] + 7)),)),
    OpSpec('add', 'add/sub', (0, 1), 'slot', True, False, 1, 'addsub', 'add',
           '`buf[id0] ± buf[id1] * 2**data`', _rp_shift_add, _rk_shift_add,
           False, _shift_data, None, _tf_add,
           _sample_add,
           (MutationSpec('add.forward_ref', 'W103', lambda c: _self_reference(c, (0, 1), 'id1')),
            MutationSpec('add.bad_shift', 'W106', lambda c: mutate_op(c, (0, 1), data=3000)))),
    OpSpec('relu', 'relu-quantize', (2, -2), 'slot', False, False, 2, 'relu', 'relu',
           '`quantize(relu(±buf[id0]))`', _rp_relu, _rk_relu,
           True, None, None, _tf_quantize,
           _sample_relu,
           (MutationSpec('relu.step_not_pow2', 'Q201',
                         lambda c: mutate_qint(c, (2, -2), lambda q: QInterval(q.min, q.max, q.step * 0.75))),)),
    OpSpec('quant', 'quantize', (3, -3), 'slot', False, False, 3, 'quantize', 'quant',
           '`quantize(±buf[id0])` (arithmetic shift + modular wrap)', _rp_quantize, _rk_quantize,
           True, None, None, _tf_quantize,
           _sample_quantize,
           (MutationSpec('quantize.inverted_bounds', 'Q202',
                         lambda c: mutate_qint(c, (3, -3), lambda q: QInterval(q.max + 1.0, q.min, q.step))),)),
    OpSpec('cadd', 'const-add', (4,), 'slot', False, False, 4, 'const_add', 'cadd',
           '`buf[id0] + data * qint.step` (constant add)', _rp_const_add, _rk_const_add,
           False, None, None, _tf_const_add,
           _sample_const_add,
           (MutationSpec('cadd.bias_drift', 'Q210',
                         lambda c: mutate_op(c, (4,), data=int(c.ops[_find_op(c, (4,))].data) + (1 << 16))),)),
    OpSpec('const', 'const', (5,), 'none', False, False, 5, 'const', 'const',
           'constant definition: `data * qint.step`', _rp_const, _rk_const,
           False, None, None, _tf_const,
           _sample_const,
           (MutationSpec('const.value_drift', 'Q210',
                         lambda c: mutate_op(c, (5,), data=int(c.ops[_find_op(c, (5,))].data) + (1 << 16) + 1)),)),
    OpSpec('mux', 'msb-mux', (6, -6), 'slot', True, True, 6, 'msb_mux', 'mux',
           'MSB mux: `msb(buf[cond]) ? buf[id0] : (±buf[id1]) << shift`', _rp_msb_mux, _rk_msb_mux,
           True, _shift_hi, None, _tf_trusted,
           _sample_mux,
           (MutationSpec('mux.cond_forward', 'W103', _corrupt_mux_cond),)),
    OpSpec('mul', 'mul', (7,), 'slot', True, False, 7, 'mul', 'mul',
           '`buf[id0] * buf[id1]`', _rp_mul, _rk_mul,
           False, None, None, _tf_mul,
           _sample_mul,
           (MutationSpec('mul.narrowed_interval', 'Q210',
                         lambda c: mutate_qint(c, (7,), lambda q: QInterval(q.min / 64.0, q.max / 64.0, q.step))),)),
    OpSpec('lookup', 'lut', (8,), 'slot', False, False, 8, 'lookup', 'lookup',
           '`lookup_tables[data][index(buf[id0])]`', _rp_lookup, _rk_lookup,
           True, None, _pc_lookup, _tf_lookup,
           _sample_lookup,
           (MutationSpec('lut.bad_table', 'W110', lambda c: mutate_op(c, (8,), data=99)),)),
    OpSpec('bitu', 'unary-bitwise', (9, -9), 'slot', False, False, 9, 'bit_unary', 'bitu',
           'unary bitwise on `±buf[id0]`; `data`: 0 = NOT, 1 = OR-reduce, 2 = AND-reduce',
           _rp_bit_unary, _rk_bit_unary,
           True, None, _pc_bit_unary, _tf_trusted,
           _sample_bit_unary,
           (MutationSpec('bit_unary.bad_subop', 'W111', lambda c: mutate_op(c, (9, -9), data=7)),)),
    OpSpec('bitb', 'binary-bitwise', (10,), 'slot', True, False, 10, 'bit_binary', 'bitb',
           'binary bitwise AND/OR/XOR on aligned operands', _rp_bit_binary, _rk_bit_binary,
           True, _shift_lo, _pc_bit_binary, _tf_trusted,
           _sample_bit_binary,
           (MutationSpec('bit_binary.bad_subop', 'W111', _corrupt_bitbin_subop),)),
)  # fmt: skip

#: opcode -> its table row
OPCODE_TO_SPEC: dict[int, OpSpec] = {oc: spec for spec in OP_TABLE for oc in spec.opcodes}

#: every opcode of the DAIS v1 table
DAIS_V1_OPCODES = frozenset(OPCODE_TO_SPEC)

#: opcodes whose id1 names a second operand slot
BINARY_OPCODES = frozenset(oc for oc, spec in OPCODE_TO_SPEC.items() if spec.reads_id1)

#: opcodes whose id0 names an input lane rather than an SSA slot
COPY_OPCODES = frozenset(oc for oc, spec in OPCODE_TO_SPEC.items() if spec.id0 == 'lane')

#: opcode -> level-lowering group (dense row index of the table)
VECTOR_CLASS: dict[int, int] = {oc: spec.vector_class for oc, spec in OPCODE_TO_SPEC.items()}

if [spec.vector_class for spec in OP_TABLE] != list(range(len(OP_TABLE))):
    raise RuntimeError('opcode table vector classes must be the dense row indices')


def spec_of(opcode: int) -> OpSpec | None:
    """Table row for ``opcode`` (None for an unknown opcode)."""
    return OPCODE_TO_SPEC.get(int(opcode))


def family_of(opcode: int | None) -> str | None:
    """Stable family label of ``opcode`` (None when unknown/absent)."""
    if opcode is None:
        return None
    spec = OPCODE_TO_SPEC.get(int(opcode))
    return spec.family if spec is not None else None


def op_shift(op: Op) -> int | None:
    """The power-of-two shift an op applies to its second operand, if any."""
    spec = OPCODE_TO_SPEC.get(op.opcode)
    if spec is None or spec.shift_of is None:
        return None
    return spec.shift_of(op)


def op_operands(op: Op) -> list[int]:
    """Buffer slots an op reads (input lanes of copy ops are *not* slots)."""
    spec = OPCODE_TO_SPEC.get(op.opcode)
    reads: list[int] = []
    if spec is None:
        return reads
    if spec.id0 == 'slot':
        reads.append(int(op.id0))
    if spec.reads_id1:
        reads.append(int(op.id1))
    if spec.cond_in_data:
        reads.append(int(op.data) & 0xFFFFFFFF)
    return reads


__all__ = [
    'OP_TABLE',
    'OPCODE_TO_SPEC',
    'DAIS_V1_OPCODES',
    'BINARY_OPCODES',
    'COPY_OPCODES',
    'VECTOR_CLASS',
    'SHIFT_LIMIT',
    'OpSpec',
    'MutationSpec',
    'SoundCase',
    'RefState',
    'spec_of',
    'family_of',
    'op_shift',
    'op_operands',
    'i32',
    'mutate_op',
    'mutate_qint',
    'ref_shl',
    'ref_wrap',
    'ref_quantize',
    'ref_msb',
]
