"""Symbolic scalar fixed-point value — the tracing primitive.

A ``FixedVariable`` is an exact value interval ``[low, high]`` on a
power-of-two grid ``step``, held in ``Decimal`` so interval algebra never
rounds. On top of the interval it carries:

* ``_factor`` — a free power-of-two scale (sign included). Shifts and
  negations are free in hardware, so they accumulate here instead of
  producing ops; the lowering (tracer.py) folds the factor into each op's
  shift field / opcode sign.
* ``opr`` + ``_from`` — the producing operation and its operand links;
  arithmetic on variables eagerly grows this graph.
* ``latency`` / ``cost`` — when the value is available and what producing
  it costs, from the rule registry at the bottom of this file. The
  latency model implements pipeline-stage snapping: an op whose delay
  crosses a ``latency_cutoff`` boundary starts at the next stage instead.

Counterpart of ``da4ml_tpu/trace/fixed_variable.py``: interval updates,
cadd folding, CSD constant multiplication, the msb_mux peepholes, lookups,
bit ops and the quantize lowering are the same rules, so the graphs they
build are identical.
"""

from __future__ import annotations

import itertools
from collections.abc import Callable
from decimal import Decimal
from math import ceil, floor, log2
from typing import NamedTuple

import numpy as np

from ..cmvm.cost import cost_add
from ..ir.lut import LookupTable
from ..ir.types import QInterval

_next_id = itertools.count(1)


class HWConfig(NamedTuple):
    """(adder_size, carry_size, latency_cutoff) — cost model + pipelining config."""

    adder_size: int
    carry_size: int
    latency_cutoff: float


class TraceContext:
    """Process-wide lookup-table registry, deduplicated by content hash."""

    def __init__(self):
        self._by_hash: dict[str, tuple[LookupTable, int]] = {}
        self._by_index: dict[int, LookupTable] = {}

    def register_table(self, table: LookupTable | np.ndarray) -> tuple[LookupTable, int]:
        if isinstance(table, np.ndarray):
            table = LookupTable(table)
        key = table.spec.hash
        hit = self._by_hash.get(key)
        if hit is None:
            hit = (table, len(self._by_hash))
            self._by_hash[key] = hit
            self._by_index[hit[1]] = table
        return hit

    def get_table_from_index(self, index: int) -> LookupTable:
        try:
            return self._by_index[index]
        except KeyError:
            raise KeyError(f'No table with index {index}') from None


table_context = TraceContext()

# ---------------------------------------------------------------------------
# Exact power-of-two arithmetic helpers
# ---------------------------------------------------------------------------

_TWO = Decimal(2)


def _pow2(e: int) -> Decimal:
    return _TWO**e


def _snap(x: Decimal, step: Decimal) -> Decimal:
    """Truncate x down onto the `step` grid."""
    return floor(x / step) * step


def const_f(value: float | Decimal) -> int:
    """Fraction bits of a constant: the smallest f with value·2^f integral.

    Every float is a dyadic rational n/d, so f falls straight out of
    ``as_integer_ratio``: log2(d) minus the trailing zeros of n.  The result
    is clamped to [-31, 32] (and 0 maps to -32), matching the bisection
    window the reference solver uses — constants with more than 32 fraction
    bits are treated as 32-bit approximations downstream.
    """
    v = float(value)
    if v == 0:
        return -32
    num, den = v.as_integer_ratio()
    num = abs(num)
    trailing = (num & -num).bit_length() - 1
    return min(32, max(-31, den.bit_length() - 1 - trailing))


def csd_terms(x: float):
    """Signed power-of-two terms of x's canonical signed-digit form, most
    significant first.  Fractions deeper than the const_f window are
    truncated, like the reference encoder."""
    if x == 0:
        return
    frac = const_f(abs(x))
    unit = 2.0**-frac
    resid = x * 2.0**frac
    top = ceil(log2(abs(resid) * 1.5 + 1e-19))
    for b in reversed(range(top)):
        w = float(2**b)
        gate = w / 1.5
        digit = (resid > gate) - (resid < -gate)
        if digit:
            resid -= digit * w
            yield digit * w * unit


# kept under the historical name for callers of the CSD generator
to_csd_powers = csd_terms


class FixedVariable:
    __is_input__ = False

    __slots__ = ('low', 'high', 'step', '_factor', '_from', 'opr', '_data', 'id', 'hwconf', 'latency', 'cost')

    def __init__(
        self,
        low,
        high,
        step,
        latency: float | None = None,
        hwconf: HWConfig | tuple = HWConfig(-1, -1, -1),
        opr: str = 'new',
        cost: float | None = None,
        _from: tuple['FixedVariable', ...] = (),
        _factor=1.0,
        _data: Decimal | None = None,
        _id: int | None = None,
    ):
        if not self.__is_input__ and low > high:
            raise AssertionError(f'degenerate interval: low {low} > high {high}')
        if opr == 'const' and low != high:
            raise ValueError('Constant variable must have low == high')
        if low == high:
            # point intervals collapse to constants on their natural grid
            opr, _from = 'const', ()
            step = _pow2(-const_f(low))
        if opr == 'cadd' and _data is None:
            raise AssertionError('cadd requires its addend in _data')

        self.low = Decimal(low)
        self.high = Decimal(high)
        self.step = Decimal(step)
        self._factor = Decimal(_factor)
        self._from = _from
        self.opr = opr
        self._data = _data
        self.id = _id if _id is not None else next(_next_id)
        self.hwconf = HWConfig(*hwconf)

        if cost is None or latency is None:
            cost, latency = self.get_cost_and_latency()
        self.latency = latency
        self.cost = cost

        # constants inherit the consumer's latency so they never pin stage 0
        self._from = tuple(v if v.opr != 'const' else v._with(latency=self.latency) for v in self._from)

    # ------------------------------------------------------------- basics

    def _with(self, renew_id: bool = True, **kwargs) -> 'FixedVariable':
        if not kwargs:
            return self
        var = FixedVariable.__new__(type(self))
        for slot in FixedVariable.__slots__:
            object.__setattr__(var, slot, getattr(self, slot))
        for k, v in kwargs.items():
            object.__setattr__(var, k, v)
        if renew_id:
            var.id = next(_next_id)
        return var

    @property
    def qint(self) -> QInterval:
        return QInterval(float(self.low), float(self.high), float(self.step))

    @property
    def kif(self) -> tuple[bool, int, int]:
        if self.step == 0:
            return False, 0, 0
        reach = max(-self.low, self.high + self.step)
        return self.low < 0, ceil(log2(reach)), -int(log2(self.step))

    @property
    def unscaled(self) -> 'FixedVariable':
        return self * (1 / self._factor)

    @classmethod
    def from_const(cls, const, hwconf: HWConfig, _factor=1):
        if not isinstance(const, Decimal):
            const = float(const)
        return FixedVariable(const, const, -1, hwconf=hwconf, opr='const', _factor=_factor)

    @classmethod
    def from_kif(cls, k, i: int, f: int, **kwargs):
        step, span = _pow2(-f), _pow2(i)
        return cls(-int(k) * span, span - step, step, **kwargs)

    def __repr__(self):
        scale = f'({self._factor}) ' if self._factor != 1 else ''
        return f'{scale}FixedVariable({self.low}, {self.high}, {self.step})'

    def get_cost_and_latency(self) -> tuple[float, float]:
        """Dispatch into the per-operation rule registry (end of file)."""
        rule = _COST_RULES.get(self.opr)
        if rule is None:
            raise NotImplementedError(f'Operation {self.opr} is unknown')
        return rule(self)

    # ------------------------------------------------------------- algebra

    def __neg__(self):
        # free: flip the interval and the factor sign, keep identity
        return FixedVariable(
            -self.high,
            -self.low,
            self.step,
            _from=self._from,
            _factor=-self._factor,
            latency=self.latency,
            cost=self.cost,
            opr=self.opr if self.low != self.high else 'const',
            _id=self.id,
            _data=self._data,
            hwconf=self.hwconf,
        )

    def __add__(self, other):
        if not isinstance(other, FixedVariable):
            return self._add_const(other)
        if other.low == other.high:
            return self._add_const(other.low)
        if self.low == self.high:
            return other._add_const(self.low)
        if self.hwconf != other.hwconf:
            raise AssertionError(f'cannot add across hw configs {self.hwconf} / {other.hwconf}')

        # canonical form: the anchoring (left) operand has a positive factor
        if self._factor < 0:
            return other + self if other._factor > 0 else -((-self) + (-other))

        return FixedVariable(
            self.low + other.low,
            self.high + other.high,
            min(self.step, other.step),
            _from=(self, other),
            _factor=self._factor,
            opr='vadd',
            hwconf=self.hwconf,
        )

    def _add_const(self, addend):
        if addend is None:
            return self
        if not isinstance(addend, (int, float, Decimal)):
            addend = float(addend)  # numpy scalars don't convert to Decimal directly
        addend = Decimal(addend)
        if addend == 0:
            return self

        if self.opr == 'cadd':
            # fold into the parent's existing constant add: one cadd total
            (parent,) = self._from
            assert self._data is not None
            rescale = self._factor / parent._factor
            merged = self._data * parent._factor + addend / rescale
            return (parent + merged) * rescale

        return FixedVariable(
            self.low + addend,
            self.high + addend,
            min(self.step, _pow2(-const_f(addend))),
            _from=(self,),
            _factor=self._factor,
            _data=addend / self._factor,
            opr='cadd',
            hwconf=self.hwconf,
        )

    def __radd__(self, other):
        return self + other

    def __sub__(self, other):
        return self + (-other)

    def __rsub__(self, other):
        return (-self) + other

    def __truediv__(self, other):
        assert not isinstance(other, FixedVariable), 'Division by a variable is not supported'
        return self * (1 / other)

    def __mul__(self, other):
        if isinstance(other, FixedVariable):
            if self.low == self.high:
                return other * self.low
            if other.high > other.low:
                return self._mul_var(other)
            other = float(other.low)  # point interval: constant multiply

        if self.low == self.high:
            return self.from_const(float(self.low) * float(other), hwconf=self.hwconf)
        if np.all(other == 0):
            return FixedVariable(0, 0, 1, hwconf=self.hwconf, opr='const')
        if log2(abs(other)) % 1 == 0:
            return self._rescale(other)

        # general constant: expand into CSD shift terms, then sum pairwise
        # from the small end, requantizing each partial onto its exact range
        terms = [(self._rescale(w), Decimal(w)) for w in csd_terms(float(other))]
        while len(terms) > 1:
            va, wa = terms.pop()
            vb, wb = terms.pop()
            acc, w = va + vb, wa + wb
            bounds = (float(self.low * w), float(self.high * w))
            lo, hi = min(bounds), max(bounds)
            step = float(acc.step)
            width = ceil(log2(max(-lo, hi + step)))
            acc = acc.quantize(lo < 0, width, -int(log2(step)))
            terms.append((acc, w))
        return terms[0][0]

    def __rmul__(self, other):
        return self * other

    def _mul_var(self, other: 'FixedVariable') -> 'FixedVariable':
        if other is self:
            # squaring: extremes are the squared endpoints, plus 0 if spanned
            ends = [self.low * self.low, self.high * self.high]
            if self.low < 0 < self.high:
                ends.append(Decimal(0))
        else:
            ends = [
                self.low * other.low,
                self.low * other.high,
                self.high * other.low,
                self.high * other.high,
            ]
        return FixedVariable(
            min(ends),
            max(ends),
            self.step * other.step,
            _from=(self, other),
            hwconf=self.hwconf,
            _factor=self._factor * other._factor,
            opr='vmul',
        )

    def _rescale(self, scale) -> 'FixedVariable':
        """Multiply by a power of two (sign allowed): free, identity-preserving."""
        scale = Decimal(scale)
        ends = (self.low * scale, self.high * scale)
        return FixedVariable(
            min(ends),
            max(ends),
            abs(self.step * scale),
            _from=self._from,
            _factor=self._factor * scale,
            opr=self.opr,
            latency=self.latency,
            cost=self.cost,
            _id=self.id,
            _data=self._data,
            hwconf=self.hwconf,
        )

    def __lshift__(self, n: int):
        assert isinstance(n, int)
        return self * 2.0**n

    def __rshift__(self, n: int):
        assert isinstance(n, int)
        return self * 2.0**-n

    def __pow__(self, other):
        p = int(other)
        assert p == other and p >= 0, 'Power must be a non-negative integer'
        if p == 0:
            return FixedVariable(1, 1, 1, hwconf=self.hwconf, opr='const')
        if p == 1:
            return self
        out = (self ** (p // 2)) * (self ** (p - p // 2))
        if other % 2 == 0:
            out.low = max(out.low, Decimal(0))
        return out

    # ------------------------------------------------------ nonlinearities

    def _assert_integral_bits(self, *bits):
        out = []
        for b in bits:
            if b is not None:
                # integral numpy/float counts are fine (Decimal ** float is
                # not); fractional ones fail loudly instead of truncating
                assert b == int(b), f'bit count must be integral, got {b!r}'
                b = int(b)
            out.append(b)
        return out

    def relu(self, i: int | None = None, f: int | None = None, round_mode: str = 'TRN'):
        round_mode = round_mode.upper()
        assert round_mode in ('TRN', 'RND')
        i, f = self._assert_integral_bits(i, f)

        if self.opr == 'const':
            val = self.low * (self.low > 0)
            f = const_f(val) if f is None else f
            step = _pow2(-f)
            i = ceil(log2(val + step)) if i is None else i
            half = step / 2 if round_mode == 'RND' else 0
            return self.from_const((floor(val / step + half) * step) % _pow2(i), hwconf=self.hwconf)

        step = max(_pow2(-f), self.step) if f is not None else self.step
        if step > self.step and round_mode == 'RND':
            # round-half-up = bias by half an lsb, then truncate
            return (self + step / 2).relu(i, f, 'TRN')

        low = _snap(max(Decimal(0), self.low), step)
        high = _snap(self.high, step)
        if i is not None and high > _pow2(i) - step:
            # output wraps: the full representable range survives
            low, high = Decimal(0), _pow2(i) - step
        high = max(Decimal(0), high)

        if (low, high, step) == (self.low, self.high, self.step):
            return self

        return FixedVariable(
            low,
            high,
            step,
            _from=(self,),
            _factor=abs(self._factor),
            opr='relu',
            hwconf=self.hwconf,
            cost=sum(self.kif) * (1 if self._factor > 0 else 2),
        )

    def quantize(
        self,
        k: int | bool,
        i: int,
        f: int,
        overflow_mode: str = 'WRAP',
        round_mode: str = 'TRN',
        force_wrap: bool = False,
    ) -> 'FixedVariable':
        overflow_mode, round_mode = overflow_mode.upper(), round_mode.upper()
        assert overflow_mode in ('WRAP', 'SAT', 'SAT_SYM')
        assert round_mode in ('TRN', 'RND')
        k, i, f = int(k), int(i), int(f)

        if k + i + f <= 0:
            return FixedVariable(0, 0, 1, hwconf=self.hwconf, opr='const')
        k0, i0, f0 = self.kif

        # no-op when the request strictly widens (SAT_SYM additionally needs
        # the symmetric low end to already be representable)
        if k >= k0 and i >= i0 and f >= f0 and not force_wrap:
            if overflow_mode != 'SAT_SYM' or i > i0:
                return self

        if f < f0 and round_mode == 'RND':
            # round-half-up: bias then truncate
            return (self + 2.0 ** (-f - 1)).quantize(k, i, f, overflow_mode, 'TRN')

        if overflow_mode != 'WRAP':
            # saturation = clip into range, then WRAP is exact
            step, span = _pow2(-f), _pow2(i)
            hi = span - step
            lo = -span * k if overflow_mode == 'SAT' else -hi * k
            ff = f + 1 if round_mode == 'RND' else f
            v = self.quantize(k0, i0, ff, 'WRAP', 'TRN') if k0 + i0 + ff > 0 else self
            return v.max_of(lo).min_of(hi).quantize(k, i, f, 'WRAP', round_mode)

        if self.low == self.high:
            step, span = _pow2(-f), _pow2(i)
            lo = -span * k
            val = (_snap(self.low, step) - lo) % (2 * span) + lo
            return FixedVariable.from_const(val, hwconf=self.hwconf, _factor=1)

        # WRAP on a genuine interval: narrow the request to what the value
        # can actually produce before building the op
        f = min(f, f0)
        k = min(k, k0) if i >= i0 else k
        step = _pow2(-f)
        if self.low < 0:
            i0 = max(i0, ceil(log2(-_snap(self.low, step))))
        i = min(i, i0 + (k == 0 and k0 == 1))
        if i + k + f <= 0:
            return FixedVariable(0, 0, 1, hwconf=self.hwconf, opr='const')

        low = -int(k) * _pow2(i)
        high = _pow2(i) - step
        if self.low >= low and self.high <= high:
            # in range: the snapped source interval is the tighter truth
            low, high = _snap(self.low, step), _snap(self.high, step)

        return FixedVariable(
            low,
            high,
            step,
            _from=(self,),
            _factor=abs(self._factor),
            opr='wrap',
            latency=self.latency,
            hwconf=self.hwconf,
        )

    # ------------------------------------------------------------ branching

    def msb_mux(self, a, b, qint=None, zt_sensitive: bool = True):
        """MSB(self) ? a : b — for signed values the MSB is the sign bit."""
        if not isinstance(a, FixedVariable):
            a = FixedVariable.from_const(a, hwconf=self.hwconf, _factor=1)
        if not isinstance(b, FixedVariable):
            b = FixedVariable.from_const(b, hwconf=self.hwconf, _factor=1)

        if self._factor < 0:
            # a negated selector flips which MSB we see; reduce to the
            # canonical positive-factor form
            if zt_sensitive:
                return self.msb().msb_mux(a, b, qint)
            return (-self).msb_mux(b, a, qint, zt_sensitive=False)

        if self.opr == 'const':
            return a if _const_msb_set(self.low, self.high) else b

        if self.opr == 'wrap':
            # see-through: when the wrap preserved the sign-significant bit,
            # mux directly on its source
            src = self._from[0]
            k, i, _ = self.kif
            k0, i0, _ = src.kif
            if k + i == k0 + i0 + log2(abs(self._factor / src._factor)):
                if self._factor * src._factor > 0 or not zt_sensitive:
                    return src.msb_mux(a, b, qint=qint, zt_sensitive=zt_sensitive)

        if a._factor < 0:
            # normalize the taken branch to a positive factor
            qint = (-qint[1], -qint[0], qint[2]) if qint else None
            return -(self.msb_mux(-a, -b, qint=qint, zt_sensitive=zt_sensitive))

        if qint is None:
            qint = (float(min(a.low, b.low)), float(max(a.high, b.high)), float(min(a.step, b.step)))
        else:
            lo, hi, want_step = qint
            step = float(min(a.step, b.step))
            assert want_step <= step, f'msb_mux cannot imply rounding: step {want_step} > operand step {step}'
            lo = max(floor(lo / step) * step, float(min(a.low, b.low)))
            hi = min(floor(hi / step) * step, float(max(a.high, b.high)))
            qint = (lo, hi, step)

        dlat, dcost = cost_add(a.qint, b.qint, 0, False, self.hwconf.adder_size, self.hwconf.carry_size)

        factor = a._factor
        if a.opr == 'const' and a._factor != b._factor:
            factor = b._factor
            a = a._with(_factor=b._factor, renew_id=True)
        if b.opr == 'const' and a._factor != b._factor:
            factor = a._factor
            b = b._with(_factor=a._factor, renew_id=True)

        return FixedVariable(
            *qint,
            _from=(self, a, b),
            _factor=factor,
            opr='msb_mux',
            latency=max(a.latency, b.latency, self.latency) + dlat,
            hwconf=self.hwconf,
            cost=dcost / 2,
        )

    def msb(self) -> 'FixedVariable':
        k, i, _ = self.kif
        width = i + k
        return self.quantize(0, width, 1 - width, force_wrap=True) >> (width - 1)

    def is_negative(self) -> 'FixedVariable':
        if self.low >= 0:
            return self.from_const(0, hwconf=self.hwconf)
        if self.high < 0:
            return self.from_const(1, hwconf=self.hwconf)
        return self.msb()

    def is_positive(self) -> 'FixedVariable':
        return (-self).is_negative()

    def __abs__(self):
        if self.low >= 0:
            return self
        bound = max(-self.low, self.high)
        return self.msb_mux(-self, self, (0, float(bound), float(self.step)), zt_sensitive=False)

    def abs(self):
        return abs(self)

    def __gt__(self, other):
        return (self - other).is_positive()

    def __lt__(self, other):
        return (other - self).is_positive()

    def __ge__(self, other):
        return ~(self - other).is_negative()

    def __le__(self, other):
        return ~(other - self).is_negative()

    def max_of(self, other):
        if other == -float('inf'):
            return self
        if other == float('inf'):
            raise ValueError('Cannot apply max_of with inf')
        if not isinstance(other, FixedVariable):
            other = FixedVariable.from_const(other, hwconf=self.hwconf, _factor=abs(self._factor))
        if self.low >= other.high:
            return self
        if self.high <= other.low:
            return other
        if other.low == 0 and other.high == 0:
            return self.relu()
        qint = (float(max(self.low, other.low)), float(max(self.high, other.high)), float(min(self.step, other.step)))
        return (self - other).msb_mux(other, self, qint=qint, zt_sensitive=False)

    def min_of(self, other):
        if other == float('inf'):
            return self
        if other == -float('inf'):
            raise ValueError('Cannot apply min_of with -inf')
        if not isinstance(other, FixedVariable):
            other = FixedVariable.from_const(other, hwconf=self.hwconf, _factor=self._factor)
        if self.high <= other.low:
            return self
        if self.low >= other.high:
            return other
        if other.low == 0 and other.high == 0:
            return -(-self).relu()
        qint = (float(min(self.low, other.low)), float(min(self.high, other.high)), float(min(self.step, other.step)))
        return (self - other).msb_mux(self, other, qint=qint, zt_sensitive=False)

    # ---------------------------------------------------------------- LUTs

    def lookup(self, table: LookupTable | np.ndarray, original_qint=None) -> 'FixedVariable':
        """Map this variable through a lookup table.

        numpy tables start at the variable's lowest possible value; a provided
        ``original_qint`` re-slices the table to this variable's interval.
        """
        size = len(table)
        was_numpy = isinstance(table, np.ndarray)
        if original_qint is not None:
            o_min, o_max, o_step = original_qint
            assert round((o_max - o_min) / o_step) + 1 == size, f'table size {size} != original qint {original_qint}'
            v_min, v_max, v_step = self.qint
            assert o_step <= v_step and o_max >= v_max and o_min <= v_min, (
                f'Original qint {original_qint} does not cover the variable {self.qint}'
            )
            head = round((v_min - o_min) / o_step)
            tail = round((o_max - v_max) / o_step)
            stride = round(v_step / o_step)
            values = table.float_table if isinstance(table, LookupTable) else np.asarray(table, dtype=np.float64)
            table = values[head : size - tail : stride]
            size = len(table)

        index_space = round((self.high - self.low) / self.step) + 1
        assert index_space == size, f'Variable index space ({index_space}) != table size ({size})'

        if was_numpy and isinstance(table, np.ndarray):
            if size == 1:
                return self.from_const(float(table[0]), hwconf=self.hwconf)
            if self._factor < 0:
                table = table[::-1]

        entry, table_id = table_context.register_table(table)
        out = entry.spec.out_qint
        return FixedVariable(
            out.min,
            out.max,
            out.step,
            _from=(self,),
            _factor=Decimal(1),
            opr='lookup',
            hwconf=self.hwconf,
            _data=Decimal(table_id),
        )

    # ------------------------------------------------------------- bit ops

    def unary_bit_op(self, _type: str):
        code = _UNARY_BIT_CODES[_type]
        if self.opr == 'const':
            from ..ops.numeric import numeric_unary_bit_op

            return self.from_const(numeric_unary_bit_op(float(self.low), code, self.qint), hwconf=self.hwconf)

        if sum(self.kif) == 1 and _type != 'not':
            return self.msb()  # any/all of a single bit is that bit

        if _type == 'not':
            k, i, f = self.kif
            return FixedVariable.from_kif(
                k, i, f, hwconf=self.hwconf, opr='bit_unary', _data=Decimal(code), _from=(self,), _factor=abs(self._factor)
            )
        if _type == 'all':
            if self.low > 0 or self.high < -self.step:
                return self.from_const(0, hwconf=self.hwconf)
            if self.low == 0 and log2(self.high + self.step) % 1 != 0:
                # the all-ones code does not occur in this interval
                return self.from_const(0, hwconf=self.hwconf)
        return FixedVariable(
            0, 1, 1, hwconf=self.hwconf, opr='bit_unary', _data=Decimal(code), _from=(self,), _factor=abs(self._factor)
        )

    def binary_bit_op(self, other: 'FixedVariable', _type: str):
        code = _BINARY_BIT_CODES[_type]
        k0, i0, f0 = self.kif
        k1, i1, f1 = other.kif
        k, i, f = max(k0, k1), max(i0, i1), max(f0, f1)
        qint = QInterval(-k * 2.0**i, 2.0**i - 2.0**-f, 2.0**-f)

        if self.opr == 'const' and other.opr == 'const':
            from ..ops.numeric import numeric_binary_bit_op

            v = numeric_binary_bit_op(float(self.low), float(other.low), code, self.qint, other.qint, qint)
            return self.from_const(v, hwconf=self.hwconf)
        if self.opr == 'const' and self.low == 0:
            return self if _type == 'and' else other  # 0 absorbs / passes
        if other.opr == 'const' and other.low == 0:
            return other.binary_bit_op(self, _type)

        return FixedVariable(
            *qint, hwconf=self.hwconf, opr='bit_binary', _data=Decimal(code), _from=(self, other), _factor=abs(self._factor)
        )

    def _coerce(self, other):
        if not isinstance(other, FixedVariable):
            other = FixedVariable.from_const(other, hwconf=self.hwconf, _factor=abs(self._factor))
        return other

    def __and__(self, other):
        return self.binary_bit_op(self._coerce(other), 'and')

    def __or__(self, other):
        return self.binary_bit_op(self._coerce(other), 'or')

    def __xor__(self, other):
        return self.binary_bit_op(self._coerce(other), 'xor')

    __rand__ = __and__
    __ror__ = __or__
    __rxor__ = __xor__

    def __invert__(self):
        return self.unary_bit_op('not')

    def _ne(self, other):
        return (self - self._coerce(other)).unary_bit_op('any')

    def _eq(self, other):
        return ~(self._ne(other))


_UNARY_BIT_CODES = {'not': 0, 'any': 1, 'all': 2}
_BINARY_BIT_CODES = {'and': 0, 'or': 1, 'xor': 2}


def _const_msb_set(low: Decimal, high: Decimal) -> bool:
    """Whether a constant's MSB reads 1: negatives whose stored code keeps the
    sign bit (exact powers of two are the boundary), or any positive value."""
    if low >= 0:
        return high != 0
    return log2(abs(low)) % 1 != 0


# ---------------------------------------------------------------------------
# Cost / latency rule registry
# ---------------------------------------------------------------------------

_COST_RULES: dict[str, Callable[[FixedVariable], tuple[float, float]]] = {}


def _rule(*oprs: str):
    def register(fn):
        for o in oprs:
            _COST_RULES[o] = fn
        return fn

    return register


def _stage_snap(base: float, dlat: float, cutoff: float) -> float:
    """Availability time of an op with delay ``dlat`` whose operands arrive at
    ``base``: if the op would straddle a pipeline-stage boundary, it starts at
    the next boundary instead (the retimer relies on this AssertionError)."""
    latency = base + dlat
    if cutoff > 0 and ceil(latency / cutoff) > ceil(base / cutoff):
        assert dlat <= cutoff, f'Latency of an atomic operation {dlat} exceeds the pipelining latency cutoff {cutoff}'
        latency = ceil(base / cutoff) * cutoff + dlat
    return latency


@_rule('const', 'new')
def _free(v: FixedVariable):
    return 0.0, 0.0


@_rule('lookup')
def _lut_cost(v: FixedVariable):
    (src,) = v._from
    b_in, b_out = sum(src.kif), sum(v.kif)
    # LUT6 trees with the shared O5 output: one level past 6 input bits
    cost = 2 ** max(b_in - 5, 0) * ceil(b_out / 2)
    if b_in < 5:
        cost *= b_in / 5
    return cost, max(b_in - 6, 1) + src.latency


@_rule('vadd', 'min', 'max')
def _add_cost(v: FixedVariable):
    a, b = v._from
    dlat, cost = cost_add(a.qint, b.qint, 0, False, v.hwconf.adder_size, v.hwconf.carry_size)
    return cost, _stage_snap(max(a.latency, b.latency), dlat, v.hwconf.latency_cutoff)


@_rule('cadd')
def _cadd_cost(v: FixedVariable):
    assert v._data is not None
    frac = const_f(v._data)
    cost = float(ceil(log2(abs(v._data) + _pow2(-frac)))) + frac
    return cost, _stage_snap(v._from[0].latency, 0.0, v.hwconf.latency_cutoff)


@_rule('vmul')
def _vmul_cost(v: FixedVariable):
    a, b = v._from
    wa, wb = sum(a.kif), sum(b.kif)
    dlat_a, cost_a = cost_add(a.qint, a.qint, 0, False, v.hwconf.adder_size, v.hwconf.carry_size)
    dlat_b, cost_b = cost_add(b.qint, b.qint, 0, False, v.hwconf.adder_size, v.hwconf.carry_size)
    dlat = max(dlat_a * wb, dlat_b * wa)
    cost = min(cost_a * wb, cost_b * wa)
    return cost, _stage_snap(max(a.latency, b.latency), dlat, v.hwconf.latency_cutoff)


@_rule('relu', 'wrap')
def _clip_cost(v: FixedVariable):
    (src,) = v._from
    # LUT5 pairs sharing a LUT6: half a LUT per output bit touched
    cost = sum(v.kif) / 2 * ((src._factor < 0) + (v.opr == 'relu'))
    return cost, src.latency


@_rule('bit_binary')
def _bitbin_cost(v: FixedVariable):
    return sum(v.kif) * 0.2, 1.0 + max(p.latency for p in v._from)


@_rule('bit_unary')
def _bituna_cost(v: FixedVariable):
    if v._data == 0:  # NOT is free: invert at the consumer
        return 0.0, v._from[0].latency
    return sum(v._from[0].kif) / 6, 1.0 + max(p.latency for p in v._from)


class FixedVariableInput(FixedVariable):
    """Unquantized input sentinel.

    Carries an inverted (empty) interval; the only legal operation is
    ``quantize``, which *widens* the recorded input precision so the traced
    program's input format covers every precision the model ever requested.
    """

    __is_input__ = True

    def __init__(self, latency: float | None = None, hwconf: HWConfig | tuple = HWConfig(-1, -1, -1), opr: str = 'new'):
        super().__init__(
            low=Decimal(1e10),
            high=Decimal(-1e10),
            step=Decimal(1e10),
            latency=latency if latency is not None else 0.0,
            hwconf=HWConfig(*hwconf),
            opr=opr,
            cost=0.0,
            _factor=Decimal(1),
        )

    def _refuse(self, *a, **k):
        raise ValueError('Cannot operate on unquantized input variable')

    def __add__(self, other):
        if not isinstance(other, FixedVariable) and other == 0:
            return self
        raise ValueError('Cannot operate on unquantized input variable')

    __radd__ = __add__

    def __sub__(self, other):
        if not isinstance(other, FixedVariable) and other == 0:
            return self
        raise ValueError('Cannot operate on unquantized input variable')

    def __rsub__(self, other):
        raise ValueError('Cannot operate on unquantized input variable')

    def __neg__(self):
        raise ValueError('Cannot negate unquantized input variable')

    def __mul__(self, other):
        if not isinstance(other, FixedVariable) and other == 1:
            return self
        raise ValueError('Cannot multiply unquantized input variable')

    __rmul__ = __mul__

    def relu(self, *args, **kwargs):
        raise ValueError('Cannot apply relu on unquantized input variable')

    def max_of(self, other):
        raise ValueError('Cannot apply max_of on unquantized input variable')

    def min_of(self, other):
        raise ValueError('Cannot apply min_of on unquantized input variable')

    def quantize(self, k, i, f, overflow_mode: str = 'WRAP', round_mode: str = 'TRN', force_wrap=False):
        assert overflow_mode == 'WRAP', 'Input quantization must use WRAP'
        k, i, f = self._assert_integral_bits(k, i, f)
        if k + i + f <= 0:
            return FixedVariable(0, 0, 1, hwconf=self.hwconf, opr='const')
        if round_mode == 'RND':
            return (self.quantize(k, i, f + 1) + 2.0 ** (-f - 1)).quantize(k, i, f, overflow_mode, 'TRN')

        step, span = _pow2(-f), _pow2(i)
        low, high = -span * int(k), span - step
        # widen the recorded input precision to cover this request
        self.high = max(self.high, high)
        self.low = min(self.low, low)
        self.step = min(self.step, step)

        return FixedVariable(
            low,
            high,
            step,
            _from=(self,),
            _factor=self._factor,
            opr='wrap',
            latency=self.latency,
            hwconf=self.hwconf,
        )
