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
  it costs, from the rule registry at the bottom of this file.

Counterpart of ``da4ml_tpu/trace/fixed_variable.py``, cut to what the port's
first slice traces: input quantization, add/sub, constant add and constant
(CSD) multiplication, relu and wrap-quantize. Lookups, muxes, bitwise ops and
variable products are not ported yet; the rules below are the reference's, so
the graphs they build are identical.
"""

from __future__ import annotations

import itertools
from collections.abc import Callable
from decimal import Decimal
from math import ceil, floor, log2
from typing import NamedTuple

import numpy as np

from ..cmvm.cost import cost_add
from ..ir.types import QInterval

_next_id = itertools.count(1)


class HWConfig(NamedTuple):
    """(adder_size, carry_size, latency_cutoff) — cost model + pipelining config."""

    adder_size: int
    carry_size: int
    latency_cutoff: float


_TWO = Decimal(2)


def _pow2(e: int) -> Decimal:
    return _TWO**e


def _snap(x: Decimal, step: Decimal) -> Decimal:
    """Truncate x down onto the `step` grid."""
    return floor(x / step) * step


def const_f(value: float | Decimal) -> int:
    """Fraction bits of a constant: the smallest f with value·2^f integral,
    clamped to [-31, 32] (0 maps to -32)."""
    v = float(value)
    if v == 0:
        return -32
    num, den = v.as_integer_ratio()
    num = abs(num)
    trailing = (num & -num).bit_length() - 1
    return min(32, max(-31, den.bit_length() - 1 - trailing))


def csd_terms(x: float):
    """Signed power-of-two terms of x's canonical signed-digit form, most
    significant first."""
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
                raise NotImplementedError('variable x variable products are not ported to da4ml_tpu_torch yet')
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
        if overflow_mode != 'WRAP':
            raise NotImplementedError(f'{overflow_mode} quantization is not ported to da4ml_tpu_torch yet (WRAP only)')
        assert round_mode in ('TRN', 'RND')
        k, i, f = int(k), int(i), int(f)

        if k + i + f <= 0:
            return FixedVariable(0, 0, 1, hwconf=self.hwconf, opr='const')
        k0, i0, f0 = self.kif

        # no-op when the request strictly widens
        if k >= k0 and i >= i0 and f >= f0 and not force_wrap:
            return self

        if f < f0 and round_mode == 'RND':
            # round-half-up: bias then truncate
            return (self + 2.0 ** (-f - 1)).quantize(k, i, f, overflow_mode, 'TRN')

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
    the next boundary instead."""
    latency = base + dlat
    if cutoff > 0 and ceil(latency / cutoff) > ceil(base / cutoff):
        assert dlat <= cutoff, f'Latency of an atomic operation {dlat} exceeds the pipelining latency cutoff {cutoff}'
        latency = ceil(base / cutoff) * cutoff + dlat
    return latency


@_rule('const', 'new')
def _free(v: FixedVariable):
    return 0.0, 0.0


@_rule('vadd')
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


@_rule('relu', 'wrap')
def _clip_cost(v: FixedVariable):
    (src,) = v._from
    # LUT5 pairs sharing a LUT6: half a LUT per output bit touched
    cost = sum(v.kif) / 2 * ((src._factor < 0) + (v.opr == 'relu'))
    return cost, src.latency


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
