"""Symbolic arrays of FixedVariable with the numpy protocol.

``FixedVariableArray`` wraps an object-dtype ndarray of FixedVariable and
implements ``__array_ufunc__`` / ``__array_function__`` so models can be
traced with plain numpy code. Variable × constant-matrix products route
through the CMVM solver that ``solver_options['backend']`` names: per
distinct row through ``solve`` (``'cpu'`` the Python host solver, ``'cpp'``
the native one, ``'auto'`` the native one when it builds), or all distinct
rows — of all jobs, for ``cmvm_multi`` — as one lane batch of the device
search (``'torch'``, on ``solver_options['device']``, the card when None).
Everything else lowers to elementwise variable ops, heap reductions and mux
networks.

Counterpart of ``da4ml_tpu/trace/fixed_variable_array.py``, without the
device→host degrade of a failed device batch: on the torch backend the
search launches its kernel or raises.
"""

from __future__ import annotations

from collections.abc import Callable
from inspect import signature

import numpy as np
from numpy.typing import NDArray

from ..cmvm import solve, solver_options_t
from ..ir.lut import LookupTable
from ..ir.types import QInterval
from .fixed_variable import FixedVariable, FixedVariableInput, HWConfig
from .ops import einsum, reduce, sort
from .ops.quantization import fixed_quantize


def to_raw_arr(obj):
    if isinstance(obj, tuple):
        return tuple(to_raw_arr(x) for x in obj)
    if isinstance(obj, list):
        return [to_raw_arr(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_raw_arr(v) for k, v in obj.items()}
    if isinstance(obj, FixedVariableArray):
        return obj._vars
    return obj


def _max_of(a, b):
    if isinstance(a, FixedVariable):
        return a.max_of(b)
    if isinstance(b, FixedVariable):
        return b.max_of(a)
    return max(a, b)


def _min_of(a, b):
    if isinstance(a, FixedVariable):
        return a.min_of(b)
    if isinstance(b, FixedVariable):
        return b.min_of(a)
    return min(a, b)


def _const_values(arr: np.ndarray) -> np.ndarray:
    """Numeric matrix of a fully-collapsed (all-constant) variable array."""
    return np.array([float(v.low) for v in arr.ravel()], dtype=np.float64).reshape(arr.shape)


def mmm(mat0: np.ndarray, mat1: np.ndarray):
    """Naive symbolic matrix multiply (explicit multipliers + adder trees)."""
    shape = mat0.shape[:-1] + mat1.shape[1:]
    mat0 = mat0.reshape((-1, mat0.shape[-1]))
    mat1 = mat1.reshape((mat1.shape[0], -1))
    out = np.empty((mat0.shape[0], mat1.shape[1]), dtype=object)
    for i in range(mat0.shape[0]):
        for j in range(mat1.shape[1]):
            out[i, j] = reduce(lambda x, y: x + y, mat0[i] * mat1[:, j])
    return out.reshape(shape)


def _merged_opts(v: 'FixedVariableArray', solver_options: solver_options_t) -> dict:
    """solver_options with hwconf-derived defaults, ready for ``solve(**opts)``
    (offload_fn is handled by the callers, never forwarded)."""
    hwconf = v._vars.ravel()[0].hwconf
    opts = dict(solver_options)
    opts.setdefault('adder_size', hwconf.adder_size)
    opts.setdefault('carry_size', hwconf.carry_size)
    opts.pop('offload_fn', None)
    return opts


def cmvm(cm: np.ndarray, v: 'FixedVariableArray', solver_options: solver_options_t) -> np.ndarray:
    """Solve vec @ cm as a shift-add network and merge it into the trace.

    The solver's Pipeline is replayed symbolically over the input variables so
    its ops join the graph. ``offload_fn`` may divert selected weights to
    explicit multipliers.
    """
    offload_fn = solver_options.get('offload_fn', None)
    mask = offload_fn(cm, v) if offload_fn is not None else None
    if mask is not None and np.any(mask):
        mask = np.asarray(mask, dtype=np.bool_)
        assert mask.shape == cm.shape, f'Offload mask shape {mask.shape} != CM shape {cm.shape}'
        offload_cm = cm * mask.astype(cm.dtype)
        cm = cm * (~mask).astype(cm.dtype)
        if np.all(cm == 0):
            return mmm(v._vars, offload_cm)
    else:
        offload_cm = None

    qintervals = [QInterval(float(_v.low), float(_v.high), float(_v.step)) for _v in v._vars]
    latencies = [float(_v.latency) for _v in v._vars]
    opts = _merged_opts(v, solver_options)
    sol = solve(np.ascontiguousarray(cm, dtype=np.float64), qintervals=qintervals, latencies=latencies, **opts)
    result: np.ndarray = sol(v._vars)
    if offload_cm is not None:
        result = result + mmm(v._vars, offload_cm)
    return result


def cmvm_rows(cm: np.ndarray, rows: 'FixedVariableArray', solver_options: solver_options_t) -> list[np.ndarray]:
    """Solve ``rows[i] @ cm`` for every row of a 2-d variable matrix.

    On the torch backend the distinct rows go to the device as one lane
    batch (the rows share the kernel but differ in qintervals/latencies —
    the batch axis the device search parallelizes over); other backends
    solve per row. ``offload_fn`` forces the per-row path (masks depend on
    the row).
    """
    n_rows = rows.shape[0]
    if solver_options.get('offload_fn') is not None:
        # masks depend on the row -> per-row path
        return [cmvm(cm, rows[i], solver_options) for i in range(n_rows)]

    # The solution depends on the row only through (qintervals, latencies) —
    # rows with identical metadata (e.g. every interior patch of a conv)
    # share one solve, replayed symbolically per row.
    qints_list, lats_list = [], []
    keys: list[tuple] = []
    for i in range(n_rows):
        qints, lats = _row_meta(rows, i)
        qints_list.append(qints)
        lats_list.append(lats)
        keys.append((tuple(qints), tuple(lats)))
    uniq: dict[tuple, int] = {}
    rep: list[int] = []  # unique-group index per row
    for k in keys:
        rep.append(uniq.setdefault(k, len(uniq)))
    uniq_idx = [0] * len(uniq)
    for i, g in enumerate(rep):
        uniq_idx[g] = i  # any representative row works

    if solver_options.get('backend') != 'torch' or len(uniq) <= 1:
        usols = [_solve_one(cm, qints_list[i], lats_list[i], rows, solver_options) for i in uniq_idx]
        return [usols[g](rows._vars[i]) for i, g in zip(range(n_rows), rep)]

    cm64 = np.ascontiguousarray(cm, dtype=np.float64)
    usols = _solve_torch_many(
        [cm64] * len(uniq), [qints_list[i] for i in uniq_idx], [lats_list[i] for i in uniq_idx], rows, solver_options
    )
    return [usols[g](rows._vars[i]) for i, g in zip(range(n_rows), rep)]


def _solve_one(cm, qintervals, latencies, rows: 'FixedVariableArray', solver_options: solver_options_t):
    opts = _merged_opts(rows, solver_options)
    return solve(np.ascontiguousarray(cm, dtype=np.float64), qintervals=qintervals, latencies=latencies, **opts)


def _solve_torch_many(kernels, qintervals_list, latencies_list, rows: 'FixedVariableArray', solver_options):
    """All (kernel, row metadata) instances as one lane batch of the device
    search (``solve_torch_many``)."""
    from ..cmvm.torch_search import solve_torch_many

    opts = _merged_opts(rows, solver_options)
    kw = {k: opts[k] for k in _TORCH_SOLVE_KW if k in opts}
    return solve_torch_many(kernels, qintervals_list=qintervals_list, latencies_list=latencies_list, **kw)


#: the ``solver_options`` keys ``solve_torch_many`` takes
_TORCH_SOLVE_KW = (
    'method0',
    'method1',
    'hard_dc',
    'decompose_dc',
    'adder_size',
    'carry_size',
    'search_all_decompose_dc',
    'method0_candidates',
    'n_restarts',
    'quality',
    'device',
)


def _row_meta(rows: 'FixedVariableArray', i: int) -> tuple[list[QInterval], list[float]]:
    """Solver-relevant metadata of row ``i``: per-element intervals + latencies."""
    v = rows._vars[i]
    qints = [QInterval(float(x.low), float(x.high), float(x.step)) for x in v]
    lats = [float(x.latency) for x in v]
    return qints, lats


def cmvm_multi(
    jobs: list[tuple[np.ndarray, 'FixedVariableArray']], solver_options: solver_options_t
) -> list[list[np.ndarray]]:
    """``cmvm_rows`` over several (kernel, rows) pairs at once.

    On the torch backend every unique (kernel, row-metadata) instance across
    all jobs goes to the device as one lane batch — e.g. all channels of a
    depthwise convolution solve together, one K2 launch a rung call for
    every channel, with identical channels sharing one search. Other
    backends (and ``offload_fn``) take per-job ``cmvm_rows``.
    """
    if solver_options.get('backend') != 'torch' or solver_options.get('offload_fn') is not None or len(jobs) <= 1:
        return [cmvm_rows(cm, rows, solver_options) for cm, rows in jobs]
    hwconfs = {rows.hwconf for _, rows in jobs}
    assert len(hwconfs) == 1, f'cmvm_multi jobs must share one HWConfig, got {hwconfs}'

    uniq: dict[tuple, int] = {}
    reps: list[list[int]] = []  # per job: unique-group index per row
    kernels: list[np.ndarray] = []
    qints_list: list[list[QInterval]] = []
    lats_list: list[list[float]] = []
    for cm, rows in jobs:
        cm64 = np.ascontiguousarray(cm, dtype=np.float64)
        cm_key = (cm64.shape, cm64.tobytes())
        rep_j = []
        for i in range(rows.shape[0]):
            qints, lats = _row_meta(rows, i)
            key = (cm_key, tuple(qints), tuple(lats))
            g = uniq.setdefault(key, len(uniq))
            if g == len(kernels):
                kernels.append(cm64)
                qints_list.append(qints)
                lats_list.append(lats)
            rep_j.append(g)
        reps.append(rep_j)

    usols = _solve_torch_many(kernels, qints_list, lats_list, jobs[0][1], solver_options)
    return [[usols[g](rows._vars[i]) for i, g in enumerate(rep_j)] for (cm, rows), rep_j in zip(jobs, reps)]


_unary_ufuncs = (
    np.sin, np.cos, np.tan, np.exp, np.log, np.invert, np.sqrt, np.tanh, np.sinh, np.cosh,
    np.arccos, np.arcsin, np.arctan, np.arcsinh, np.arccosh, np.arctanh, np.exp2, np.expm1,
    np.log2, np.log10, np.log1p, np.cbrt, np.reciprocal,
)  # fmt: skip

# ---------------------------------------------------------------------------
# numpy-protocol handler registries.  Handlers receive (arr, func, args,
# kwargs) so one handler can serve several numpy entry points.
# ---------------------------------------------------------------------------

_FUNC_HANDLERS: dict = {}
_UFUNC_HANDLERS: dict = {}


def _on_func(*funcs):
    def register(fn):
        for f in funcs:
            _FUNC_HANDLERS[f] = fn
        return fn

    return register


def _on_ufunc(*ufuncs):
    def register(fn):
        for f in ufuncs:
            _UFUNC_HANDLERS[f] = fn
        return fn

    return register


@_on_func(np.sum)
def _h_sum(arr, func, args, kwargs):
    return reduce(lambda a, b: a + b, *args, **kwargs)


@_on_func(np.mean)
def _h_mean(arr, func, args, kwargs):
    total = reduce(lambda a, b: a + b, *args, **kwargs)
    n = total.size if isinstance(total, FixedVariableArray) else 1
    return total * (n / arr._vars.size)


@_on_func(np.max, np.amax)
def _h_max(arr, func, args, kwargs):
    return reduce(_max_of, *args, **kwargs)


@_on_func(np.min, np.amin)
def _h_min(arr, func, args, kwargs):
    return reduce(_min_of, *args, **kwargs)


@_on_func(np.prod)
def _h_prod(arr, func, args, kwargs):
    return reduce(lambda a, b: a * b, *args, **kwargs)


@_on_func(np.all, np.any)
def _h_bool_reduce(arr, func, args, kwargs):
    assert len(args) >= 1 and args[0] is arr
    booled = arr.to_bool('any')
    combine = (lambda a, b: a & b) if func is np.all else (lambda a, b: a | b)
    return reduce(combine, booled, *args[1:], **kwargs)


@_on_func(np.clip)
def _h_clip(arr, func, args, kwargs):
    assert len(args) == 3, 'np.clip requires exactly three arguments'
    x, lo, hi = np.broadcast_arrays(*args)
    x = FixedVariableArray(x, arr.solver_options, hwconf=arr.hwconf)
    x = np.amax(np.stack((x, lo), axis=-1), axis=-1)
    return np.amin(np.stack((x, hi), axis=-1), axis=-1)


@_on_func(np.einsum)
def _h_einsum(arr, func, args, kwargs):
    bind = signature(np.einsum).bind(*args, **kwargs)
    operands = bind.arguments['operands']
    if isinstance(operands[0], str):
        operands = operands[1:]
    assert len(operands) == 2, 'einsum on FixedVariableArray requires exactly two operands'
    assert bind.arguments.get('out', None) is None, 'out= is not supported'
    return einsum(args[0], *operands)


@_on_func(np.dot)
def _h_dot(arr, func, args, kwargs):
    assert len(args) == 2
    a, b = (x if isinstance(x, FixedVariableArray) else np.array(x) for x in args)
    if a.shape and b.shape and a.shape[-1] == b.shape[0]:
        return a @ b
    assert a.size == 1 or b.size == 1, f'Error in dot product: {a.shape} @ {b.shape}'
    return a * b


@_on_func(np.where)
def _h_where(arr, func, args, kwargs):
    assert len(args) == 3
    cond, x, y = args
    if not isinstance(cond, FixedVariableArray):
        return FixedVariableArray(np.where(cond, to_raw_arr(x), to_raw_arr(y)), arr.solver_options, hwconf=arr.hwconf)
    cond, x, y = np.broadcast_arrays(cond.to_bool('any'), x, y)
    picked = [c.msb_mux(xv, yv) for c, xv, yv in zip(cond.ravel(), x.ravel(), y.ravel())]
    return FixedVariableArray(np.array(picked).reshape(cond.shape), arr.solver_options, hwconf=arr.hwconf)


@_on_func(np.sort)
def _h_sort(arr, func, args, kwargs):
    return sort(*args, **kwargs)


@_on_func(np.argsort)
def _h_argsort(arr, func, args, kwargs):
    a = args[0] if args else kwargs.get('a')
    assert a.ndim == 1, 'argsort on FixedVariableArray only supports 1D arrays'
    return _ArgsortDelayedIndex(args, kwargs)


@_on_ufunc(np.add, np.subtract, np.multiply, np.true_divide, np.negative)
def _u_arith(arr, ufunc, inputs, kwargs):
    # the scalar operators handle these; run the ufunc over the raw object arrays
    return FixedVariableArray(ufunc(*(to_raw_arr(x) for x in inputs), **kwargs), arr.solver_options, hwconf=arr.hwconf)


@_on_ufunc(np.maximum, np.minimum)
def _u_extremum(arr, ufunc, inputs, kwargs):
    pick = _max_of if ufunc is np.maximum else _min_of
    a, b = np.broadcast_arrays(to_raw_arr(inputs[0]), to_raw_arr(inputs[1]))
    out = np.empty(a.size, dtype=object)
    for i, (av, bv) in enumerate(zip(a.ravel(), b.ravel())):
        out[i] = pick(av, bv)
    return FixedVariableArray(out.reshape(a.shape), arr.solver_options, hwconf=arr.hwconf)


@_on_ufunc(np.matmul)
def _u_matmul(arr, ufunc, inputs, kwargs):
    assert len(inputs) == 2
    if isinstance(inputs[0], FixedVariableArray):
        return inputs[0].matmul(inputs[1])
    return inputs[1].rmatmul(inputs[0])


@_on_ufunc(np.power)
def _u_power(arr, ufunc, inputs, kwargs):
    base, exp = inputs
    return base**exp


@_on_ufunc(np.abs, np.absolute)
def _u_abs(arr, ufunc, inputs, kwargs):
    assert inputs[0] is arr
    return abs(arr)


@_on_ufunc(np.square)
def _u_square(arr, ufunc, inputs, kwargs):
    assert inputs[0] is arr
    return arr**2


@_on_ufunc(*_unary_ufuncs)
def _u_transcendental(arr, ufunc, inputs, kwargs):
    assert len(inputs) == 1 and inputs[0] is arr
    return arr.apply(ufunc)


class FixedVariableArray:
    """Symbolic array of FixedVariable supporting numpy ufuncs and functions."""

    __array_priority__ = 100

    def __init__(
        self,
        vars: NDArray,
        solver_options: solver_options_t | None = None,
        hwconf: HWConfig | tuple | None = None,
    ):
        _vars = np.array(vars)
        flat = _vars.ravel()
        if hwconf is None:
            hwconf = next(iter(v for v in flat if isinstance(v, FixedVariable))).hwconf
        hwconf = HWConfig(*hwconf)
        self.hwconf = hwconf
        for i, v in enumerate(flat):
            if not isinstance(v, FixedVariable):
                flat[i] = FixedVariable(float(v), float(v), 1.0, hwconf=hwconf)
        self._vars = _vars
        opts = dict(solver_options) if solver_options is not None else {}
        opts.pop('qintervals', None)
        opts.pop('latencies', None)
        self.solver_options: solver_options_t = opts  # type: ignore[assignment]

    # ------------------------------------------------------------ factories

    @classmethod
    def from_lhs(cls, low, high, step, hwconf=HWConfig(1, -1, -1), latency=0.0, solver_options=None):
        low, high, step = np.array(low), np.array(high), np.array(step)
        shape = low.shape
        assert shape == high.shape == step.shape
        lat = np.full(low.size, latency, dtype=np.float64) if np.isscalar(latency) else np.asarray(latency).ravel()
        vars_ = [
            FixedVariable(float(lo), float(hi), float(st), hwconf=hwconf, latency=float(lt))
            for lo, hi, st, lt in zip(low.ravel(), high.ravel(), step.ravel(), lat)
        ]
        return cls(np.array(vars_).reshape(shape), solver_options)

    @classmethod
    def from_kif(cls, k, i, f, hwconf=HWConfig(1, -1, -1), latency=0.0, solver_options=None):
        k, i, f = np.broadcast_arrays(k, i, f)
        mask = np.asarray(k) + np.asarray(i) + np.asarray(f) <= 0
        k = np.where(mask, 0, k)
        i = np.where(mask, 0, i)
        f = np.where(mask, 0, f)
        step = 2.0 ** -f.astype(np.float64)
        hi = 2.0 ** i.astype(np.float64)
        return cls.from_lhs(-hi * k, hi - step, step, hwconf, latency, solver_options)

    # --------------------------------------------------------- numpy hooks

    def __array_function__(self, func, types, args, kwargs):
        handler = _FUNC_HANDLERS.get(func)
        if handler is not None:
            return handler(self, func, args, kwargs)
        # default: run the numpy function over the raw object arrays
        args, kwargs = to_raw_arr(args), to_raw_arr(kwargs)
        return FixedVariableArray(func(*args, **kwargs), self.solver_options, hwconf=self.hwconf)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        assert method == '__call__', f'Only __call__ is supported for ufuncs, got {method}'
        handler = _UFUNC_HANDLERS.get(ufunc)
        if handler is None:
            raise NotImplementedError(f'Unsupported ufunc: {ufunc}')
        return handler(self, ufunc, inputs, kwargs)

    # -------------------------------------------------------------- matmul

    def matmul(self, other) -> 'FixedVariableArray':
        if self.collapsed:
            # fully-constant LHS: fold numerically (or route through rmatmul
            # when the RHS still carries variables)
            lhs = _const_values(self._vars)
            if isinstance(other, FixedVariableArray):
                if not other.collapsed:
                    return lhs @ other
                other = _const_values(other._vars)
            prod = lhs @ np.array(other, dtype=np.float64)
            return FixedVariableArray.from_lhs(
                prod, prod, np.ones_like(prod), hwconf=self.hwconf, solver_options=self.solver_options
            )

        rhs = other._vars if isinstance(other, FixedVariableArray) else np.array(other)
        if any(isinstance(x, FixedVariable) for x in rhs.ravel()):
            # variable × variable: explicit multipliers + adder trees
            return FixedVariableArray(mmm(self._vars, rhs), self.solver_options, hwconf=self.hwconf)

        # variable × constant — the CMVM entry point
        assert self.shape[-1] == rhs.shape[0], f'Matrix shapes do not match: {self.shape} @ {rhs.shape}'
        contract = rhs.shape[0]
        out_shape = self.shape[:-1] + rhs.shape[1:]
        rows = cmvm_rows(rhs.reshape(contract, -1), self.reshape((-1, contract)), dict(self.solver_options or {}))
        return FixedVariableArray(np.array(rows).reshape(out_shape), self.solver_options, hwconf=self.hwconf)

    def __matmul__(self, other):
        return self.matmul(other)

    def rmatmul(self, other):
        # const @ var: transpose both operands into the var-@-const form,
        # then rotate the batch axes back into place
        lhs = np.moveaxis(self, 0, -1)
        rhs = np.moveaxis(other, -1, 0)
        prod = lhs @ rhs
        split = lhs.ndim - 1
        order = tuple(range(split, prod.ndim)) + tuple(range(split))
        return prod.transpose(order)

    def __rmatmul__(self, other):
        return self.rmatmul(other)

    # ------------------------------------------------------------ elementwise

    def _zip_with(self, other, op: Callable):
        a = self._vars
        b = other._vars if isinstance(other, FixedVariableArray) else other
        a, b = np.broadcast_arrays(a, b)
        r = np.array([op(av, bv) for av, bv in zip(a.ravel(), b.ravel())])
        return FixedVariableArray(r.reshape(a.shape), self.solver_options, hwconf=self.hwconf)

    def __add__(self, other):
        return FixedVariableArray(self._vars + to_raw_arr(other), self.solver_options, hwconf=self.hwconf)

    def __radd__(self, other):
        return self + other

    def __sub__(self, other):
        return FixedVariableArray(self._vars - to_raw_arr(other), self.solver_options, hwconf=self.hwconf)

    def __rsub__(self, other):
        return FixedVariableArray(to_raw_arr(other) - self._vars, self.solver_options, hwconf=self.hwconf)

    def __mul__(self, other):
        return FixedVariableArray(self._vars * to_raw_arr(other), self.solver_options, hwconf=self.hwconf)

    def __rmul__(self, other):
        return self * other

    def __truediv__(self, other):
        return FixedVariableArray(self._vars * (1 / other), self.solver_options, hwconf=self.hwconf)

    def __neg__(self):
        return FixedVariableArray(-self._vars, self.solver_options, hwconf=self.hwconf)

    def __pow__(self, power):
        p = int(power)
        if p == power and p >= 0:
            return FixedVariableArray(self._vars**p, self.solver_options, hwconf=self.hwconf)
        return self.apply(lambda x: x**power)

    def __gt__(self, other):
        return self._zip_with(other, lambda a, b: a > b)

    def __lt__(self, other):
        return self._zip_with(other, lambda a, b: a < b)

    def __ge__(self, other):
        return self._zip_with(other, lambda a, b: a >= b)

    def __le__(self, other):
        return self._zip_with(other, lambda a, b: a <= b)

    def __and__(self, other):
        return self._zip_with(other, lambda a, b: a & b)

    def __or__(self, other):
        return self._zip_with(other, lambda a, b: a | b)

    def __xor__(self, other):
        return self._zip_with(other, lambda a, b: a ^ b)

    def __invert__(self):
        r = np.array([~v for v in self._vars.ravel()])
        return FixedVariableArray(r.reshape(self.shape), self.solver_options, hwconf=self.hwconf)

    def __abs__(self):
        r = np.array([abs(v) for v in self._vars.ravel()])
        return FixedVariableArray(r.reshape(self.shape), self.solver_options, hwconf=self.hwconf)

    def __ne__(self, other):  # type: ignore[override]
        if not isinstance(other, (FixedVariableArray, np.ndarray, int, float, np.integer, np.floating)):
            raise ValueError(f'Illegal comparison between FixedVariableArray and {type(other)}')
        return self._zip_with(other, lambda a, b: a._ne(b))

    def __eq__(self, other):  # type: ignore[override]
        return ~(self.__ne__(other))

    def to_bool(self, reduction: str = 'any'):
        assert reduction in ('any', 'all'), f'reduction must be any/all, got {reduction}'
        r = np.array([v.unary_bit_op(reduction) for v in self._vars.ravel()]).reshape(self._vars.shape)
        return FixedVariableArray(r, self.solver_options, hwconf=self.hwconf)

    # --------------------------------------------------------- quant / relu

    def relu(self, i=None, f=None, round_mode: str = 'TRN'):
        shape = self._vars.shape
        i = np.broadcast_to(i, shape) if i is not None else np.full(shape, None)
        f = np.broadcast_to(f, shape) if f is not None else np.full(shape, None)
        out = [v.relu(i=iv, f=fv, round_mode=round_mode) for v, iv, fv in zip(self._vars.ravel(), i.ravel(), f.ravel())]
        return FixedVariableArray(np.array(out).reshape(shape), self.solver_options, hwconf=self.hwconf)

    def quantize(self, k=None, i=None, f=None, overflow_mode: str = 'WRAP', round_mode: str = 'TRN'):
        shape = self._vars.shape
        if any(x is None for x in (k, i, f)):
            kif = self.kif
        k = np.broadcast_to(k, shape) if k is not None else kif[0]
        i = np.broadcast_to(i, shape) if i is not None else kif[1]
        f = np.broadcast_to(f, shape) if f is not None else kif[2]
        out = [
            v.quantize(k=kv, i=iv, f=fv, overflow_mode=overflow_mode, round_mode=round_mode)
            for v, kv, iv, fv in zip(self._vars.ravel(), k.ravel(), i.ravel(), f.ravel())
        ]
        return FixedVariableArray(np.array(out).reshape(shape), self.solver_options, hwconf=self.hwconf)

    # --------------------------------------------------------------- shape

    def __getitem__(self, item):
        if isinstance(item, _ArgsortDelayedIndex):
            ret = sort(*item.args, **item.kwargs, aux_value=self)[1]
            for s in item._slicing:
                ret = ret[s]
            return ret
        vars_ = self._vars[item]
        if isinstance(vars_, np.ndarray):
            return FixedVariableArray(vars_, self.solver_options, hwconf=self.hwconf)
        return vars_

    def __len__(self):
        return len(self._vars)

    def flatten(self):
        return FixedVariableArray(self._vars.flatten(), self.solver_options, hwconf=self.hwconf)

    def reshape(self, *shape):
        return FixedVariableArray(self._vars.reshape(*shape), self.solver_options, hwconf=self.hwconf)

    def transpose(self, axes=None):
        return FixedVariableArray(self._vars.transpose(axes), self.solver_options, hwconf=self.hwconf)

    def ravel(self):
        return FixedVariableArray(self._vars.ravel(), self.solver_options, hwconf=self.hwconf)

    def copy(self):
        return FixedVariableArray(self._vars.copy(), self.solver_options, hwconf=self.hwconf)

    @property
    def T(self):
        return self.transpose()

    @property
    def shape(self):
        return self._vars.shape

    @property
    def dtype(self):
        return self._vars.dtype

    @property
    def size(self):
        return self._vars.size

    @property
    def ndim(self):
        return self._vars.ndim

    # ------------------------------------------------------------- queries

    @property
    def kif(self):
        """Stacked [k, i, f] arrays (leading axis 3)."""
        shape = self._vars.shape
        kif = np.array([v.kif for v in self._vars.ravel()]).reshape(*shape, 3)
        return np.moveaxis(kif, -1, 0)

    @property
    def lhs(self):
        """Stacked [low, high, step] arrays (leading axis 3)."""
        shape = self._vars.shape
        lhs = np.array([(v.low, v.high, v.step) for v in self._vars.ravel()], dtype=np.float32).reshape(*shape, 3)
        return np.moveaxis(lhs, -1, 0)

    @property
    def latency(self):
        return np.array([v.latency for v in self._vars.ravel()]).reshape(self._vars.shape)

    @property
    def collapsed(self) -> bool:
        """True when every element is a constant (low == high)."""
        return all(v.low == v.high for v in self._vars.ravel())

    def apply(self, fn: Callable) -> 'LazyUnaryArray':
        """Apply a unary float function, deferred until quantization fixes
        the output precision (lowered to lookup tables)."""
        return LazyUnaryArray(self._vars, self.solver_options, operator=fn)

    def as_new(self):
        """Same intervals/config, fresh unconnected variables (new trace roots)."""
        shape = self._vars.shape
        vars_ = np.array([v._with(_from=(), opr='new', renew_id=True) for v in self._vars.ravel()]).reshape(shape)
        return FixedVariableArray(vars_, self.solver_options, hwconf=self.hwconf)

    def __repr__(self):
        max_lat = max(v.latency for v in self._vars.ravel())
        return f'FixedVariableArray(shape={self._vars.shape}, hwconf={tuple(self.hwconf)}, latency={max_lat})'


class FixedVariableArrayInput(FixedVariableArray):
    """Input array whose element precisions are recorded as the widest ever
    requested via quantize."""

    def __init__(self, shape, hwconf=HWConfig(1, -1, -1), solver_options=None, latency=0.0):
        _vars = np.empty(shape, dtype=object)
        flat = _vars.ravel()
        for i in range(_vars.size):
            flat[i] = FixedVariableInput(latency, hwconf)
        super().__init__(_vars, solver_options, hwconf=hwconf)


def make_table(fn: Callable, qint: QInterval) -> LookupTable:
    low, high, step = qint
    n = round(abs(high - low) / step) + 1
    return LookupTable(np.asarray(fn(np.linspace(low, high, n)), dtype=np.float64))


class LazyUnaryArray(FixedVariableArray):
    """Array with a pending unary function of unspecified output precision.

    Composes further unary ops lazily; materializes into lookup-table
    variables upon ``quantize``.
    """

    def __init__(self, vars: NDArray, solver_options, operator: Callable):
        self._operator = operator
        super().__init__(vars, solver_options)

    def __array_function__(self, func, types, args, kwargs):
        raise RuntimeError('LazyUnaryArray only supports quantization or further unary operations.')

    def apply(self, fn: Callable) -> 'LazyUnaryArray':
        op = self._operator
        return LazyUnaryArray(self._vars, self.solver_options, operator=lambda x: fn(op(x)))

    def quantize(self, k=None, i=None, f=None, overflow_mode: str = 'WRAP', round_mode: str = 'TRN'):
        if any(x is None for x in (k, i, f)):
            assert all(x is None for x in (k, i, f)), 'Either all or none of k, i, f must be specified'
            _k = _i = _f = [None] * self.size
        else:
            _k = np.broadcast_to(k, self.shape).ravel()
            _i = np.broadcast_to(i, self.shape).ravel()
            _f = np.broadcast_to(f, self.shape).ravel()

        local_tables: dict = {}
        variables = []
        for v, kk, ii, ff in zip(self._vars.ravel(), _k, _i, _f):
            qint = v.qint if v._factor >= 0 else QInterval(v.qint.max, v.qint.min, v.qint.step)
            if kk is None or ii is None or ff is None:
                op = self._operator
                key = qint
            else:
                base = self._operator

                def op(x, _b=base, _k=kk, _i=ii, _f=ff):
                    return fixed_quantize(_b(x), _k, _i, _f, overflow_mode, round_mode)

                key = (qint, (int(kk), int(ii), int(ff)))
            if key in local_tables:
                table = local_tables[key]
            else:
                table = make_table(op, qint)
                local_tables[key] = table
            variables.append(v.lookup(table))

        variables = np.array(variables).reshape(self._vars.shape)
        return FixedVariableArray(variables, self.solver_options, hwconf=self.hwconf)

    @property
    def kif(self):
        raise RuntimeError('LazyUnaryArray has no defined kif until quantized.')

    def __repr__(self):
        return 'Lazy' + super().__repr__()


# Alias for users coming from the reference API
RetardedFixedVariableArray = LazyUnaryArray


class _ArgsortDelayedIndex:
    """Placeholder returned by np.argsort; indexing another array with it
    lowers to a payload-carrying sort."""

    def __init__(self, args, kwargs, slicing: tuple = ()):
        self.args = args
        self.kwargs = kwargs
        self._slicing = slicing

    def __getitem__(self, idx):
        return _ArgsortDelayedIndex(self.args, self.kwargs, self._slicing + (idx,))
