"""Symbolic arrays of FixedVariable.

``FixedVariableArray`` wraps an object-dtype ndarray of FixedVariable.
Variable × constant-matrix products route through the CMVM solver that
``solver_options['backend']`` names: per distinct row through ``solve``
(``'cpu'`` the Python host solver, ``'cpp'`` the native one, ``'auto'`` the
native one when it builds), or all distinct rows as one lane batch of the
device search (``'torch'``, on ``solver_options['device']``); the
elementwise operators lower to the scalar variable ops.

Counterpart of ``da4ml_tpu/trace/fixed_variable_array.py``, cut to what the
port traces so far: input quantization, ``@`` by a constant matrix
(``cmvm_rows`` → ``cmvm``), relu, quantize and elementwise arithmetic. The
numpy-protocol handlers (einsum, sort, where, reductions, lookup-table
lowering) are not ported yet.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray

from ..cmvm import solve, solver_options_t
from ..ir.types import QInterval
from .fixed_variable import FixedVariable, FixedVariableInput, HWConfig


def to_raw_arr(obj):
    if isinstance(obj, FixedVariableArray):
        return obj._vars
    return obj


def _merged_opts(v: 'FixedVariableArray', solver_options: solver_options_t) -> dict:
    """solver_options with hwconf-derived defaults, ready for ``solve(**opts)``."""
    hwconf = v._vars.ravel()[0].hwconf
    opts = dict(solver_options)
    opts.setdefault('adder_size', hwconf.adder_size)
    opts.setdefault('carry_size', hwconf.carry_size)
    return opts


def _row_meta(rows: 'FixedVariableArray', i: int) -> tuple[list[QInterval], list[float]]:
    """Solver-relevant metadata of row ``i``: per-element intervals + latencies."""
    v = rows._vars[i]
    qints = [QInterval(float(x.low), float(x.high), float(x.step)) for x in v]
    lats = [float(x.latency) for x in v]
    return qints, lats


def cmvm(cm: np.ndarray, qintervals, latencies, rows: 'FixedVariableArray', solver_options: solver_options_t):
    """Solve ``vec @ cm`` as a shift-add network for one (qintervals,
    latencies) signature; the returned Pipeline replays symbolically over
    any row with that signature, so its ops join the trace graph."""
    opts = _merged_opts(rows, solver_options)
    return solve(np.ascontiguousarray(cm, dtype=np.float64), qintervals=qintervals, latencies=latencies, **opts)


def cmvm_rows(cm: np.ndarray, rows: 'FixedVariableArray', solver_options: solver_options_t) -> list[np.ndarray]:
    """Solve ``rows[i] @ cm`` for every row of a 2-d variable matrix.

    The solution depends on the row only through (qintervals, latencies) —
    rows with identical metadata share one solve, replayed symbolically per
    row. On the torch backend the distinct rows go to the device as one lane
    batch, as the reference's jax backend does.
    """
    n_rows = rows.shape[0]
    qints_list, lats_list, keys = [], [], []
    for i in range(n_rows):
        qints, lats = _row_meta(rows, i)
        qints_list.append(qints)
        lats_list.append(lats)
        keys.append((tuple(qints), tuple(lats)))
    uniq: dict[tuple, int] = {}
    rep = [uniq.setdefault(k, len(uniq)) for k in keys]  # unique-group index per row
    uniq_idx = [0] * len(uniq)
    for i, g in enumerate(rep):
        uniq_idx[g] = i  # any representative row works

    if solver_options.get('backend') != 'torch':
        usols = [cmvm(cm, qints_list[i], lats_list[i], rows, solver_options) for i in uniq_idx]
    else:  # the device search takes all distinct rows as one lane batch
        from ..cmvm.torch_search import solve_torch_many

        opts = _merged_opts(rows, solver_options)
        usols = solve_torch_many(
            [np.ascontiguousarray(cm, dtype=np.float64)] * len(uniq),
            qintervals_list=[qints_list[i] for i in uniq_idx],
            latencies_list=[lats_list[i] for i in uniq_idx],
            **{k: opts[k] for k in _TORCH_SOLVE_KW if k in opts},
        )
    return [usols[g](rows._vars[i]) for i, g in zip(range(n_rows), rep)]


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


class FixedVariableArray:
    """Symbolic array of FixedVariable."""

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

    def _new(self, vars_) -> 'FixedVariableArray':
        return FixedVariableArray(vars_, self.solver_options, hwconf=self.hwconf)

    # -------------------------------------------------------------- matmul

    def matmul(self, other) -> 'FixedVariableArray':
        rhs = other._vars if isinstance(other, FixedVariableArray) else np.array(other)
        if rhs.dtype == object:
            raise NotImplementedError('variable x variable matmul is not ported to da4ml_tpu_torch yet')
        # variable × constant — the CMVM entry point
        assert self.shape[-1] == rhs.shape[0], f'Matrix shapes do not match: {self.shape} @ {rhs.shape}'
        contract = rhs.shape[0]
        out_shape = self.shape[:-1] + rhs.shape[1:]
        rows = cmvm_rows(rhs.reshape(contract, -1), self.reshape((-1, contract)), dict(self.solver_options or {}))
        return self._new(np.array(rows).reshape(out_shape))

    def __matmul__(self, other):
        return self.matmul(other)

    # ------------------------------------------------------------ elementwise

    def __add__(self, other):
        return self._new(self._vars + to_raw_arr(other))

    def __radd__(self, other):
        return self + other

    def __sub__(self, other):
        return self._new(self._vars - to_raw_arr(other))

    def __rsub__(self, other):
        return self._new(to_raw_arr(other) - self._vars)

    def __mul__(self, other):
        return self._new(self._vars * to_raw_arr(other))

    def __rmul__(self, other):
        return self * other

    def __neg__(self):
        return self._new(-self._vars)

    # --------------------------------------------------------- quant / relu

    def relu(self, i=None, f=None, round_mode: str = 'TRN'):
        shape = self._vars.shape
        i = np.broadcast_to(i, shape) if i is not None else np.full(shape, None)
        f = np.broadcast_to(f, shape) if f is not None else np.full(shape, None)
        out = [v.relu(i=iv, f=fv, round_mode=round_mode) for v, iv, fv in zip(self._vars.ravel(), i.ravel(), f.ravel())]
        return self._new(np.array(out).reshape(shape))

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
        return self._new(np.array(out).reshape(shape))

    # --------------------------------------------------------------- shape

    def __getitem__(self, item):
        vars_ = self._vars[item]
        if isinstance(vars_, np.ndarray):
            return self._new(vars_)
        return vars_

    def __len__(self):
        return len(self._vars)

    def reshape(self, *shape):
        return self._new(self._vars.reshape(*shape))

    def ravel(self):
        return self._new(self._vars.ravel())

    @property
    def shape(self):
        return self._vars.shape

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
    def latency(self):
        return np.array([v.latency for v in self._vars.ravel()]).reshape(self._vars.shape)

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
